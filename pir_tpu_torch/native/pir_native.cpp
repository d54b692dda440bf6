// A copy of pir_tpu/native/pir_native.cpp, unchanged below this header, which the
// port builds from its own tree (pir_tpu_torch/_build.py, g++ into
// pir_tpu_torch/_build/) and loads through pir_tpu_torch/native/__init__.py.
//
// Native CPU engine for the 2-server PIR hot path.
//
// Re-implements, in C++ with AES-NI, the performance-critical pieces the
// reference reaches through Go crypto/aes assembly (dpf/common.go:60-75)
// and its goroutine scan loops (db.go:74-174): full-domain breadth-first
// DPF expansion (O(H) AES calls, vs the reference's O(H log H) per-row
// tree walk) and the masked-XOR database scan. Semantics are bit-for-bit
// identical to pir_tpu.dpf.host (tested against it); this is the CPU
// serving engine and the client-side keygen accelerator.
//
// Build: g++ -O3 -maes -mavx2 -shared -fPIC pir_native.cpp -o libpirnative.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <wmmintrin.h>
#include <emmintrin.h>

extern "C" {

// ---------------------------------------------------------------------------
// AES-128 key schedule (AES-NI)
// ---------------------------------------------------------------------------

static inline __m128i ks_round(__m128i key, __m128i gen) {
  gen = _mm_shuffle_epi32(gen, _MM_SHUFFLE(3, 3, 3, 3));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, gen);
}

struct AesKey {
  __m128i rk[11];
};

static void aes128_expand(const uint8_t* key, AesKey* out) {
  __m128i k = _mm_loadu_si128((const __m128i*)key);
  out->rk[0] = k;
#define EXPAND(i, rcon) \
  k = ks_round(k, _mm_aeskeygenassist_si128(k, rcon)); \
  out->rk[i] = k;
  EXPAND(1, 0x01) EXPAND(2, 0x02) EXPAND(3, 0x04) EXPAND(4, 0x08)
  EXPAND(5, 0x10) EXPAND(6, 0x20) EXPAND(7, 0x40) EXPAND(8, 0x80)
  EXPAND(9, 0x1b) EXPAND(10, 0x36)
#undef EXPAND
}

static inline __m128i aes128_enc(const AesKey& k, __m128i x) {
  x = _mm_xor_si128(x, k.rk[0]);
  for (int r = 1; r < 10; r++) x = _mm_aesenc_si128(x, k.rk[r]);
  return _mm_aesenclast_si128(x, k.rk[10]);
}

// ---------------------------------------------------------------------------
// Go encoding/binary Varint parity of the leaf seed (utils/bits.py)
// ---------------------------------------------------------------------------

static inline uint8_t varint_parity(const uint8_t* seed8) {
  uint8_t allcont = 0x80;
  for (int i = 0; i < 8; i++) allcont &= seed8[i];
  if (allcont) return 0;  // no terminator within 8 bytes => value 0
  uint8_t b0 = seed8[0];
  return ((b0 >> 1) ^ b0) & 1;  // parity of zigzag decode
}

// ---------------------------------------------------------------------------
// Full-domain 2-party DPF expansion -> selection bits
// ---------------------------------------------------------------------------
//
// prf_keys: 4*16 bytes (only the first 3 are used by the 2P eval),
// cw: num_bits * 18 bytes (16B seed CW + tL + tR), natural-order output.
// out_bits[r] = 1 iff (leaf value % 2 == 0)  (db.go:142 inverted parity).

void pir_expand_bits(const uint8_t* prf_keys, uint32_t num_bits,
                     const uint8_t* s_init, uint8_t t_init, const uint8_t* cw,
                     int64_t final_cw, uint64_t height, uint8_t* out_bits) {
  AesKey k0, k1, k2;
  aes128_expand(prf_keys + 0, &k0);
  aes128_expand(prf_keys + 16, &k1);
  aes128_expand(prf_keys + 32, &k2);

  // live node counts per level (prefix pruning over [0, height))
  std::vector<uint8_t> seeds(16), next_seeds;
  std::vector<uint8_t> tbits(1, t_init), next_t;
  memcpy(seeds.data(), s_init, 16);
  uint64_t live = 1;

  for (uint32_t lvl = 0; lvl < num_bits; lvl++) {
    uint64_t shift = num_bits - lvl - 1;
    uint64_t next_live = (height + ((1ull << shift) - 1)) >> shift;
    if (next_live > 2 * live) next_live = 2 * live;
    next_seeds.assign(2 * live * 16, 0);
    next_t.assign(2 * live, 0);
    const uint8_t* cw_l = cw + (size_t)lvl * 18;
    __m128i cw_seed = _mm_loadu_si128((const __m128i*)cw_l);
    uint8_t cw_tl = cw_l[16], cw_tr = cw_l[17];

    for (uint64_t j = 0; j < live; j++) {
      __m128i s = _mm_loadu_si128((const __m128i*)(seeds.data() + 16 * j));
      __m128i e0 = _mm_xor_si128(aes128_enc(k0, s), s);
      __m128i e1 = _mm_xor_si128(aes128_enc(k1, s), s);
      __m128i e2 = _mm_xor_si128(aes128_enc(k2, s), s);
      uint8_t b1[16], b2[16];
      _mm_storeu_si128((__m128i*)b1, e1);
      _mm_storeu_si128((__m128i*)b2, e2);

      uint8_t t = tbits[j];
      __m128i corr = t ? cw_seed : _mm_setzero_si128();
      // sL = block0 ^ t*CW ; sR = (block1[1..15] ++ block2[0]) ^ t*CW
      __m128i sl = _mm_xor_si128(e0, corr);
      uint8_t srb[16];
      memcpy(srb, b1 + 1, 15);
      srb[15] = b2[0];
      __m128i sr =
          _mm_xor_si128(_mm_loadu_si128((const __m128i*)srb), corr);
      uint8_t tl = (b1[0] & 1) ^ (t & cw_tl);
      uint8_t tr = (b2[1] & 1) ^ (t & cw_tr);

      // natural order: children at 2j, 2j+1
      _mm_storeu_si128((__m128i*)(next_seeds.data() + 16 * (2 * j)), sl);
      _mm_storeu_si128((__m128i*)(next_seeds.data() + 16 * (2 * j + 1)), sr);
      next_t[2 * j] = tl;
      next_t[2 * j + 1] = tr;
    }
    seeds.swap(next_seeds);
    tbits.swap(next_t);
    live = next_live;
    seeds.resize(live * 16);
    tbits.resize(live);
  }

  uint8_t fcw_par = (uint8_t)(final_cw & 1);
  for (uint64_t r = 0; r < height; r++) {
    uint8_t par = varint_parity(seeds.data() + 16 * r) ^ (tbits[r] & fcw_par);
    out_bits[r] = par ^ 1;  // bit set when value is even
  }
}

// ---------------------------------------------------------------------------
// Fast-mode (early-termination) expansion: each leaf seed is expanded with
// the 4th PRF key into a 128-bit block of selection bits (dpf/host.py).
// ---------------------------------------------------------------------------

void pir_expand_fast_bits(const uint8_t* prf_keys, uint32_t depth,
                          const uint8_t* s_init, uint8_t t_init,
                          const uint8_t* cw, const uint8_t* final_cw_block,
                          uint64_t height, uint32_t leaf_blocks,
                          uint8_t* out_bits) {
  AesKey k0, k1, k2, k3;
  aes128_expand(prf_keys + 0, &k0);
  aes128_expand(prf_keys + 16, &k1);
  aes128_expand(prf_keys + 32, &k2);
  aes128_expand(prf_keys + 48, &k3);

  // wide leaves: each leaf covers 128*leaf_blocks rows via the CTR
  // extension of the leaf PRG (dpf/host.py _leaf_blocks_wide)
  uint64_t leaf_rows = 128ull * leaf_blocks;
  uint64_t n_leaves = (height + leaf_rows - 1) / leaf_rows;
  std::vector<uint8_t> seeds(16), next_seeds;
  std::vector<uint8_t> tbits(1, t_init), next_t;
  memcpy(seeds.data(), s_init, 16);
  uint64_t live = 1;

  for (uint32_t lvl = 0; lvl < depth; lvl++) {
    uint64_t shift = depth - lvl - 1;
    uint64_t next_live = (n_leaves + ((1ull << shift) - 1)) >> shift;
    if (next_live > 2 * live) next_live = 2 * live;
    next_seeds.assign(2 * live * 16, 0);
    next_t.assign(2 * live, 0);
    const uint8_t* cw_l = cw + (size_t)lvl * 18;
    __m128i cw_seed = _mm_loadu_si128((const __m128i*)cw_l);
    uint8_t cw_tl = cw_l[16], cw_tr = cw_l[17];

    for (uint64_t j = 0; j < live; j++) {
      __m128i s = _mm_loadu_si128((const __m128i*)(seeds.data() + 16 * j));
      __m128i e0 = _mm_xor_si128(aes128_enc(k0, s), s);
      __m128i e1 = _mm_xor_si128(aes128_enc(k1, s), s);
      __m128i e2 = _mm_xor_si128(aes128_enc(k2, s), s);
      uint8_t b1[16], b2[16], srb[16];
      _mm_storeu_si128((__m128i*)b1, e1);
      _mm_storeu_si128((__m128i*)b2, e2);
      uint8_t t = tbits[j];
      __m128i corr = t ? cw_seed : _mm_setzero_si128();
      __m128i sl = _mm_xor_si128(e0, corr);
      memcpy(srb, b1 + 1, 15);
      srb[15] = b2[0];
      __m128i sr = _mm_xor_si128(_mm_loadu_si128((const __m128i*)srb), corr);
      _mm_storeu_si128((__m128i*)(next_seeds.data() + 16 * (2 * j)), sl);
      _mm_storeu_si128((__m128i*)(next_seeds.data() + 16 * (2 * j + 1)), sr);
      next_t[2 * j] = (b1[0] & 1) ^ (t & cw_tl);
      next_t[2 * j + 1] = (b2[1] & 1) ^ (t & cw_tr);
    }
    seeds.swap(next_seeds);
    tbits.swap(next_t);
    live = next_live;
    seeds.resize(live * 16);
    tbits.resize(live);
  }

  for (uint64_t L = 0; L < n_leaves && L < live; L++) {
    __m128i s = _mm_loadu_si128((const __m128i*)(seeds.data() + 16 * L));
    for (uint32_t b = 0; b < leaf_blocks; b++) {
      // block b input = seed ^ LE64(b) (prf_blocks' CTR convention;
      // b = 0 degenerates to the classic single-block leaf)
      __m128i x = b ? _mm_xor_si128(s, _mm_set_epi64x(0, (long long)b)) : s;
      __m128i blk = _mm_xor_si128(aes128_enc(k3, x), x);
      __m128i fcw =
          _mm_loadu_si128((const __m128i*)(final_cw_block + 16 * b));
      if (tbits[L]) blk = _mm_xor_si128(blk, fcw);
      uint8_t bytes[16];
      _mm_storeu_si128((__m128i*)bytes, blk);
      uint64_t base = L * leaf_rows + ((uint64_t)b << 7);
      if (base >= height) break;
      uint64_t count = height - base < 128 ? height - base : 128;
      for (uint64_t i = 0; i < count; i++)
        out_bits[base + i] = (bytes[i >> 3] >> (i & 7)) & 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Batched point evaluation (keyword mode, db.go:119-135)
// ---------------------------------------------------------------------------

void pir_eval_point_bits(const uint8_t* prf_keys, uint32_t num_bits,
                         const uint8_t* s_init, uint8_t t_init,
                         const uint8_t* cw, int64_t final_cw,
                         const uint64_t* points, uint64_t n,
                         uint8_t* out_bits) {
  AesKey k0, k1, k2;
  aes128_expand(prf_keys + 0, &k0);
  aes128_expand(prf_keys + 16, &k1);
  aes128_expand(prf_keys + 32, &k2);
  __m128i s0 = _mm_loadu_si128((const __m128i*)s_init);
  uint8_t fcw_par = (uint8_t)(final_cw & 1);

  for (uint64_t i = 0; i < n; i++) {
    __m128i s = s0;
    uint8_t t = t_init;
    uint64_t x = points[i];
    for (uint32_t lvl = 0; lvl < num_bits; lvl++) {
      const uint8_t* cw_l = cw + (size_t)lvl * 18;
      __m128i cw_seed = _mm_loadu_si128((const __m128i*)cw_l);
      __m128i corr = t ? cw_seed : _mm_setzero_si128();
      uint8_t xbit = (x >> (num_bits - 1 - lvl)) & 1;
      __m128i e1 = _mm_xor_si128(aes128_enc(k1, s), s);
      if (!xbit) {
        __m128i e0 = _mm_xor_si128(aes128_enc(k0, s), s);
        uint8_t b1_0 = (uint8_t)_mm_cvtsi128_si32(e1);
        s = _mm_xor_si128(e0, corr);
        t = (b1_0 & 1) ^ (t & cw_l[16]);
      } else {
        __m128i e2 = _mm_xor_si128(aes128_enc(k2, s), s);
        uint8_t b1[16], b2[16], srb[16];
        _mm_storeu_si128((__m128i*)b1, e1);
        _mm_storeu_si128((__m128i*)b2, e2);
        memcpy(srb, b1 + 1, 15);
        srb[15] = b2[0];
        s = _mm_xor_si128(_mm_loadu_si128((const __m128i*)srb), corr);
        t = (b2[1] & 1) ^ (t & cw_l[17]);
      }
    }
    uint8_t seed8[16];
    _mm_storeu_si128((__m128i*)seed8, s);
    uint8_t par = varint_parity(seed8) ^ (t & fcw_par);
    out_bits[i] = par ^ 1;
  }
}

// ---------------------------------------------------------------------------
// Masked-XOR scan (db.go:74-107)
// ---------------------------------------------------------------------------
// db: height x row_bytes (row_bytes need not be aligned); out: row_bytes.

void pir_scan_xor(const uint8_t* db, uint64_t height, uint64_t row_bytes,
                  const uint8_t* bits, uint8_t* out) {
  memset(out, 0, row_bytes);
  uint64_t words = row_bytes / 8;
  uint64_t tail = row_bytes - words * 8;
  uint64_t acc_stack[512];
  std::vector<uint64_t> acc_heap;
  uint64_t* acc = acc_stack;
  if (words > 512) {
    acc_heap.assign(words, 0);
    acc = acc_heap.data();
  } else {
    memset(acc_stack, 0, words * 8);
  }
  for (uint64_t r = 0; r < height; r++) {
    if (!bits[r]) continue;
    const uint8_t* row = db + r * row_bytes;
    uint64_t w;
    for (uint64_t i = 0; i < words; i++) {
      memcpy(&w, row + 8 * i, 8);
      acc[i] ^= w;
    }
    for (uint64_t i = 0; i < tail; i++) out[words * 8 + i] ^= row[words * 8 + i];
  }
  memcpy(out, acc, words * 8);
}

// Batched scan: one streaming pass over the DB answers Q queries at once.
// Each server-side bit vector is pseudorandom (~height/2 ones), so the
// per-query scan touches ~half the table; answering queries one by one
// streams the table from DRAM Q times. Blocking rows so a block fits in
// LLC lets all Q queries consume it before eviction: DRAM traffic drops
// from ~Q*height*row_bytes/2 to ~height*row_bytes. bits is (Q, height)
// row-major; out is (Q, row_bytes).
void pir_scan_xor_batch(const uint8_t* db, uint64_t height, uint64_t row_bytes,
                        const uint8_t* bits, uint64_t num_q, uint8_t* out) {
  memset(out, 0, num_q * row_bytes);
  uint64_t words = row_bytes / 8;
  uint64_t tail = row_bytes - words * 8;
  // block sized to ~2 MiB of table so it stays cache-resident across the
  // per-query inner passes
  uint64_t block = row_bytes ? ((2ull << 20) / row_bytes) : height;
  if (block < 64) block = 64;
  std::vector<uint64_t> acc(words);
  for (uint64_t r0 = 0; r0 < height; r0 += block) {
    uint64_t rn = height - r0 < block ? height - r0 : block;
    for (uint64_t q = 0; q < num_q; q++) {
      const uint8_t* b = bits + q * height + r0;
      uint8_t* o = out + q * row_bytes;
      memcpy(acc.data(), o, words * 8);
      for (uint64_t r = 0; r < rn; r++) {
        if (!b[r]) continue;
        const uint8_t* row = db + (r0 + r) * row_bytes;
        uint64_t w;
        for (uint64_t i = 0; i < words; i++) {
          memcpy(&w, row + 8 * i, 8);
          acc[i] ^= w;
        }
        for (uint64_t i = 0; i < tail; i++)
          o[words * 8 + i] ^= row[words * 8 + i];
      }
      memcpy(o, acc.data(), words * 8);
    }
  }
}

}  // extern "C"
