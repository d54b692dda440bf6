// Per-thread pieces of the stacked tail kernel (stacked_tail.cu): byte-
// oriented AES-128 with a T-table, the fixed-key MMO PRG, the DPF child
// step (also used by compat_stage.cuh), and the walk of one thread's path
// down the DPF tail. Kept apart from the kernel so that a host compiler
// can exercise the same functions.
//
// Block convention: a 16-byte AES block is 4 little-endian 32-bit words,
// word c = bytes 4c..4c+3 = state column c (byte i is row i % 4, column
// i / 4, as in FIPS-197). Round keys are 44 words in the same packing.

#pragma once

#include <cstdint>

namespace pir_tail {

__device__ const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

// T0[x] = (2S[x], S[x], S[x], 3S[x]) as little-endian bytes: the
// MixColumns column of a state byte at row 0; rows 1..3 are rotations.
struct AesTables {
  uint32_t t0[256];
  uint32_t sbox[256];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void fill_tables(AesTables& tb, int i) {
  const uint32_t v = kSbox[i];
  const uint32_t v2 = ((v << 1) ^ ((v & 0x80u) ? 0x1Bu : 0u)) & 0xFFu;
  tb.sbox[i] = v;
  tb.t0[i] = v2 | (v << 8) | (v << 16) | ((v2 ^ v) << 24);
}

// One AES-128 encryption: rk = 44 round-key words.
__device__ __forceinline__ void aes128(const AesTables& tb, const uint32_t* rk,
                                       const uint32_t in[4], uint32_t out[4]) {
  uint32_t s0 = in[0] ^ rk[0], s1 = in[1] ^ rk[1];
  uint32_t s2 = in[2] ^ rk[2], s3 = in[3] ^ rk[3];
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    // SubBytes + ShiftRows + MixColumns: new column c takes row j from
    // old column (c + j) % 4
    const uint32_t n0 = tb.t0[s0 & 0xFF] ^ rotl(tb.t0[(s1 >> 8) & 0xFF], 8) ^
                        rotl(tb.t0[(s2 >> 16) & 0xFF], 16) ^ rotl(tb.t0[s3 >> 24], 24) ^ rk[4 * r];
    const uint32_t n1 = tb.t0[s1 & 0xFF] ^ rotl(tb.t0[(s2 >> 8) & 0xFF], 8) ^
                        rotl(tb.t0[(s3 >> 16) & 0xFF], 16) ^ rotl(tb.t0[s0 >> 24], 24) ^ rk[4 * r + 1];
    const uint32_t n2 = tb.t0[s2 & 0xFF] ^ rotl(tb.t0[(s3 >> 8) & 0xFF], 8) ^
                        rotl(tb.t0[(s0 >> 16) & 0xFF], 16) ^ rotl(tb.t0[s1 >> 24], 24) ^ rk[4 * r + 2];
    const uint32_t n3 = tb.t0[s3 & 0xFF] ^ rotl(tb.t0[(s0 >> 8) & 0xFF], 8) ^
                        rotl(tb.t0[(s1 >> 16) & 0xFF], 16) ^ rotl(tb.t0[s2 >> 24], 24) ^ rk[4 * r + 3];
    s0 = n0; s1 = n1; s2 = n2; s3 = n3;
  }
  out[0] = (tb.sbox[s0 & 0xFF] | (tb.sbox[(s1 >> 8) & 0xFF] << 8) |
            (tb.sbox[(s2 >> 16) & 0xFF] << 16) | (tb.sbox[s3 >> 24] << 24)) ^ rk[40];
  out[1] = (tb.sbox[s1 & 0xFF] | (tb.sbox[(s2 >> 8) & 0xFF] << 8) |
            (tb.sbox[(s3 >> 16) & 0xFF] << 16) | (tb.sbox[s0 >> 24] << 24)) ^ rk[41];
  out[2] = (tb.sbox[s2 & 0xFF] | (tb.sbox[(s3 >> 8) & 0xFF] << 8) |
            (tb.sbox[(s0 >> 16) & 0xFF] << 16) | (tb.sbox[s1 >> 24] << 24)) ^ rk[42];
  out[3] = (tb.sbox[s3 & 0xFF] | (tb.sbox[(s0 >> 8) & 0xFF] << 8) |
            (tb.sbox[(s1 >> 16) & 0xFF] << 16) | (tb.sbox[s2 >> 24] << 24)) ^ rk[43];
}

// Matyas-Meyer-Oseas: AES_k(x) ^ x.
__device__ __forceinline__ void mmo(const AesTables& tb, const uint32_t* rk,
                                    const uint32_t x[4], uint32_t out[4]) {
  aes128(tb, rk, x, out);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] ^= x[i];
}

// Bit `lane` of 128 bit-plane words -> one block. Word (bit k, byte i)
// sits at p[k * bit_stride + i * byte_stride].
__device__ __forceinline__ void gather_block(const uint32_t* __restrict__ p,
                                             size_t bit_stride, size_t byte_stride,
                                             int lane, uint32_t blk[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) blk[i] = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      blk[i >> 2] |= ((p[k * bit_stride + i * byte_stride] >> lane) & 1u) << (8 * (i & 3) + k);
}

// The PRG children of seed st, before the DPF correction
// (dpf/client.go:99-116): left sL = block 0 and tL = block 1 byte 0 bit 0;
// right sR = block 1 bytes 1..15 ++ block 2 byte 0 and tR = block 2
// byte 1 bit 0. Block 1 serves both, so one child costs two AES blocks
// and both cost three. keys = the three tree keys, 44 words each.
__device__ __forceinline__ void prg_children(const AesTables& tb, const uint32_t* keys,
                                             const uint32_t st[4], bool want_left,
                                             bool want_right, uint32_t sl[4], uint32_t* tl,
                                             uint32_t sr[4], uint32_t* tr) {
  uint32_t b1[4];
  mmo(tb, keys + 44, st, b1);
  if (want_left) {
    mmo(tb, keys, st, sl);
    *tl = b1[0] & 1u;
  }
  if (want_right) {
    uint32_t b2[4];
    mmo(tb, keys + 88, st, b2);
    sr[0] = __funnelshift_r(b1[0], b1[1], 8);
    sr[1] = __funnelshift_r(b1[1], b1[2], 8);
    sr[2] = __funnelshift_r(b1[2], b1[3], 8);
    sr[3] = __funnelshift_r(b1[3], b2[0], 8);
    *tr = (b2[0] >> 8) & 1u;
  }
}

// The DPF correction of one child of a parent with t bit t_parent:
// seed ^= cw & -t_parent, t ^= t_parent & tcw (tcw = the level's tL or
// tR correction bit).
__device__ __forceinline__ void correct_child(uint32_t s[4], uint32_t* t, const uint32_t cw[4],
                                              uint32_t t_parent, uint32_t tcw) {
  const uint32_t tmask = 0u - t_parent;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] ^= cw[i] & tmask;
  *t ^= t_parent & tcw;
}

// Operands of one launch, laid out as the TPU kernel's (uint32 words):
// seeds (S,8,1,16,W), t (S,1,1,W), cw_s (S,tail,8,16,W),
// cw_tl / cw_tr (S,tail,1,W), fcw (S,8,n_blk,16,W),
// out (S,8,(1<<tail)*n_blk,16,W).
struct TailArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* cw_s;
  const uint32_t* cw_tl;
  const uint32_t* cw_tr;
  const uint32_t* fcw;
  int w;
  int tail;
  int n_blk;
};

// Walk the `tail` levels from the head seed of (step s, lane word w,
// bit position lane) down to tail leaf c (its bits MSB first: chunk =
// parent * 2 + branch). keys = the three tree keys, 44 words each.
// Returns the leaf seed in st and its t bit in *tbit.
__device__ __forceinline__ void walk_tail(const TailArgs& a, const AesTables& tb,
                                          const uint32_t* keys, int s, int w, int lane,
                                          int c, uint32_t st[4], uint32_t* tbit) {
  const size_t sw = (size_t)a.w;
  gather_block(a.seeds + (size_t)s * 128 * sw + w, 16 * sw, sw, lane, st);
  uint32_t tb_ = (a.t[(size_t)s * sw + w] >> lane) & 1u;
  for (int l = 0; l < a.tail; ++l) {
    const int branch = (c >> (a.tail - 1 - l)) & 1;
    uint32_t child[4], tchild = 0;
    prg_children(tb, keys, st, branch == 0, branch == 1, child, &tchild, child, &tchild);
    const size_t lvl = (size_t)s * a.tail + l;
    uint32_t cw[4];
    gather_block(a.cw_s + lvl * 128 * sw + w, 16 * sw, sw, lane, cw);
    const uint32_t* tcw = branch ? a.cw_tr : a.cw_tl;
    correct_child(child, &tchild, cw, tb_, (tcw[lvl * sw + w] >> lane) & 1u);
#pragma unroll
    for (int i = 0; i < 4; ++i) st[i] = child[i];
    tb_ = tchild;
  }
  *tbit = tb_;
}

// Leaf CTR block b of a leaf seed: MMO of seed ^ LE64(b) under the leaf
// key, corrected by t & fcw.
__device__ __forceinline__ void leaf_block(const TailArgs& a, const AesTables& tb,
                                           const uint32_t* leaf_key, int s, int w, int lane,
                                           const uint32_t st[4], uint32_t tbit, int b,
                                           uint32_t o[4]) {
  const size_t sw = (size_t)a.w;
  const uint32_t x[4] = {st[0] ^ (uint32_t)b, st[1], st[2], st[3]};
  mmo(tb, leaf_key, x, o);
  uint32_t f[4];
  gather_block(a.fcw + ((size_t)s * 8 * a.n_blk * 16 + (size_t)b * 16) * sw + w,
               (size_t)a.n_blk * 16 * sw, sw, lane, f);
  const uint32_t tmask = 0u - tbit;
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] ^= f[i] & tmask;
}

// Round-key byte `rb` (round * 16 + byte) of key `key` (0..2 tree, 3
// leaf) from the 0/~0 mask operands, bit 0 of each mask word:
// rk (11,8,3,16,1) shared or (S,11,8,3,16,W) per lane, rk_leaf
// (11,8,16,1) or (S,11,8,16,W); rk_lanes = 1 or W.
__device__ __forceinline__ uint32_t key_byte(const uint32_t* __restrict__ rk,
                                             const uint32_t* __restrict__ rk_leaf,
                                             int rk_lanes, int s, int lane_word,
                                             int key, int rb) {
  const int r = rb / 16, byte = rb % 16;
  const bool per_lane = rk_lanes != 1;
  const size_t lanes = (size_t)rk_lanes;
  uint32_t v = 0;
  for (int bit = 0; bit < 8; ++bit) {
    uint32_t m;
    if (key < 3) {
      const size_t base = per_lane ? (size_t)s * 11 * 8 * 3 * 16 * lanes : 0;
      m = rk[base + ((size_t)((r * 8 + bit) * 3 + key) * 16 + byte) * lanes +
             (per_lane ? lane_word : 0)];
    } else {
      const size_t base = per_lane ? (size_t)s * 11 * 8 * 16 * lanes : 0;
      m = rk_leaf[base + ((size_t)(r * 8 + bit) * 16 + byte) * lanes +
                  (per_lane ? lane_word : 0)];
    }
    v |= (m & 1u) << bit;
  }
  return v;
}

}  // namespace pir_tail
