// Montgomery arithmetic on a group of G lanes of one warp, for the batched
// modexp (kernel 9) and the cPIR scan (kernel 10) of mont_exp.cu.
//
// The counterpart of pir_tpu/crypto/mont_tpu.py (mont_mul, mont_exp,
// _tree_product, _scan_chunk), which is jitted jnp and reaches no Pallas
// kernel. That module keeps radix-2^15 limbs so that its lazy-carry CIOS
// never overflows a uint32 lane; here a number mod m is 32-bit words
// spread over a group of G lanes (G in {4, 8, 16, 32}, aligned in the
// warp): lane l holds words l K .. l K + K - 1 in registers (blocked),
// K from a fixed set of instances, L_pad = G K words, R = 2^(32 L_pad) > m.
//
// A product a b / R mod m runs one CIOS round a word a_i of a (L_pad
// rounds):
//   - a_i comes from its lane by a shuffle;
//   - the lane holding word 0 computes m_i = (t_0 + a_i b_0) n0inv, which
//     a shuffle hands to the group;
//   - each lane adds a_i b_j + m_i n_j into its K words (two 64-bit carry
//     chains, round_mac), keeping the carry out of its top word beside it
//     (carry-save: c <= 3, owed to the lane above);
//   - the sum moves down one word: a lane's words shift in registers and
//     its top word takes the lane above's bottom word, one shuffle a round
//     (round_shift).
// At the end the owed carries are resolved across the group (one shuffle,
// then a carry-lookahead over two ballots), and the final subtraction of
// m is a masked select whose borrow is resolved the same way. Inputs
// a < R, b < m give an output below m, so every value stays fully
// reduced. The product runs 2 L_pad^2 + L_pad wide products, as the
// per-word CIOS does, on G lanes at once.
//
// Exponent bits only ever build masks: a window digit picks a table entry
// by reading every entry and masking (select), and the final subtraction
// is a select, so no branch and no address depends on an exponent or a
// value. The loops depend on L, e_max and the shapes alone.
//
// Layout. The arithmetic between exchanges is __host__ __device__
// (round_m, round_mac, round_shift, add_carry, add_bit, sub_modulus,
// sub_bit, carries_in, keep_or_reduced), and so are the kernels' chains
// (table_chain, powmod_chain, scan_chain, merge_chain), written against a
// group type: LaneGroup below is one lane's registers on the card, with
// shuffles and ballots; csrc/mont_host.cpp's HostGroup holds all G lanes'
// registers and runs each exchange as an array read, in lockstep, so g++
// checks every step sequence the kernels run.

#pragma once

#include <cstdint>

namespace pir_mont {

// The lane-word counts K with an instance (crypto/mont.py LANE_WORDS).
#define PIR_MONT_LANE_WORDS(X) X(1) X(2) X(3) X(4) X(6) X(8) X(12) X(16) X(24)

// A group shape the kernels refuse: G lanes that do not divide a warp into
// 4-32, more words than G K, a window outside 1-8 bits.
__host__ __device__ __forceinline__ bool bad_group(int G, int K, int Lw, int wbits) {
  return (G != 4 && G != 8 && G != 16 && G != 32) || Lw < 1 || Lw > G * K || wbits < 1 ||
         wbits > 8;
}

// Where lane l's word k of entry e lies: p[e * entry + k * word + l * lane].
struct Layout {
  long long entry;
  int word;
  int lane;
};

// The lane's m_i candidate (t_0 + a_i b_0) n0inv mod 2^32: lane 0's, which
// holds word 0, is the round's.
__host__ __device__ __forceinline__ uint32_t round_m(uint32_t t0, uint32_t ai, uint32_t b0,
                                                     uint32_t n0inv) {
  return (t0 + ai * b0) * n0inv;
}

// A round's multiply-adds on the lane's K words: U = t + a_i b + m_i n + c
// 2^(32 K) over its words. Returns U's word 0 (for the lane below), leaves
// words 1 .. K - 1 in t[0 .. K - 2] and U's top (beyond K words) in top.
// Each step's 64-bit sums cannot overflow: (2^32 - 1)^2 + 2 (2^32 - 1).
template <int K>
__host__ __device__ __forceinline__ uint32_t round_mac(uint32_t (&t)[K], uint32_t c, uint32_t ai,
                                                       uint32_t mi, const uint32_t (&b)[K],
                                                       const uint32_t (&n)[K], uint64_t& top) {
  uint64_t c1 = 0, c2 = 0;
  uint32_t u0 = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t s1 = (uint64_t)ai * b[k] + t[k] + c1;
    const uint64_t s2 = (uint64_t)mi * n[k] + (uint32_t)s1 + c2;
    if (k == 0) {
      u0 = (uint32_t)s2;
    } else {
      t[k - 1] = (uint32_t)s2;
    }
    c1 = s1 >> 32;
    c2 = s2 >> 32;
  }
  top = c1 + c2 + c;
  return u0;
}

// The round's shift: x is word 0 of the lane above's U (0 in the group's
// top lane), which lands in this lane's top word with its U's top; what
// does not fit stays owed, c <= 3.
template <int K>
__host__ __device__ __forceinline__ void round_shift(uint32_t (&t)[K], uint32_t& c, uint32_t x,
                                                     uint64_t top) {
  const uint64_t v = top + x;
  t[K - 1] = (uint32_t)v;
  c = (uint32_t)(v >> 32);
}

// t += cin (the carry the lane below owes, <= 3). Returns the carry out
// (0 or 1); prop = 1 when every word is all ones after it (a carry in
// would pass through).
template <int K>
__host__ __device__ __forceinline__ uint32_t add_carry(uint32_t (&t)[K], uint32_t cin,
                                                       uint32_t& prop) {
  uint64_t s = cin;
  uint32_t all = ~0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s += t[k];
    t[k] = (uint32_t)s;
    s >>= 32;
    all &= t[k];
  }
  prop = (uint32_t)(all == ~0u);
  return (uint32_t)s;
}

template <int K>
__host__ __device__ __forceinline__ void add_bit(uint32_t (&t)[K], uint32_t bit) {
  uint64_t s = bit;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s += t[k];
    t[k] = (uint32_t)s;
    s >>= 32;
  }
}

// d = t - n over the lane's words. Returns the borrow out; zero = 1 when
// d is 0 (a borrow in would pass through).
template <int K>
__host__ __device__ __forceinline__ uint32_t sub_modulus(const uint32_t (&t)[K],
                                                         const uint32_t (&n)[K], uint32_t (&d)[K],
                                                         uint32_t& zero) {
  uint32_t borrow = 0, any = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t v = (uint64_t)t[k] - n[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
    any |= d[k];
  }
  zero = (uint32_t)(any == 0);
  return borrow;
}

template <int K>
__host__ __device__ __forceinline__ void sub_bit(uint32_t (&d)[K], uint32_t bit) {
  uint32_t borrow = bit;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t v = (uint64_t)d[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
}

// The carry into each lane of a group from the lanes' generate and
// propagate bits (bit l: lane l; the two never both set): bit l of the
// result is lane l's carry in, bit G the carry out of the top lane.
__host__ __device__ __forceinline__ uint64_t carries_in(uint32_t gen, uint32_t prop) {
  const uint64_t a = (uint64_t)(gen | prop), b = gen;
  return (a + b) ^ a ^ b;
}

// out = t when T < m (top word 0 and T - m borrowed), else d = T - m.
template <int K>
__host__ __device__ __forceinline__ void keep_or_reduced(const uint32_t (&t)[K],
                                                         const uint32_t (&d)[K], uint32_t top,
                                                         uint32_t borrow, uint32_t (&out)[K]) {
  const uint32_t keep = 0u - (uint32_t)(top < borrow);
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = (t[k] & keep) | (d[k] & ~keep);
}

// The wbits-bit window digit of an exponent (ew words at e) at bit pos,
// cut at e_max bits; it may straddle two words.
__host__ __device__ __forceinline__ uint32_t window_digit(const uint32_t* e, int ew, int pos,
                                                          int wbits, int e_max) {
  const int w = pos >> 5, s = pos & 31;
  uint32_t d = e[w] >> s;
  if (s + wbits > 32 && w + 1 < ew) d |= e[w + 1] << (32 - s);
  const int bits = e_max - pos < wbits ? e_max - pos : wbits;
  return d & ((1u << bits) - 1u);
}

// ---- the kernels' chains, for one group (G lanes) --------------------
//
// Grp provides Val (a group's number), lanes() (L_pad), load / store (a
// row of L words, zero past L), store_lanes (all L_pad words), store_at
// (entry e of a Layout), select (every entry of a table read, one kept by
// a mask), unit (the integer 1) and mul (a b / R mod m; out may alias b).
// Groups past the end of a launch repeat its last row or column and store
// the same words to the same place as the group they repeat.

// Entries k < 2^wbits of base's table, base^k R mod m, into tbl:
// 2^wbits - 1 products. r2 = R^2 mod m and
// one = R mod m at L_pad words.
template <class Grp>
__host__ __device__ __forceinline__ void table_chain(Grp& g, const uint32_t* base, int Lw,
                                                     const uint32_t* r2, const uint32_t* one,
                                                     int wbits, uint32_t* tbl, Layout lay) {
  typename Grp::Val a, acc;
  g.load(one, g.lanes(), acc);
  g.store_at(tbl, lay, 0, acc);
  g.load(r2, g.lanes(), acc);
  g.load(base, Lw, a);
  const int count = 1 << wbits;
  for (int k = 1; k < count; ++k) {
    if (k == 2) a = acc;  // entry 1, base R
    g.mul(a, acc, acc);   // k = 1: base r2 / R
    g.store_at(tbl, lay, k, acc);
  }
}

// Kernel 9's modexp of one group: out (Lw words) = base^e mod m by the
// MSB-first fixed window: the table (2^wbits - 1 products, in tbl, which
// the group alone reads), the top window's entry, then wbits squarings and
// one product a window, then leaving the domain: (2^wbits - 1) + (nwin -
// 1) (wbits + 1) + 1 products.
template <class Grp>
__host__ __device__ __forceinline__ void powmod_chain(Grp& g, const uint32_t* base, int Lw,
                                                      const uint32_t* e, int ew, int e_max,
                                                      int wbits, const uint32_t* r2,
                                                      const uint32_t* one, uint32_t* tbl,
                                                      Layout lay, uint32_t* out) {
  table_chain(g, base, Lw, r2, one, wbits, tbl, lay);
  typename Grp::Val a, acc;
  const int count = 1 << wbits, nwin = (e_max + wbits - 1) / wbits;
  g.select(tbl, lay, count, window_digit(e, ew, (nwin - 1) * wbits, wbits, e_max), acc);
  const int steps = (nwin - 1) * (wbits + 1);
  for (int s = 0; s <= steps; ++s) {
    const int r = s % (wbits + 1);
    if (s == steps) {
      g.unit(a);
    } else if (r < wbits) {
      a = acc;
    } else {
      g.select(tbl, lay, count,
               window_digit(e, ew, (nwin - 2 - s / (wbits + 1)) * wbits, wbits, e_max), a);
    }
    g.mul(a, acc, acc);
  }
  g.store(out, Lw, acc);
}

// Kernel 10's chain of one (column, chunk): `rows` rows whose tables lie
// at tbl + r * row_stride, exponents at e + r * e_stride (ew words each).
// Straus (horner = 0): prod_r table_r[digit]^(2^(wbits w)) over the
// windows, squarings shared by the rows, one partial at part. Horner
// (horner = 1): for each window w, prod_r table_r[digit w] alone, at part
// + w * part_stride (the merge runs the squarings once a column). The
// first multiplicand of a run is a copy.
template <class Grp>
__host__ __device__ __forceinline__ void scan_chain(Grp& g, const uint32_t* tbl,
                                                    long long row_stride, Layout lay, int rows,
                                                    const uint32_t* e, long long e_stride, int ew,
                                                    int e_max, int wbits, int horner,
                                                    uint32_t* part, long long part_stride) {
  typename Grp::Val a, acc;
  const int count = 1 << wbits, nwin = (e_max + wbits - 1) / wbits;
  for (int w = nwin - 1; w >= 0; --w) {
    const int sq = (!horner && w < nwin - 1) ? wbits : 0;
    for (int s = 0; s < sq + rows; ++s) {
      if (s < sq) {
        a = acc;
      } else {
        const int r = s - sq;
        g.select(tbl + r * row_stride, lay, count,
                 window_digit(e + r * e_stride, ew, w * wbits, wbits, e_max), a);
      }
      if (s == sq && (horner || w == nwin - 1)) {
        acc = a;
        continue;
      }
      g.mul(a, acc, acc);
    }
    if (horner) g.store_lanes(part + w * part_stride, acc);
  }
  if (!horner) g.store_lanes(part, acc);
}

// Kernel 10's merge of one column: the chunks' partials (chunk c, window
// p at part + c * chunk_stride + p * p_stride; P windows, 1 for Straus)
// by Horner's rule, wbits squarings between windows, then leaving the
// domain: out (Lw words) = the column's product mod m; (P - 1) wbits +
// P chunks products.
template <class Grp>
__host__ __device__ __forceinline__ void merge_chain(Grp& g, const uint32_t* part,
                                                     long long chunk_stride, long long p_stride,
                                                     int chunks, int P, int wbits, uint32_t* out,
                                                     int Lw) {
  typename Grp::Val a, acc;
  for (int p = P - 1; p >= -1; --p) {  // p = -1: leave the domain
    const int sq = (p >= 0 && p < P - 1) ? wbits : 0, terms = p >= 0 ? chunks : 1;
    for (int s = 0; s < sq + terms; ++s) {
      if (s < sq) {
        a = acc;
      } else if (p < 0) {
        g.unit(a);
      } else {
        g.load(part + (s - sq) * chunk_stride + p * p_stride, g.lanes(), a);
      }
      if (p == P - 1 && s == 0) {
        acc = a;
        continue;
      }
      g.mul(a, acc, acc);
    }
  }
  g.store(out, Lw, acc);
}

#ifdef __CUDACC__

constexpr unsigned kFull = 0xffffffffu;

// x, hidden from the optimizer. A lane-dependent value enters the loops as
// a mask made this way: as a condition, the compiler unswitched the round
// loop on it, and a warp split over two copies of the loop takes the
// shuffles' collective slow path (~1000 cycles a round).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm("" : "+r"(x));
  return x;
}

// a b / R mod m on the group: every lane of the warp calls it at once. G
// divides 32; l is the lane's index in its group, not_top = ~0 unless l =
// G - 1, not_bottom = ~0 unless l = 0 (opaque masks). out may alias a or b.
template <int K>
__device__ __forceinline__ void group_mul(const uint32_t (&a)[K], const uint32_t (&b)[K],
                                          const uint32_t (&n)[K], uint32_t n0inv, int G, int l,
                                          uint32_t not_top, uint32_t not_bottom,
                                          uint32_t (&out)[K]) {
  uint32_t t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = 0;
  uint32_t c = 0;
  const auto round = [&](uint32_t ai) {
    const uint32_t mi = __shfl_sync(kFull, round_m(t[0], ai, b[0], n0inv), 0, G);
    uint64_t top;
    const uint32_t u0 = round_mac<K>(t, c, ai, mi, b, n, top);
    round_shift<K>(t, c, __shfl_down_sync(kFull, u0, 1, G) & not_top, top);
  };
  if constexpr (K <= 8) {
    // a source lane's K rounds unrolled, a_i by register index
#pragma unroll 1
    for (int src = 0; src < G; ++src) {
#pragma unroll
      for (int k = 0; k < K; ++k) round(__shfl_sync(kFull, a[k], src, G));
    }
  } else {
    // one round a loop step (cicc fails on the unrolled code at K = 24):
    // every lane rotates its copy of a by a word a round, so word k of
    // lane src is at index 0 in round src K + k
    uint32_t ar[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ar[k] = a[k];
#pragma unroll 1
    for (int src = 0; src < G; ++src) {
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const uint32_t first = ar[0];
        const uint32_t ai = __shfl_sync(kFull, first, src, G);
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) ar[j] = ar[j + 1];
        ar[K - 1] = first;
        round(ai);
      }
    }
  }
  const int base = (int)(threadIdx.x & 31) - l;
  const uint32_t seg = G == 32 ? ~0u : (1u << G) - 1u;
  const uint32_t below = __shfl_up_sync(kFull, c, 1, G) & not_bottom;
  const uint32_t ctop = __shfl_sync(kFull, c, G - 1, G);
  uint32_t prop;
  const uint32_t gen = add_carry<K>(t, below, prop);
  const uint64_t cv = carries_in((__ballot_sync(kFull, gen) >> base) & seg,
                                 (__ballot_sync(kFull, prop) >> base) & seg);
  add_bit<K>(t, (uint32_t)(cv >> l) & 1u);
  uint32_t d[K], zero;
  const uint32_t bo = sub_modulus<K>(t, n, d, zero);
  const uint64_t bv = carries_in((__ballot_sync(kFull, bo) >> base) & seg,
                                 (__ballot_sync(kFull, zero) >> base) & seg);
  sub_bit<K>(d, (uint32_t)(bv >> l) & 1u);
  keep_or_reduced<K>(t, d, ctop + (uint32_t)(cv >> G), (uint32_t)(bv >> G), out);
}

// One lane of a group on the card: its K words of each number, in
// registers, the modulus's among them. make() loads n (L_pad words).
template <int K>
struct LaneGroup {
  struct Val {
    uint32_t w[K];
  };
  int G, l;
  uint32_t n0inv, not_top, not_bottom;
  Val n;

  __device__ __forceinline__ static LaneGroup make(int G, int l, const uint32_t* n,
                                                   uint32_t n0inv) {
    LaneGroup g{G, l, n0inv, opaque(0u - (uint32_t)(l != G - 1)),
                opaque(0u - (uint32_t)(l != 0)), {}};
    g.load(n, G * K, g.n);
    return g;
  }
  __device__ __forceinline__ int lanes() const { return G * K; }
  // branch-free: past L, word 0 read and masked away
  __device__ __forceinline__ void load(const uint32_t* p, int L, Val& x) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = l * K + k;
      x.w[k] = p[j < L ? j : 0] & (0u - (uint32_t)(j < L));
    }
  }
  __device__ __forceinline__ void store(uint32_t* p, int L, const Val& x) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = l * K + k;
      if (j < L) p[j] = x.w[k];
    }
  }
  __device__ __forceinline__ void store_lanes(uint32_t* p, const Val& x) const {
#pragma unroll
    for (int k = 0; k < K; ++k) p[l * K + k] = x.w[k];
  }
  __device__ __forceinline__ void store_at(uint32_t* p, Layout lay, int e, const Val& x) const {
    uint32_t* q = p + e * lay.entry + l * lay.lane;
#pragma unroll
    for (int k = 0; k < K; ++k) q[k * lay.word] = x.w[k];
  }
  __device__ __forceinline__ void select(const uint32_t* p, Layout lay, int count,
                                         uint32_t digit, Val& x) const {
    const uint32_t* q = p + l * lay.lane;
#pragma unroll
    for (int k = 0; k < K; ++k) x.w[k] = 0;
#pragma unroll 1
    for (int e = 0; e < count; ++e) {
      const uint32_t mask = 0u - (uint32_t)((uint32_t)e == digit);
#pragma unroll
      for (int k = 0; k < K; ++k) x.w[k] |= q[e * lay.entry + k * lay.word] & mask;
    }
  }
  __device__ __forceinline__ void unit(Val& x) const {
#pragma unroll
    for (int k = 0; k < K; ++k) x.w[k] = 0;
    x.w[0] = 1u & ~not_bottom;
  }
  __device__ __forceinline__ void mul(const Val& a, const Val& b, Val& out) const {
    group_mul<K>(a.w, b.w, n.w, n0inv, G, l, not_top, not_bottom, out.w);
  }
};

#endif  // __CUDACC__

}  // namespace pir_mont
