// Per-thread Montgomery arithmetic on 32-bit words, for the batched
// modexp (kernel 9) and the cPIR scan (kernel 10) of mont_exp.cu.
//
// The counterpart of pir_tpu/crypto/mont_tpu.py (mont_mul, mont_exp,
// _tree_product, _scan_chunk), which is jitted jnp and reaches no Pallas
// kernel. That module keeps radix-2^15 limbs so that its lazy-carry CIOS
// never overflows a uint32 lane; here a number mod m is L = ceil(bits(m) /
// 32) words of 32 bits, R = 2^(32 L), and every product runs a real carry
// chain in 64-bit intermediates (a 32 x 32 -> 64 multiply-add and two
// carries never exceed 2^64 - 1). L is sized to the modulus exactly and is
// a runtime value: nothing is compiled per shape. Operands may be as
// small as R > m allows, so a product ends with the conditional
// subtraction of m, done by a mask (no branch on the value): inputs below
// m give an output below m, and every value stays fully reduced.
//
// A run of words is a base pointer and a word stride (`Words`), so the
// same code reads a thread's words interleaved with other threads'
// ([word][thread], coalesced) in shared or global memory, a block's table
// in shared memory, or a row-major array. Exponent bits only ever build
// masks: the window digit picks a table entry by reading every entry and
// masking (`Select`), and the final subtraction is a select, so no branch
// and no address depends on an exponent or a value. The loops depend on L
// and e_max alone.
//
// Everything here is __host__ __device__: csrc/mont_host.cpp builds it with
// a host C++ compiler through host_shim.h.

#pragma once

#include <cstdint>

namespace pir_mont {

// word j of a run at p[j * stride]
struct Words {
  uint32_t* p;
  long long stride;
  __host__ __device__ __forceinline__ uint32_t& operator[](int j) const { return p[j * stride]; }
};

struct CWords {
  const uint32_t* p;
  long long stride;
  __host__ __device__ __forceinline__ uint32_t operator[](int j) const { return p[j * stride]; }
};

// the integer 1, as the operand that leaves the Montgomery domain
struct Unit {
  __host__ __device__ __forceinline__ uint32_t operator[](int j) const { return j == 0; }
};

// Entry `digit` of a table of `count` entries (entry k, word i at
// p[k * entry_stride + i * word_stride]), read obliviously: word i loads
// every entry's word i and keeps one by a mask.
struct Select {
  const uint32_t* p;
  long long entry_stride;
  long long word_stride;
  int count;
  uint32_t digit;
  __host__ __device__ __forceinline__ uint32_t operator[](int i) const {
    uint32_t v = 0;
    const uint32_t* q = p + i * word_stride;
    for (int k = 0; k < count; ++k)
      v |= q[k * entry_stride] & (0u - (uint32_t)((uint32_t)k == digit));
    return v;
  }
};

__host__ __device__ __forceinline__ uint64_t mul_wide(uint32_t a, uint32_t b) {
  return (uint64_t)a * b;
}

// t (L + 1 words) = a * b / R mod m, fully reduced, for a < R, b < m (CIOS,
// one pass a word of a: t + a_i b and the reduction m_i n share the loop
// over j; 2 L^2 + L wide products). n0inv = -m^-1 mod 2^32. t may alias
// neither a nor b.
template <class A, class B, class N>
__host__ __device__ __forceinline__ void mont_mul(const A& a, const B& b, const N& n,
                                                  uint32_t n0inv, int L, Words t) {
  for (int j = 0; j <= L; ++j) t[j] = 0;
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a[i];
    uint64_t s1 = mul_wide(ai, b[0]) + t[0];
    const uint32_t mi = (uint32_t)s1 * n0inv;
    uint64_t s2 = mul_wide(mi, n[0]) + (uint32_t)s1;  // low word 0
    uint64_t c1 = s1 >> 32, c2 = s2 >> 32;
    for (int j = 1; j < L; ++j) {
      s1 = mul_wide(ai, b[j]) + t[j] + c1;
      s2 = mul_wide(mi, n[j]) + (uint32_t)s1 + c2;
      t[j - 1] = (uint32_t)s2;
      c1 = s1 >> 32;
      c2 = s2 >> 32;
    }
    const uint64_t s = (uint64_t)t[L] + c1 + c2;
    t[L - 1] = (uint32_t)s;
    t[L] = (uint32_t)(s >> 32);
  }
  // t < 2m: subtract m unless t < m, the borrow of t - m deciding by a mask
  uint32_t borrow = 0;
  for (int j = 0; j < L; ++j) borrow = (uint32_t)(((uint64_t)t[j] - n[j] - borrow) >> 63);
  const uint32_t keep = 0u - (uint32_t)(t[L] < borrow);
  borrow = 0;
  for (int j = 0; j < L; ++j) {
    const uint64_t d = (uint64_t)t[j] - n[j] - borrow;
    borrow = (uint32_t)(d >> 63);
    t[j] = (t[j] & keep) | ((uint32_t)d & ~keep);
  }
  t[L] = 0;
}

template <class S>
__host__ __device__ __forceinline__ void copy_words(const S& src, Words dst, int L) {
  for (int j = 0; j < L; ++j) dst[j] = src[j];
}

__host__ __device__ __forceinline__ void swap_words(Words& a, Words& b) {
  const Words c = a;
  a = b;
  b = c;
}

// the wbits-bit digit of an exponent (word w at e[w * stride]) at bit
// position pos, a multiple of wbits (1 or 4): it never straddles a word
__host__ __device__ __forceinline__ uint32_t digit_at(const uint32_t* e, long long stride,
                                                      int pos, int wbits) {
  return (e[(pos >> 5) * stride] >> (pos & 31)) & ((1u << wbits) - 1u);
}

// The fixed-window table of one base: entry k = base^k in the Montgomery
// domain, k < 2^wbits (entry k, word i at tbl.p[(k * L + i) * tbl.stride]).
// Uses t (L + 1 words) as scratch: 2^wbits products.
template <class N>
__host__ __device__ __forceinline__ void build_table(CWords base, CWords r2, const N& n,
                                                     uint32_t n0inv, int L, int wbits,
                                                     Words tbl, Words t) {
  const int count = 1 << wbits;
  const long long es = (long long)L * tbl.stride;
  mont_mul(Unit{}, r2, n, n0inv, L, t);  // R mod m, the domain's 1
  copy_words(t, Words{tbl.p, tbl.stride}, L);
  mont_mul(base, r2, n, n0inv, L, t);  // base R mod m
  copy_words(t, Words{tbl.p + es, tbl.stride}, L);
  for (int k = 2; k < count; ++k) {
    mont_mul(CWords{tbl.p + (k - 1) * es, tbl.stride}, CWords{tbl.p + es, tbl.stride}, n, n0inv,
             L, t);
    copy_words(t, Words{tbl.p + k * es, tbl.stride}, L);
  }
}

// acc = acc^(2^wbits) * table[digit], the obliviously selected entry
template <class N>
__host__ __device__ __forceinline__ void window_step(const uint32_t* tbl, long long tbl_stride,
                                                     int wbits, uint32_t digit, const N& n,
                                                     uint32_t n0inv, int L, Words& acc,
                                                     Words& t) {
  for (int s = 0; s < wbits; ++s) {
    mont_mul(acc, acc, n, n0inv, L, t);
    swap_words(acc, t);
  }
  const Select sel{tbl, (long long)L * tbl_stride, tbl_stride, 1 << wbits, digit};
  mont_mul(sel, acc, n, n0inv, L, t);
  swap_words(acc, t);
}

// out (L words) = base^e mod m, for base < m: enter the domain, build the
// table, run the MSB-first fixed-window ladder over e_max bits from the
// domain's 1 (as mont_tpu.mont_exp: 4-bit windows for e_max >= 64, else
// square and multiply), leave the domain. acc and t: L + 1 words each;
// tbl: 2^wbits entries of L words.
template <class N>
__host__ __device__ __forceinline__ void powmod(CWords base, const uint32_t* e, long long e_stride,
                                                int e_max, const N& n, uint32_t n0inv,
                                                CWords r2, int L, int wbits, Words tbl,
                                                Words acc, Words t, Words out) {
  build_table(base, r2, n, n0inv, L, wbits, tbl, t);
  copy_words(tbl, acc, L);
  const int nwin = (e_max + wbits - 1) / wbits;
  for (int w = nwin - 1; w >= 0; --w)
    window_step(tbl.p, tbl.stride, wbits, digit_at(e, e_stride, w * wbits, wbits), n, n0inv, L,
                acc, t);
  mont_mul(Unit{}, acc, n, n0inv, L, t);
  copy_words(t, out, L);
}

// Straus's multi-exponentiation over `rows` rows that share the squarings:
// acc = prod_r table_r[digit of e_r]^(2^(wbits * window)) over the windows,
// in the Montgomery domain. Row r's table at tables + r * 2^wbits * L *
// tbl_stride (entry 0 the domain's 1 in each); row r's exponent words at
// e + r * e_row_stride, word stride e_stride. Exponent 0 selects entry 0,
// the identity: an out-of-range slot's `continue` in db.go.
template <class N>
__host__ __device__ __forceinline__ void straus_rows(const uint32_t* tables, long long tbl_stride,
                                                     int rows, const uint32_t* e,
                                                     long long e_row_stride, long long e_stride,
                                                     int e_max, int wbits, const N& n,
                                                     uint32_t n0inv, int L, Words& acc,
                                                     Words& t) {
  const long long row_words = ((long long)L << wbits) * tbl_stride;
  copy_words(CWords{tables, tbl_stride}, acc, L);
  const int nwin = (e_max + wbits - 1) / wbits;
  for (int w = nwin - 1; w >= 0; --w) {
    for (int s = 0; s < wbits; ++s) {
      mont_mul(acc, acc, n, n0inv, L, t);
      swap_words(acc, t);
    }
    for (int r = 0; r < rows; ++r) {
      const uint32_t d = digit_at(e + r * e_row_stride, e_stride, w * wbits, wbits);
      const Select sel{tables + r * row_words, (long long)L * tbl_stride, tbl_stride,
                       1 << wbits, d};
      mont_mul(sel, acc, n, n0inv, L, t);
      swap_words(acc, t);
    }
  }
}

}  // namespace pir_mont
