// Host model of kernels 9 and 10 (mont_exp.cu), for checking them without
// a GPU: the same chains of mont.cuh (table_chain, powmod_chain,
// scan_chain, merge_chain) run on HostGroup, which holds all G lanes'
// registers of a group and runs the group product in lockstep with the
// same per-lane arithmetic as the card's LaneGroup: each shuffle is a read
// of another lane's array, each ballot a bit mask built over the lanes.
// The tables, partials and exponents lie as the kernels lay them out, and
// every Montgomery product is counted. tests/test_torch_mont_host.py
// compiles this file with a host C++ compiler and holds it against
// CPython pow and the planners' product counts (crypto/mont.py).
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libmont_host.so mont_host.cpp

#include <cstddef>
#include <vector>

#include "host_shim.h"
#include "mont.cuh"

using namespace pir_mont;

namespace {

template <int K>
struct HostGroup {
  struct Val {
    uint32_t w[32][K];
  };
  int G;
  uint32_t n0inv;
  Val n;
  long long* products;

  int lanes() const { return G * K; }
  void load(const uint32_t* p, int L, Val& x) const {
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < K; ++k) {
        const int j = l * K + k;
        x.w[l][k] = j < L ? p[j] : 0u;
      }
  }
  void store(uint32_t* p, int L, const Val& x) const {
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < K; ++k)
        if (l * K + k < L) p[l * K + k] = x.w[l][k];
  }
  void store_lanes(uint32_t* p, const Val& x) const { store(p, G * K, x); }
  void store_at(uint32_t* p, Layout lay, int e, const Val& x) const {
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < K; ++k) p[e * lay.entry + k * lay.word + l * lay.lane] = x.w[l][k];
  }
  void select(const uint32_t* p, Layout lay, int count, uint32_t digit, Val& x) const {
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < K; ++k) {
        uint32_t v = 0;
        for (int e = 0; e < count; ++e)
          v |= p[e * lay.entry + k * lay.word + l * lay.lane] &
               (0u - (uint32_t)((uint32_t)e == digit));
        x.w[l][k] = v;
      }
  }
  void unit(Val& x) const {
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < K; ++k) x.w[l][k] = (l == 0 && k == 0) ? 1u : 0u;
  }
  // group_mul of mont.cuh, all lanes in lockstep
  void mul(const Val& a, const Val& b, Val& out) const {
    uint32_t t[32][K] = {}, c[32] = {}, u0[32];
    uint64_t top[32];
    for (int src = 0; src < G; ++src)
      for (int k = 0; k < K; ++k) {
        const uint32_t ai = a.w[src][k];                              // shuffle from src
        const uint32_t mi = round_m(t[0][0], ai, b.w[0][0], n0inv);  // lane 0's, shuffled
        for (int l = 0; l < G; ++l)
          u0[l] = round_mac<K>(t[l], c[l], ai, mi, b.w[l], n.w[l], top[l]);
        for (int l = 0; l < G; ++l)  // shuffle down, 0 into the top lane
          round_shift<K>(t[l], c[l], l == G - 1 ? 0u : u0[l + 1], top[l]);
      }
    uint32_t gen = 0, prop = 0;
    for (int l = 0; l < G; ++l) {
      uint32_t p;
      gen |= add_carry<K>(t[l], l == 0 ? 0u : c[l - 1], p) << l;  // shuffle up
      prop |= p << l;
    }
    const uint64_t cv = carries_in(gen, prop);  // the two ballots
    uint32_t d[32][K], bo = 0, zs = 0;
    for (int l = 0; l < G; ++l) {
      add_bit<K>(t[l], (uint32_t)(cv >> l) & 1u);
      uint32_t z;
      bo |= sub_modulus<K>(t[l], n.w[l], d[l], z) << l;
      zs |= z << l;
    }
    const uint64_t bv = carries_in(bo, zs);
    const uint32_t ctop = c[G - 1] + (uint32_t)(cv >> G);
    for (int l = 0; l < G; ++l) {
      sub_bit<K>(d[l], (uint32_t)(bv >> l) & 1u);
      keep_or_reduced<K>(t[l], d[l], ctop, (uint32_t)(bv >> G), out.w[l]);
    }
    ++*products;
  }
};

template <int K>
HostGroup<K>* new_group(int G, const uint32_t* n, uint32_t n0inv, long long* products) {
  auto* g = new HostGroup<K>{G, n0inv, {}, products};
  g->load(n, G * K, g->n);
  return g;
}


template <int K>
void powmod_rows(const uint32_t* base, const uint32_t* e, uint32_t* out, const uint32_t* n,
                 const uint32_t* n0inv, const uint32_t* r2, const uint32_t* one, int b, int Lw,
                 int ew, int e_max, int wbits, int G, int per_row, long long* products) {
  const int Lp = G * K;
  // a group's table as kernel 9 lays out a warp's: entry e, word k, lane l
  // at (e K + k) 32 + l
  std::vector<uint32_t> tbl((std::size_t)K * 32 << wbits);
  for (long long row = 0; row < b; ++row) {
    const long long c = per_row ? row : 0;
    HostGroup<K>* g = new_group<K>(G, n + c * Lp, n0inv[c], products);
    powmod_chain(*g, base + row * Lw, Lw, e + row * ew, ew, e_max, wbits, r2 + c * Lp,
                 one + c * Lp, tbl.data(), Layout{(long long)K * 32, 32, 1}, out + row * Lw);
    delete g;
  }
}

template <int K>
void scan_rows(const uint32_t* bases, const uint32_t* e, uint32_t* out, const uint32_t* n,
               uint32_t n0inv, const uint32_t* r2, const uint32_t* one, int h, int w, int Lw,
               int ew, int e_max, int wbits, int G, int rc, int horner, long long* products) {
  const int Lp = G * K, chunks = (h + rc - 1) / rc;
  const int nwin = (e_max + wbits - 1) / wbits, P = horner ? nwin : 1;
  const long long row_words = (long long)Lp << wbits;
  const Layout lay{(long long)K * G, G, 1};
  HostGroup<K>* g = new_group<K>(G, n, n0inv, products);
  std::vector<uint32_t> tables((std::size_t)h * row_words);
  for (int r = 0; r < h; ++r)  // mont_table_kernel
    table_chain(*g, bases + (long long)r * Lw, Lw, r2, one, wbits,
                tables.data() + r * row_words, lay);
  std::vector<uint32_t> partials((std::size_t)chunks * P * w * Lp);
  for (int c = 0; c < chunks; ++c) {  // mont_scan_kernel: its block's tables
    const int r0 = c * rc, rows = rc < h - r0 ? rc : h - r0;
    std::vector<uint32_t> smem(tables.begin() + r0 * row_words,
                               tables.begin() + (r0 + rows) * row_words);
    for (long long col = 0; col < w; ++col)
      scan_chain(*g, smem.data(), row_words, lay, rows, e + ((long long)r0 * w + col) * ew,
                 (long long)w * ew, ew, e_max, wbits, horner,
                 partials.data() + ((long long)c * P * w + col) * Lp, (long long)w * Lp);
  }
  for (long long col = 0; col < w; ++col)  // mont_merge_kernel
    merge_chain(*g, partials.data() + col * Lp, (long long)P * w * Lp, (long long)w * Lp,
                chunks, P, wbits, out + col * Lw, Lw);
  delete g;
}

}  // namespace

// Kernel 9 (pir_mont_powmod's operands; n, r2, one at G K words a row or
// one row): out (b, Lw) words. *products counts the Montgomery products.
// Returns 0, or 1 for an operand shape the kernel refuses.
extern "C" int pir_mont_powmod_host(const uint32_t* base, const uint32_t* e, uint32_t* out,
                                    const uint32_t* n, const uint32_t* n0inv, const uint32_t* r2,
                                    const uint32_t* one, int b, int Lw, int ew, int e_max,
                                    int wbits, int G, int K, int per_row, long long* products) {
  if (b < 1 || ew < 1 || e_max < 1 || (e_max + 31) / 32 > ew || bad_group(G, K, Lw, wbits))
    return 1;
  switch (K) {
#define PIR_MONT_CASE(KK)                                                                     \
  case KK:                                                                                    \
    powmod_rows<KK>(base, e, out, n, n0inv, r2, one, b, Lw, ew, e_max, wbits, G, per_row,     \
                    products);                                                                \
    return 0;
    PIR_MONT_LANE_WORDS(PIR_MONT_CASE)
#undef PIR_MONT_CASE
  }
  return 1;
}

// Kernel 10 (the tables, rc rows a chunk, Straus or Horner, the merge):
// out (w, Lw) words = prod_r bases[r]^e[r][col] mod n. Returns 0, or 1
// for an operand shape the kernel refuses.
extern "C" int pir_mont_scan_host(const uint32_t* bases, const uint32_t* e, uint32_t* out,
                                  const uint32_t* n, uint32_t n0inv, const uint32_t* r2,
                                  const uint32_t* one, int h, int w, int Lw, int ew, int e_max,
                                  int wbits, int G, int K, int rc, int horner,
                                  long long* products) {
  if (h < 1 || w < 1 || rc < 1 || ew < 1 || e_max < 1 || (e_max + 31) / 32 > ew ||
      (h + rc - 1) / rc > 65535 || bad_group(G, K, Lw, wbits))
    return 1;
  switch (K) {
#define PIR_MONT_CASE(KK)                                                                     \
  case KK:                                                                                    \
    scan_rows<KK>(bases, e, out, n, n0inv, r2, one, h, w, Lw, ew, e_max, wbits, G, rc,        \
                  horner, products);                                                          \
    return 0;
    PIR_MONT_LANE_WORDS(PIR_MONT_CASE)
#undef PIR_MONT_CASE
  }
  return 1;
}
