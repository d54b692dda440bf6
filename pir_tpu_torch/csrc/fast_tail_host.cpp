// Host build of the per-query tail kernel's per-thread code, for checking
// it without a GPU: the query constants, head node, split walk, depth-
// first subtree walk and leaf blocks of fast_tail.cuh run here once per
// (query, thread-grid lane word, bit position), and each output bit is
// packed where the kernel's warp transpose puts it, then corrected by
// t & fcw on the words as the kernel's stores do.
// tests/test_torch_fast_tail_host.py compiles this file with a host C++
// compiler and holds it against the plain torch version.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libfast_tail_host.so fast_tail_host.cpp

#include <algorithm>
#include <cstring>
#include <vector>

#include "host_shim.h"
#include "fast_tail.cuh"

using namespace pir_fast;

// Same operands and output as pir_fast_tail in fast_tail.cu. Returns 0,
// or 1 for levels outside 0..kMaxLevels.
extern "C" int pir_fast_tail_host(const uint32_t* seeds, const uint32_t* t,
                                  const uint32_t* cw_s, const uint32_t* cw_tl,
                                  const uint32_t* cw_tr, const uint32_t* rk, const uint32_t* fcw,
                                  const uint32_t* rk_leaf, uint32_t* out, int q_n, int nw0,
                                  int levels, int n_blk, int rk_per_query) {
  if (levels < 0 || levels > kMaxLevels) return 1;
  FastTailArgs a{seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                 q_n, nw0, levels, n_blk, rk_per_query};
  init_geometry(a);
  static AesTables tables;
  for (int i = 0; i < 256; ++i) pir_tail::fill_tables(tables, i);
  const size_t nwtot = (size_t)n_blk * a.nwf;
  std::memset(out, 0, sizeof(uint32_t) * (size_t)q_n * 128 * nwtot);
  std::vector<uint32_t> tword(a.nwf);
  const int sub = levels - a.split;
  for (int q = 0; q < q_n; ++q) {
    static QueryConsts consts;
    for (int i = 0; i < kQueryItems; ++i) fill_query(consts, a, q, i);
    std::fill(tword.begin(), tword.end(), 0u);
    uint32_t* out_q = out + (size_t)q * 128 * nwtot;
    for (int word = 0; word < a.wt; ++word) {
      for (int lane = 0; lane < 32; ++lane) {
        uint32_t st[4], tb;
        head_node(a, q, word % nw0, lane, st, &tb);
        for_each_leaf(a, tables, consts, word / nw0, st, tb,
                      [&](int c, const uint32_t* ls, uint32_t lt) {
          const size_t w = (size_t)word + (size_t)a.wt * bit_reverse(c, sub);
          tword[w] |= lt << lane;
          for (int b = 0; b < n_blk; ++b) {
            uint32_t o[4];
            leaf_mmo(tables, consts, ls, b, o);
            for (int k = 0; k < 8; ++k)
              for (int i = 0; i < 16; ++i)
                out_q[(size_t)(k * 16 + i) * nwtot + (size_t)b * a.nwf + w] |=
                    ((o[i >> 2] >> (8 * (i & 3) + k)) & 1u) << lane;
          }
        });
      }
    }
    const uint32_t* fcw_q = fcw + (size_t)q * 8 * n_blk * 16;
    for (int row = 0; row < 128; ++row)
      for (int b = 0; b < n_blk; ++b)
        for (int w = 0; w < a.nwf; ++w)
          out_q[(size_t)row * nwtot + (size_t)b * a.nwf + w] ^=
              tword[w] & fcw_q[((size_t)(row >> 4) * n_blk + b) * 16 + (row & 15)];
  }
  return 0;
}
