// Host build of the per-query tail kernel's per-thread code, for checking
// it without a GPU: the query constants, the walk down to a thread's node,
// the depth-first subtree walk and the leaf blocks of fast_tail.cuh run
// here on the per-bank AES table once per (query, thread-grid lane word,
// bit position), each bit position as its lane reads the table. A warp's
// head seeds come through the lockstep model of the kernel's warp
// transpose (warp_unbitslice), and each leaf block's words through the
// same model of its warp transpose, corrected by t & fcw and staged where
// the kernel stages them. tests/test_torch_fast_tail_host.py compiles
// this file with a host C++ compiler and holds it against the plain torch
// version.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libfast_tail_host.so fast_tail_host.cpp

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
  static pir_tail::AesLaneTable table;
  for (int i = 0; i < 2048; ++i) pir_tail::fill_lane_table(table, i);
  const size_t nwtot = (size_t)n_blk * a.nwf;
  const int sub = levels - a.split;
  const int leaves = 1 << sub;
  // a warp's leaves: seed and t bit of each (leaf, lane)
  std::vector<uint32_t> leaf_seed((size_t)leaves * 32 * 4), leaf_t((size_t)leaves * 32);
  for (int q = 0; q < q_n; ++q) {
    static QueryConsts consts;
    for (int i = 0; i < kQueryItems; ++i) fill_query(consts, a, q, i);
    uint32_t* out_q = out + (size_t)q * 128 * nwtot;
    for (int word = 0; word < a.wt; ++word) {
      uint32_t head[32][4];
      pir_tail::unbitslice_lockstep(head_planes(a, q, word % nw0), 16 * (size_t)nw0, nw0, head);
      for (int lane = 0; lane < 32; ++lane) {
        uint32_t st[4];
        std::memcpy(st, head[lane], sizeof st);
        const uint32_t tb = (t[(size_t)q * nw0 + word % nw0] >> lane) & 1u;
        for_each_leaf(a, pir_tail::lanes_of(table, lane), consts, word / nw0, st, tb,
                      [&](int c, const uint32_t* ls, uint32_t lt) {
          std::memcpy(&leaf_seed[((size_t)c * 32 + lane) * 4], ls, 4 * sizeof(uint32_t));
          leaf_t[(size_t)c * 32 + lane] = lt;
        });
      }
      for (int c = 0; c < leaves; ++c) {
        uint32_t tword = 0;  // the warp's __ballot_sync of its t bits
        for (int lane = 0; lane < 32; ++lane) tword |= leaf_t[(size_t)c * 32 + lane] << lane;
        const size_t col = (size_t)word + (size_t)a.wt * bit_reverse(c, sub);
        for (int b = 0; b < n_blk; ++b) {
          uint32_t o[32][4], stage[kStageStride];
          for (int lane = 0; lane < 32; ++lane)
            pir_tail::leaf_mmo(pir_tail::lanes_of(table, lane), consts.keys[3],
                               &leaf_seed[((size_t)c * 32 + lane) * 4], b, o[lane]);
          for (int c4 = 0; c4 < 4; ++c4) {
            uint32_t x[32];
            for (int lane = 0; lane < 32; ++lane) x[lane] = o[lane][c4];
            pir_tail::transpose_lockstep(x);
            for (int lane = 0; lane < 32; ++lane) {
              const int row = stage_row(lane, c4);
              stage[stage_index(row)] =
                  x[lane] ^ (tword & fcw_word(consts, a, q, row >> 4, b, row & 15));
            }
          }
          for (int row = 0; row < 128; ++row)
            out_q[(size_t)row * nwtot + (size_t)b * a.nwf + col] = stage[stage_index(row)];
        }
      }
    }
  }
  return 0;
}
