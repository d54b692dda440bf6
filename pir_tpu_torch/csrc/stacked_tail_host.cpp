// Host build of the stacked tail kernel's per-thread code, for checking
// it without a GPU: the per-bank AES table, the depth-first walk, leaf
// blocks and key rebuild of stacked_tail.cuh run here once per (step,
// lane word, bit position); the head seed and each level's correction
// word come through the lockstep model of the kernel's warp transpose,
// each output bit is packed where the kernel's __ballot_sync would put
// it, and t & fcw is applied to the words as the kernel does.
// tests/test_torch_tail_host.py compiles this file with a host C++
// compiler and holds it against the plain torch version.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libstacked_tail_host.so stacked_tail_host.cpp

#include <algorithm>
#include <cstring>
#include <vector>

#include "host_shim.h"
#include "stacked_tail.cuh"

using namespace pir_tail;

// Same operands and output as pir_stacked_tail in stacked_tail.cu.
// Returns 0, or 1 for a tail outside 0..kMaxTail.
extern "C" int pir_stacked_tail_host(const uint32_t* seeds, const uint32_t* t,
                                     const uint32_t* cw_s, const uint32_t* cw_tl,
                                     const uint32_t* cw_tr, const uint32_t* rk,
                                     const uint32_t* fcw, const uint32_t* rk_leaf,
                                     uint32_t* out, int s_n, int w, int tail, int n_blk,
                                     int rk_lanes) {
  if (tail < 0 || tail > kMaxTail) return 1;
  static AesLaneTable table;
  for (int i = 0; i < 2048; ++i) fill_lane_table(table, i);
  const size_t sw = (size_t)w;
  const int leaves = 1 << tail;
  const int bn = leaves * n_blk;
  std::vector<uint32_t> words((size_t)bn * 128), twords(leaves);
  std::vector<uint32_t> cw_lanes((size_t)tail * 32 * 4);
  for (int s = 0; s < s_n; ++s) {
    for (int lw = 0; lw < w; ++lw) {
      alignas(16) uint32_t keys[4][44];
      for (int key = 0; key < 4; ++key)
        for (int rb = 0; rb < 176; ++rb)
          reinterpret_cast<uint8_t*>(keys[key])[rb] =
              static_cast<uint8_t>(key_byte(rk, rk_leaf, rk_lanes, s, lw, key, rb));
      uint32_t head[32][4];
      unbitslice_lockstep(seeds + (size_t)s * 128 * sw + lw, 16 * sw, sw, head);
      for (int l = 0; l < tail; ++l)
        unbitslice_lockstep(cw_s + ((size_t)s * tail + l) * 128 * sw + lw, 16 * sw, sw,
                            reinterpret_cast<uint32_t(*)[4]>(&cw_lanes[(size_t)l * 128]));
      std::fill(words.begin(), words.end(), 0u);
      std::fill(twords.begin(), twords.end(), 0u);
      for (int lane = 0; lane < 32; ++lane) {
        const AesLanes T = lanes_of(table, lane);
        uint32_t st[4];
        std::memcpy(st, head[lane], sizeof st);
        const uint32_t tb = (t[(size_t)s * sw + lw] >> lane) & 1u;
        for_each_tail_leaf(
            T, &keys[0][0], tail, st, tb,
            [&](int l, uint32_t cw[4], uint32_t* tcl, uint32_t* tcr) {
              const size_t lvl = (size_t)s * tail + l;
              std::memcpy(cw, &cw_lanes[((size_t)l * 32 + lane) * 4], 4 * sizeof(uint32_t));
              *tcl = (cw_tl[lvl * sw + lw] >> lane) & 1u;
              *tcr = (cw_tr[lvl * sw + lw] >> lane) & 1u;
            },
            [&](int c, const uint32_t* ls, uint32_t lt) {
              twords[c] |= lt << lane;
              for (int b = 0; b < n_blk; ++b) {
                uint32_t o[4];
                leaf_mmo(T, keys[3], ls, b, o);
                for (int k = 0; k < 8; ++k)
                  for (int i = 0; i < 16; ++i)
                    words[((size_t)c * n_blk + b) * 128 + k * 16 + i] |=
                        ((o[i >> 2] >> (8 * (i & 3) + k)) & 1u) << lane;
              }
            });
      }
      for (int c = 0; c < leaves; ++c)
        for (int b = 0; b < n_blk; ++b)
          for (int row = 0; row < 128; ++row) {
            const size_t col = (size_t)(row & 15) * sw + lw;
            const uint32_t f = fcw[(((size_t)s * 8 + (row >> 4)) * n_blk + b) * 16 * sw + col];
            out[(((size_t)s * 8 + (row >> 4)) * bn + c * n_blk + b) * 16 * sw + col] =
                words[((size_t)c * n_blk + b) * 128 + row] ^ (twords[c] & f);
          }
    }
  }
  return 0;
}
