// Host build of the stacked tail kernel's per-thread code, for checking
// it without a GPU: the AES, tree walk, leaf blocks and key rebuild of
// stacked_tail.cuh run here once per (step, lane word, bit position,
// tail leaf), and each output bit is packed where the kernel's
// __ballot_sync would put it. tests/test_torch_tail_host.py compiles
// this file with a host C++ compiler and holds it against the plain
// torch version.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libstacked_tail_host.so stacked_tail_host.cpp

#include <cstring>

#include "host_shim.h"
#include "stacked_tail.cuh"

using namespace pir_tail;

// Same operands and output as pir_stacked_tail in stacked_tail.cu.
extern "C" void pir_stacked_tail_host(const uint32_t* seeds, const uint32_t* t,
                                      const uint32_t* cw_s, const uint32_t* cw_tl,
                                      const uint32_t* cw_tr, const uint32_t* rk,
                                      const uint32_t* fcw, const uint32_t* rk_leaf,
                                      uint32_t* out, int s_n, int w, int tail, int n_blk,
                                      int rk_lanes) {
  TailArgs a{seeds, t, cw_s, cw_tl, cw_tr, fcw, w, tail, n_blk};
  static AesTables tables;
  for (int i = 0; i < 256; ++i) fill_tables(tables, i);
  const int bn = (1 << tail) * n_blk;
  std::memset(out, 0, sizeof(uint32_t) * (size_t)s_n * 8 * bn * 16 * w);
  for (int s = 0; s < s_n; ++s) {
    for (int lw = 0; lw < w; ++lw) {
      uint32_t keys[4][44];
      for (int key = 0; key < 4; ++key)
        for (int rb = 0; rb < 176; ++rb)
          reinterpret_cast<uint8_t*>(keys[key])[rb] =
              static_cast<uint8_t>(key_byte(rk, rk_leaf, rk_lanes, s, lw, key, rb));
      for (int c = 0; c < (1 << tail); ++c) {
        for (int lane = 0; lane < 32; ++lane) {
          uint32_t st[4], tbit;
          walk_tail(a, tables, &keys[0][0], s, lw, lane, c, st, &tbit);
          for (int b = 0; b < n_blk; ++b) {
            uint32_t o[4];
            leaf_block(a, tables, keys[3], s, lw, lane, st, tbit, b, o);
            const int chunk = c * n_blk + b;
            for (int k = 0; k < 8; ++k)
              for (int i = 0; i < 16; ++i)
                out[((((size_t)s * 8 + k) * bn + chunk) * 16 + i) * w + lw] |=
                    ((o[i >> 2] >> (8 * (i & 3) + k)) & 1u) << lane;
          }
        }
      }
    }
  }
}
