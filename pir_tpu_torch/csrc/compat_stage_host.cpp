// Host build of the compat-stage kernel's per-thread code, for checking
// it without a GPU: the query constants, per-bank AES table, subtree walk
// and selection bit of compat_stage.cuh run here once per (query, chunk,
// lane word, bit position), each node's seed comes through the lockstep
// model of the kernel's warp transpose, and each output bit is packed
// where the kernel's __ballot_sync would put it. tests/test_torch_compat_host.py compiles
// this file with a host C++ compiler and holds it against the plain
// torch version.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libcompat_stage_host.so compat_stage_host.cpp

#include <cstring>

#include "host_shim.h"
#include "compat_stage.cuh"

using namespace pir_compat;

namespace {

void run(const CompatArgs& a, int q_n, int emit_bits, uint32_t* out_s, uint32_t* out_t) {
  static pir_tail::AesLaneTable table;
  for (int i = 0; i < 2048; ++i) pir_tail::fill_lane_table(table, i);
  const size_t w = (size_t)a.w;
  const size_t nco = (size_t)a.nc << a.tail;
  for (int q = 0; q < q_n; ++q) {
    static QueryConsts consts;
    for (int i = 0; i < kQueryItems; ++i) fill_query(consts, a, q, i);
    for (int chunk = 0; chunk < a.nc; ++chunk) {
      for (int lw = 0; lw < a.w; ++lw) {
        uint32_t seeds[32][4];
        pir_tail::unbitslice_lockstep(a.seeds + ((size_t)q * 8 * a.nc + chunk) * 16 * w + lw,
                                      (size_t)a.nc * 16 * w, w, seeds);
        for (int lane = 0; lane < 32; ++lane) {
          uint32_t s[kMaxLeaves][4], t[kMaxLeaves];
          std::memcpy(s[0], seeds[lane], sizeof s[0]);
          t[0] = (a.t[((size_t)q * a.nc + chunk) * w + lw] >> lane) & 1u;
          expand_subtree(pir_tail::lanes_of(table, lane), consts, a.tail, s, t);
          for (int c = 0; c < (1 << a.tail); ++c) {
            const size_t oc = ((size_t)chunk << a.tail) + c;
            if (emit_bits) {
              out_s[((size_t)q * nco + oc) * w + lw] |= select_bit(s[c], t[c], consts.fcw) << lane;
              continue;
            }
            out_t[((size_t)q * nco + oc) * w + lw] |= t[c] << lane;
            for (int k = 0; k < 8; ++k)
              for (int i = 0; i < 16; ++i)
                out_s[((((size_t)q * 8 + k) * nco + oc) * 16 + i) * w + lw] |=
                    ((s[c][i >> 2] >> (8 * (i & 3) + k)) & 1u) << lane;
          }
        }
      }
    }
  }
}

}  // namespace

// Same operands and outputs as pir_compat_stage in compat_stage.cu; the
// outputs are zeroed here first. Returns 0, or 1 for a tail outside 1..3.
extern "C" int pir_compat_stage_host(const uint32_t* seeds, const uint32_t* t,
                                     const uint32_t* cw_s, const uint32_t* cw_tl,
                                     const uint32_t* cw_tr, const uint32_t* rk,
                                     const uint32_t* fcw, uint32_t* out_s, uint32_t* out_t,
                                     int q_n, int nc, int w, int tail, int emit_bits) {
  const CompatArgs a{seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, nc, w, tail};
  const size_t words = (size_t)q_n * ((size_t)nc << tail) * w;
  std::memset(out_s, 0, sizeof(uint32_t) * words * (emit_bits ? 1 : 128));
  if (!emit_bits) std::memset(out_t, 0, sizeof(uint32_t) * words);
  if (tail < 1 || tail > kMaxTail) return 1;
  run(a, q_n, emit_bits, out_s, out_t);
  return 0;
}
