// Host build of the compat-stage kernel's per-thread code, for checking
// it without a GPU: the query constants, per-bank AES table, subtree walk
// and selection bit of compat_stage.cuh run here once per (query, chunk,
// lane word, bit position), each node's seed comes through the lockstep
// model of the kernel's warp transpose, and each output bit is packed
// where the kernel's __ballot_sync would put it. The head kernel's
// prefix walk, breadth-first levels and depth-first subtrees run here the
// same way, thread by thread of each block. tests/test_torch_compat_host.py
// compiles this file with a host C++ compiler and holds it against the
// plain torch versions.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libcompat_stage_host.so compat_stage_host.cpp

#include <cstring>
#include <vector>

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

void run_head(const HeadArgs& a, int q_n, uint32_t* out_s, uint32_t* out_t) {
  static pir_tail::AesLaneTable table;
  for (int i = 0; i < 2048; ++i) pir_tail::fill_lane_table(table, i);
  const int g = head_group_bits(a.split);
  const int threads = 32 << g, bf = 5 + g, r = a.split - bf, base = a.prefix + bf;
  const size_t w = (size_t)1 << (a.split - 5);
  std::vector<uint32_t> ns(4 * threads), nt(threads);
  for (int q = 0; q < q_n; ++q) {
    static HeadConsts consts;
    for (int i = 0; i < kHeadItems; ++i) fill_head(consts, a, q, i);
    head_root(pir_tail::lanes_of(table, 0), consts, a, q, &ns[0], &nt[0]);
    for (int l = 0; l < bf; ++l) {
      const int n = 1 << l;
      for (int tid = 0; tid < n; ++tid) {  // children land on tid and on tid + n >= n
        uint32_t s[4], sl[4], tl, sr[4], tr;
        std::memcpy(s, &ns[4 * tid], sizeof s);
        head_children(pir_tail::lanes_of(table, tid % 32), consts, a.prefix + l, s, nt[tid], true,
                      true, sl, &tl, sr, &tr);
        std::memcpy(&ns[4 * tid], sl, sizeof sl);
        std::memcpy(&ns[4 * (tid + n)], sr, sizeof sr);
        nt[tid] = tl;
        nt[tid + n] = tr;
      }
    }
    for (int tid = 0; tid < threads; ++tid) {
      const int warp = tid / 32, lane = tid % 32;
      uint32_t st[4];
      std::memcpy(st, &ns[4 * tid], sizeof st);
      pir_tail::for_each_tail_leaf(
          pir_tail::lanes_of(table, lane), &consts.q.keys[0][0], r, st, nt[tid],
          [&](int d, uint32_t cwb[4], uint32_t* tcl, uint32_t* tcr) {
            std::memcpy(cwb, consts.cw[base + d], 4 * sizeof(uint32_t));
            *tcl = consts.tcw[base + d][0];
            *tcr = consts.tcw[base + d][1];
          },
          [&](int c, const uint32_t* s, uint32_t t) {
            const size_t lw = head_words(g, r, c) + warp;
            out_t[q * w + lw] |= t << lane;
            for (int k = 0; k < 8; ++k)
              for (int i = 0; i < 16; ++i)
                out_s[((size_t)q * 128 + k * 16 + i) * w + lw] |=
                    ((s[i >> 2] >> (8 * (i & 3) + k)) & 1u) << lane;
          });
    }
  }
}

}  // namespace

// Same operands and outputs as pir_compat_head in compat_stage.cu; the
// outputs are zeroed here first. Returns 0, or 1 for levels the kernel
// does not take.
extern "C" int pir_compat_head_host(const uint32_t* seeds, const uint32_t* t,
                                    const uint32_t* cw_s, const uint32_t* cw_tl,
                                    const uint32_t* cw_tr, const uint32_t* rk, uint32_t* out_s,
                                    uint32_t* out_t, int q_n, int d, int prefix, int path,
                                    int split) {
  const HeadArgs a{seeds, t, cw_s, cw_tl, cw_tr, rk, d, prefix, path, split};
  if (split < 5 || prefix < 0 || prefix + split > d || prefix + split > kMaxHeadLevels) return 1;
  const size_t words = (size_t)q_n << (split - 5);
  std::memset(out_s, 0, sizeof(uint32_t) * words * 128);
  std::memset(out_t, 0, sizeof(uint32_t) * words);
  run_head(a, q_n, out_s, out_t);
  return 0;
}

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
