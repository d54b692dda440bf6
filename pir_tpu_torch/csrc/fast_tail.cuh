// Per-thread pieces of the per-query fast tail kernel (fast_tail.cu,
// also run by fused_scan_expand.cu's tail items): the per-query constants
// a block rebuilds into shared memory, where a warp's head seeds lie, the
// walk down to a thread's node and the depth-first walk of its subtree,
// and where each output word is staged. Kept apart from the kernels so
// that a host compiler can exercise the same functions
// (fast_tail_host.cpp); the block-level code (staging, stores) follows
// under __CUDACC__. AES (the per-bank table of aes_lanes.cuh), the PRG,
// the DPF child step and the warp transpose come from stacked_tail.cuh.
//
// Geometry. The TPU kernel doubles each query's NW0 lane words `levels`
// times by concatenating [left | right], so a level's branch is the most
// significant lane bit so far: after the walk, head node (word w0, bit
// j) with branches b_0 .. b_{L-1} sits at word w0 + NW0 * sum b_l 2^l,
// bit j. Here one thread owns one node `split` levels below the head:
// thread-grid word w' = w0 + NW0 * r in [0, WT = NW0 << split), bit j,
// where r holds the first `split` branches (level l = bit l of r). The
// thread walks down to that node expanding only the child it wants (two
// AES blocks a level), then expands its subtree depth first, each node
// once, and its leaf c (branches MSB first) lands on word
// w' + WT * bit_reverse(c, levels - split). split is the least number of
// levels that makes WT >= kLanesPerBlock (or all of them), so a block's
// kLanesPerBlock warps hold consecutive words of one query and store
// 32-byte runs; the walk down costs 2 * split blocks a thread, against
// the even share (which one thread per head node would reach, at the
// price of 4-byte store runs): at the serving shape (NW0 = 1, split 3,
// 2 levels below, 8 leaf blocks) 47 blocks a thread against 43.6.

#pragma once

#include <cstdint>

#include "stacked_tail.cuh"

namespace pir_fast {

using pir_tail::AesLanes;

constexpr int kMaxLevels = 16;    // tail levels (ops/fast_tail.py MAX_LEVELS)
constexpr int kLanesPerBlock = 8;  // lane words per block, one warp each
constexpr int kKeys = 4;           // three tree PRF keys + the leaf key
constexpr int kKeyWords = 44;      // 11 round keys x 4 words
constexpr int kKeyBytes = 4 * kKeyWords;
constexpr int kFcwBlocks = 8;      // leaf CTR blocks whose fcw words sit in shared memory
constexpr int kStageStride = 164;  // words a warp's staged block: 4 (mod 32) spreads the banks

// Operands of one launch, laid out as the TPU kernel's (uint32 words):
// seeds (Q,8,16,NW0), t (Q,1,NW0), cw_s (Q,L,8,16,1), cw_tl / cw_tr
// (Q,L), fcw (Q,8,n_blk,16,1), rk (11,8,3,16,1) and rk_leaf (11,8,16,1)
// shared, or (Q,11,8,3,16,1) and (Q,11,8,16,1) with rk_per_query;
// out (Q,8,16,n_blk * NWf), NWf = NW0 << L. The last four fields come
// from init_geometry.
struct FastTailArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* cw_s;
  const uint32_t* cw_tl;
  const uint32_t* cw_tr;
  const uint32_t* rk;
  const uint32_t* fcw;
  const uint32_t* rk_leaf;
  int q_n;
  int nw0;
  int levels;
  int n_blk;
  int rk_per_query;
  int split;   // levels walked down to a thread's node
  int wt;      // NW0 << split: lane words of the thread grid
  int groups;  // blocks per query: ceil(wt / kLanesPerBlock)
  int nwf;     // NW0 << levels
};

__host__ __device__ inline void init_geometry(FastTailArgs& a) {
  a.split = 0;
  while (a.split < a.levels && (a.nw0 << a.split) < kLanesPerBlock) ++a.split;
  a.wt = a.nw0 << a.split;
  a.groups = (a.wt + kLanesPerBlock - 1) / kLanesPerBlock;
  a.nwf = a.nw0 << a.levels;
}

__host__ __device__ inline int bit_reverse(int c, int n) {
  int r = 0;
  for (int i = 0; i < n; ++i) r |= ((c >> i) & 1) << (n - 1 - i);
  return r;
}

// One query's constants: its three tree keys and its leaf key (44 words
// each, 16-byte aligned for aes128's uint4 reads), each tail level's
// seed correction word as a block, its tL / tR bits, and the fcw words of
// its first kFcwBlocks leaf CTR blocks, [block][byte][bit] so that a
// warp's 32 reads of one transposed word (8 bits x 4 bytes) hit 32 banks.
struct QueryConsts {
  alignas(16) uint32_t keys[kKeys][kKeyWords];
  uint32_t cw[kMaxLevels][4];
  uint32_t tcw[kMaxLevels][2];
  uint32_t fcw[8 * kFcwBlocks * 16];
};

constexpr int kQueryItems =
    kKeys * kKeyBytes + kMaxLevels * 16 + kMaxLevels * 2 + 8 * kFcwBlocks * 16;

// Item idx of query q's constants, idx < kQueryItems: a round-key byte,
// a correction-word byte, a tL / tR bit or an fcw word. Every mask
// operand is 0 / ~0; its bit 0 is read.
__device__ __forceinline__ void fill_query(QueryConsts& k, const FastTailArgs& a, int q,
                                           int idx) {
  if (idx < kKeys * kKeyBytes) {
    const size_t rk_off = a.rk_per_query ? (size_t)q * 11 * 8 * 3 * 16 : 0;
    const size_t rkl_off = a.rk_per_query ? (size_t)q * 11 * 8 * 16 : 0;
    reinterpret_cast<uint8_t*>(k.keys[idx / kKeyBytes])[idx % kKeyBytes] =
        static_cast<uint8_t>(pir_tail::key_byte(a.rk + rk_off, a.rk_leaf + rkl_off, 1, 0, 0,
                                                idx / kKeyBytes, idx % kKeyBytes));
    return;
  }
  idx -= kKeys * kKeyBytes;
  if (idx < kMaxLevels * 16) {
    const int l = idx / 16, byte = idx % 16;
    if (l < a.levels) {
      uint32_t v = 0;
      for (int bit = 0; bit < 8; ++bit)
        v |= (a.cw_s[(((size_t)q * a.levels + l) * 8 + bit) * 16 + byte] & 1u) << bit;
      reinterpret_cast<uint8_t*>(k.cw[l])[byte] = static_cast<uint8_t>(v);
    }
    return;
  }
  idx -= kMaxLevels * 16;
  if (idx < kMaxLevels * 2) {
    const int l = idx / 2, side = idx % 2;
    if (l < a.levels) k.tcw[l][side] = (side ? a.cw_tr : a.cw_tl)[(size_t)q * a.levels + l] & 1u;
    return;
  }
  idx -= kMaxLevels * 2;
  const int b = idx / 128, byte = idx / 8 % 16, bit = idx % 8;
  if (b < a.n_blk) k.fcw[idx] = a.fcw[(((size_t)q * 8 + bit) * a.n_blk + b) * 16 + byte];
}

// fcw word (bit, CTR block b, byte) of query q: from the query's
// constants for the first kFcwBlocks blocks, else from the operand.
__device__ __forceinline__ uint32_t fcw_word(const QueryConsts& k, const FastTailArgs& a, int q,
                                             int bit, int b, int byte) {
  return b < kFcwBlocks ? k.fcw[(b * 16 + byte) * 8 + bit]
                        : a.fcw[(((size_t)q * 8 + bit) * a.n_blk + b) * 16 + byte];
}

// The 128 plane words (bit k, byte i) of head lane word w0 < NW0 of
// query q: word (k, i) at head_planes(...)[k * 16 NW0 + i * NW0].
__device__ __forceinline__ const uint32_t* head_planes(const FastTailArgs& a, int q, int w0) {
  return a.seeds + (size_t)q * 128 * a.nw0 + w0;
}

// From head node st / t, walk the first a.split levels along the branches
// of `path` (level l = bit l), expanding only the wanted child, then
// every leaf of the subtree below, depth first: leaf(c, seed, t) for
// c = 0 .. 2^(levels - split) - 1, its branches MSB first. Each subtree
// node is expanded once (the right child waits on a stack of one node per
// level), 2^(levels - split) - 1 expansions of three blocks after the
// split walk's 2 a level. The loops are not unrolled, so a kernel holds
// one copy of the PRG; the stack lives in local memory.
template <class Leaf>
__device__ __forceinline__ void for_each_leaf(const FastTailArgs& a, const AesLanes& tb,
                                              const QueryConsts& k, int path, uint32_t st[4],
                                              uint32_t t, Leaf&& leaf) {
  const uint32_t* keys = &k.keys[0][0];
#pragma unroll 1
  for (int d = 0; d < a.split; ++d) {
    const bool right = (path >> d) & 1;
    uint32_t s[4], ts;
    pir_tail::prg_children(tb, keys, st, !right, right, s, &ts, s, &ts);
    pir_tail::correct_child(s, &ts, k.cw[d], t, k.tcw[d][right]);
#pragma unroll
    for (int i = 0; i < 4; ++i) st[i] = s[i];
    t = ts;
  }
  uint32_t sib[kMaxLevels][4], tsib[kMaxLevels];
  const int n = 1 << (a.levels - a.split);
  int d = a.split;
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
#pragma unroll 1
    for (; d < a.levels; ++d) {
      uint32_t sl[4], tl, sr[4], tr;
      pir_tail::prg_children(tb, keys, st, true, true, sl, &tl, sr, &tr);
      pir_tail::correct_child(sl, &tl, k.cw[d], t, k.tcw[d][0]);
      pir_tail::correct_child(sr, &tr, k.cw[d], t, k.tcw[d][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[i] = sl[i];
        sib[d][i] = sr[i];
      }
      t = tl;
      tsib[d] = tr;
    }
    leaf(c, st, t);
    if (c + 1 < n) {  // c's trailing ones end at the level whose branch turns right
      const int lvl = a.levels - __ffs(~c);
#pragma unroll
      for (int i = 0; i < 4; ++i) st[i] = sib[lvl][i];
      t = tsib[lvl];
      d = lvl + 1;
    }
  }
}

// Lane l's word of transposed block word c4 is output row (bit l % 8,
// byte 4 c4 + l / 8), row = bit * 16 + byte.
__host__ __device__ inline int stage_row(int lane, int c4) {
  return (lane & 7) * 16 + 4 * c4 + (lane >> 3);
}

// Word index of output row `row` in a warp's staged block: bit * 20 +
// byte, so the 32 lanes' stores of one transposed word (8 bits x 4
// bytes) hit 32 banks.
__host__ __device__ inline int stage_index(int row) { return (row >> 4) * 20 + (row & 15); }

#ifdef __CUDACC__

constexpr int kThreads = 32 * kLanesPerBlock;

struct TailShared {
  pir_tail::AesLaneTable table;
  QueryConsts consts;
  uint32_t stage[2][kLanesPerBlock][kStageStride];  // double-buffered: one barrier a block
};
static_assert(sizeof(TailShared) <= 48 * 1024, "fast_tail.cu holds TailShared statically");

// One block's work: query q, thread-grid lane words grp * kLanesPerBlock
// + warp, every leaf of their subtrees and every CTR block, written to
// out. A warp's 32 threads are the 32 bit positions of one lane word:
// their head seeds arrive as 4 plane loads a lane and a warp transpose,
// and a warp transpose turns their leaf blocks into the 128 output words
// (bit k, byte i), corrected by t & fcw on the words as the TPU kernel
// does on its planes. The warps stage each CTR block's words in one of
// two buffers, the block takes one barrier, and each thread stores 4
// words from it: 8 consecutive lane words, a 32-byte run a row.
__device__ __forceinline__ void tail_block(const FastTailArgs& a, int q, int grp, TailShared& sh,
                                           uint32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = tid; i < 2048; i += kThreads) pir_tail::fill_lane_table(sh.table, i);
  for (int i = tid; i < kQueryItems; i += kThreads) fill_query(sh.consts, a, q, i);

  const int w0b = grp * kLanesPerBlock;
  // warps past the last lane word walk a copy of it and store nothing
  const int word = min(w0b + warp, a.wt - 1);
  uint32_t st[4];
  pir_tail::warp_unbitslice(head_planes(a, q, word % a.nw0), 16 * (size_t)a.nw0, a.nw0, lane,
                            st);
  const uint32_t t = (a.t[(size_t)q * a.nw0 + word % a.nw0] >> lane) & 1u;
  __syncthreads();

  const AesLanes T = pir_tail::lanes_of(sh.table, lane);
  const QueryConsts& k = sh.consts;
  // the block stores 4 staged words a thread: lane word li, rows
  // r0 + 32 m (m < 4)
  static_assert(128 * kLanesPerBlock == 4 * kThreads, "4 staged words a thread");
  const int li = tid % kLanesPerBlock;
  const int r0 = tid / kLanesPerBlock;
  const bool store = w0b + li < a.wt;
  const size_t nwtot = (size_t)a.n_blk * a.nwf;
  uint32_t* out_t = out + ((size_t)q * 128 + r0) * nwtot + w0b + li;
  const int sub = a.levels - a.split;
  int buf = 0;
  for_each_leaf(a, T, k, word / a.nw0, st, t, [&](int c, const uint32_t* ls, uint32_t lt) {
    const uint32_t tword = __ballot_sync(0xFFFFFFFFu, lt);
    const size_t col = (size_t)a.wt * bit_reverse(c, sub);
#pragma unroll 1
    for (int b = 0; b < a.n_blk; ++b) {
      uint32_t o[4];
      pir_tail::leaf_mmo(T, k.keys[3], ls, b, o);
      uint32_t* stage = sh.stage[buf][warp];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int row = stage_row(lane, c4);
        stage[stage_index(row)] = pir_tail::warp_transpose(o[c4], lane) ^
                                  (tword & fcw_word(k, a, q, row >> 4, b, row & 15));
      }
      __syncthreads();
      if (store) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          out_t[(size_t)32 * m * nwtot + (size_t)b * a.nwf + col] =
              sh.stage[buf][li][stage_index(r0 + 32 * m)];
      }
      buf ^= 1;
    }
  });
}

#endif  // __CUDACC__

}  // namespace pir_fast
