// Per-thread pieces of the per-query fast tail kernel (fast_tail.cu,
// also run by fused_scan_expand.cu): the per-query constants a block
// rebuilds into shared memory, a thread's root node, and the depth-first
// walk of its subtree, each node expanded once. Kept apart from the
// kernels so that a host compiler can exercise the same functions
// (fast_tail_host.cpp); the block-level code (staging, stores) follows
// under __CUDACC__. AES, the PRG, the DPF child step and the warp
// transpose come from stacked_tail.cuh.
//
// Geometry. The TPU kernel doubles each query's NW0 lane words `levels`
// times by concatenating [left | right], so a level's branch is the most
// significant lane bit so far: after the walk, head node (word w0, bit
// j) with branches b_0 .. b_{L-1} sits at word w0 + NW0 * sum b_l 2^l,
// bit j. Here one thread owns one node `split` levels below the head:
// thread-grid word w' = w0 + NW0 * r in [0, WT = NW0 << split), bit j,
// where r holds the first `split` branches (level l = bit l of r). The
// thread expands its subtree depth-first and its leaf c (branches MSB
// first) lands on word w' + WT * bit_reverse(c, levels - split). split
// is the least number of levels that makes WT >= kLanesPerBlock (or all
// of them), so a block's kLanesPerBlock warps hold consecutive words of
// one query and store 32-byte runs; the few extra node walks of the split
// levels (one per level and thread) also spread a query with NW0 = 1
// over 8 warps instead of 1.

#pragma once

#include <cstdint>

#include "stacked_tail.cuh"

namespace pir_fast {

using pir_tail::AesTables;

constexpr int kMaxLevels = 16;    // tail levels (ops/fast_tail.py MAX_LEVELS)
constexpr int kLanesPerBlock = 8;  // lane words per block, one warp each
constexpr int kKeys = 4;           // three tree PRF keys + the leaf key
constexpr int kKeyWords = 44;      // 11 round keys x 4 words
constexpr int kKeyBytes = 4 * kKeyWords;

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
// each), each tail level's seed correction word as a block, and its tL /
// tR bits.
struct QueryConsts {
  uint32_t keys[kKeys][kKeyWords];
  uint32_t cw[kMaxLevels][4];
  uint32_t tcw[kMaxLevels][2];
};

constexpr int kQueryItems = kKeys * kKeyBytes + kMaxLevels * 16 + kMaxLevels * 2;

// Item idx of query q's constants, idx < kQueryItems: a round-key byte,
// a correction-word byte or a tL / tR bit. Every mask operand is 0 / ~0;
// its bit 0 is read.
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
  const int l = idx / 2, side = idx % 2;
  if (l < a.levels) k.tcw[l][side] = (side ? a.cw_tr : a.cw_tl)[(size_t)q * a.levels + l] & 1u;
}

// Head node (query q, lane word w0 < NW0, bit position lane): its seed
// and t bit.
__device__ __forceinline__ void head_node(const FastTailArgs& a, int q, int w0, int lane,
                                          uint32_t st[4], uint32_t* t) {
  const size_t nw = (size_t)a.nw0;
  pir_tail::gather_block(a.seeds + (size_t)q * 128 * nw + w0, 16 * nw, nw, lane, st);
  *t = (a.t[(size_t)q * nw + w0] >> lane) & 1u;
}

// Both corrected children of a node at tail level `level`.
__device__ __forceinline__ void expand_node(const AesTables& tb, const QueryConsts& k, int level,
                                            const uint32_t st[4], uint32_t t, uint32_t sl[4],
                                            uint32_t* tl, uint32_t sr[4], uint32_t* tr) {
  pir_tail::prg_children(tb, &k.keys[0][0], st, true, true, sl, tl, sr, tr);
  pir_tail::correct_child(sl, tl, k.cw[level], t, k.tcw[level][0]);
  pir_tail::correct_child(sr, tr, k.cw[level], t, k.tcw[level][1]);
}

// From head node st / t, walk the first a.split levels along the branches
// of `path` (level l = bit l), then every leaf of the subtree below,
// depth first: leaf(c, seed, t) for c = 0 .. 2^(levels - split) - 1, its
// branches MSB first. Each node is expanded once (the right child waits
// on a stack of one node per level), 2^(levels - split) - 1 expansions
// plus the split walk. The loops are not unrolled, so a kernel holds one
// copy of the PRG; the stack lives in local memory.
template <class Leaf>
__device__ __forceinline__ void for_each_leaf(const FastTailArgs& a, const AesTables& tb,
                                              const QueryConsts& k, int path, uint32_t st[4],
                                              uint32_t t, Leaf&& leaf) {
  uint32_t sib[kMaxLevels][4], tsib[kMaxLevels];
  const int n = 1 << (a.levels - a.split);
  int d = 0;
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
#pragma unroll 1
    for (; d < a.levels; ++d) {
      uint32_t sl[4], tl, sr[4], tr;
      expand_node(tb, k, d, st, t, sl, &tl, sr, &tr);
      const bool right = d < a.split && ((path >> d) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[i] = right ? sr[i] : sl[i];
        sib[d][i] = sr[i];
      }
      t = right ? tr : tl;
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

// Leaf CTR block b of a leaf seed, before the t & fcw correction: MMO of
// seed ^ LE64(b) under the leaf key.
__device__ __forceinline__ void leaf_mmo(const AesTables& tb, const QueryConsts& k,
                                         const uint32_t st[4], int b, uint32_t o[4]) {
  const uint32_t x[4] = {st[0] ^ (uint32_t)b, st[1], st[2], st[3]};
  pir_tail::mmo(tb, k.keys[3], x, o);
}

#ifdef __CUDACC__

constexpr int kThreads = 32 * kLanesPerBlock;

struct TailShared {
  AesTables tables;
  QueryConsts consts;
  uint32_t stage[kLanesPerBlock][128];
  uint32_t stage_t[kLanesPerBlock];
};

// One block's work: query q, thread-grid lane words grp * kLanesPerBlock
// + warp, every leaf of their subtrees and every CTR block, written to
// out. A warp's 32 threads are the 32 bit positions of one lane word, so
// a warp transpose turns their leaf blocks into the 128 output words
// (bit k, byte i); the t & fcw correction is applied to the words, as
// the TPU kernel does on its planes. The block stages its 8 lane words'
// words in shared memory and stores 32-byte runs.
__device__ __forceinline__ void tail_block(const FastTailArgs& a, int q, int grp, TailShared& sh,
                                           uint32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = tid; i < 256; i += kThreads) pir_tail::fill_tables(sh.tables, i);
  for (int i = tid; i < kQueryItems; i += kThreads) fill_query(sh.consts, a, q, i);
  __syncthreads();

  const int w0b = grp * kLanesPerBlock;
  // warps past the last lane word walk a copy of it and store nothing
  const int word = min(w0b + warp, a.wt - 1);
  uint32_t st[4], t;
  head_node(a, q, word % a.nw0, lane, st, &t);
  const size_t nwtot = (size_t)a.n_blk * a.nwf;
  const int sub = a.levels - a.split;
  const uint32_t* fcw_q = a.fcw + (size_t)q * 8 * a.n_blk * 16;
  uint32_t* out_q = out + (size_t)q * 128 * nwtot;
  for_each_leaf(a, sh.tables, sh.consts, word / a.nw0, st, t,
                [&](int c, const uint32_t* ls, uint32_t lt) {
    const size_t base = (size_t)w0b + (size_t)a.wt * bit_reverse(c, sub);
    const uint32_t tword = __ballot_sync(0xFFFFFFFFu, lt);
    if (lane == 0) sh.stage_t[warp] = tword;
#pragma unroll 1
    for (int b = 0; b < a.n_blk; ++b) {
      uint32_t o[4];
      leaf_mmo(sh.tables, sh.consts, ls, b, o);
      // lane l of transposed word c4 is output word (bit l % 8, byte 4 c4 + l / 8)
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4)
        sh.stage[warp][(lane & 7) * 16 + 4 * c4 + (lane >> 3)] =
            pir_tail::warp_transpose(o[c4], lane);
      __syncthreads();
      for (int idx = tid; idx < 128 * kLanesPerBlock; idx += kThreads) {
        const int row = idx / kLanesPerBlock;  // bit * 16 + byte
        const int li = idx % kLanesPerBlock;
        if (w0b + li < a.wt) {
          const uint32_t f = fcw_q[((size_t)(row >> 4) * a.n_blk + b) * 16 + (row & 15)];
          out_q[(size_t)row * nwtot + (size_t)b * a.nwf + base + li] =
              sh.stage[li][row] ^ (sh.stage_t[li] & f);
        }
      }
      __syncthreads();
    }
  });
}

#endif  // __CUDACC__

}  // namespace pir_fast
