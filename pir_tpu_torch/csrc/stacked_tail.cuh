// Per-thread pieces of the stacked tail kernel (stacked_tail.cu): the
// fixed-key MMO PRG and the DPF child step over the per-bank AES table of
// aes_lanes.cuh, the warp transpose that moves bit planes into lanes, and
// the depth-first walk of a head node's tail subtree. The compat stage
// (compat_stage.cuh) and the per-query tail (fast_tail.cuh) share them.
// Kept apart from the kernels so that a host compiler can exercise the
// same functions; a warp's shuffles run there as a lockstep model of its
// 32 lanes.
//
// Block convention: a 16-byte AES block is 4 little-endian 32-bit words,
// word c = bytes 4c..4c+3 = state column c (byte i is row i % 4, column
// i / 4, as in FIPS-197). Round keys are 44 words in the same packing.

#pragma once

#include <cstddef>
#include <cstdint>

#include "aes_lanes.cuh"

namespace pir_tail {

// Matyas-Meyer-Oseas: AES_k(x) ^ x.
__device__ __forceinline__ void mmo(const AesLanes& tb, const uint32_t* rk, const uint32_t x[4],
                                    uint32_t out[4]) {
  aes128(tb, rk, x, out);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] ^= x[i];
}

// The PRG children of seed st, before the DPF correction
// (dpf/client.go:99-116): left sL = block 0 and tL = block 1 byte 0 bit 0;
// right sR = block 1 bytes 1..15 ++ block 2 byte 0 and tR = block 2
// byte 1 bit 0. Block 1 serves both, so one child costs two AES blocks
// and both cost three. keys = the three tree keys, 44 words each.
__device__ __forceinline__ void prg_children(const AesLanes& tb, const uint32_t* keys,
                                             const uint32_t st[4], bool want_left,
                                             bool want_right, uint32_t sl[4], uint32_t* tl,
                                             uint32_t sr[4], uint32_t* tr) {
  uint32_t b1[4];
  mmo(tb, keys + 44, st, b1);
  if (want_left) {
    mmo(tb, keys, st, sl);
    *tl = b1[0] & 1u;
  }
  if (want_right) {
    uint32_t b2[4];
    mmo(tb, keys + 88, st, b2);
    sr[0] = __funnelshift_r(b1[0], b1[1], 8);
    sr[1] = __funnelshift_r(b1[1], b1[2], 8);
    sr[2] = __funnelshift_r(b1[2], b1[3], 8);
    sr[3] = __funnelshift_r(b1[3], b2[0], 8);
    *tr = (b2[0] >> 8) & 1u;
  }
}

// The DPF correction of one child of a parent with t bit t_parent:
// seed ^= cw & -t_parent, t ^= t_parent & tcw (tcw = the level's tL or
// tR correction bit).
__device__ __forceinline__ void correct_child(uint32_t s[4], uint32_t* t, const uint32_t cw[4],
                                              uint32_t t_parent, uint32_t tcw) {
  const uint32_t tmask = 0u - t_parent;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] ^= cw[i] & tmask;
  *t ^= t_parent & tcw;
}

// Bit planes to lanes. A warp's 32 threads are the 32 bit positions of
// one lane word, and 128 plane words (bit k, byte i) hold their blocks.
// For block word c, lane l loads plane word (bit l % 8, byte 4c + l / 8),
// whose bits belong in bit 8 (l / 8) + l % 8 of word c of every lane's
// block; a 32 x 32 warp transpose then leaves lane j with its word c.
// Word (bit k, byte i) sits at p[k * bit_stride + i * byte_stride].
__device__ __forceinline__ size_t plane_offset(int lane, int c, size_t bit_stride,
                                               size_t byte_stride) {
  return (size_t)(lane & 7) * bit_stride + (size_t)(4 * c + (lane >> 3)) * byte_stride;
}

// One of the five exchanges of the 32 x 32 bit transpose across a warp
// (Hacker's Delight transpose32, the block swaps done by shuffles): x is
// this lane's word, y the word of lane ^ (16 >> r). After all five, lane
// l holds the word whose bit j is bit l of lane j's x.
__device__ __forceinline__ uint32_t transpose_step(uint32_t x, uint32_t y, int lane, int r) {
  const uint32_t lo[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
  const int s = 16 >> r;
  return (lane & s) ? ((x & ~lo[r]) | ((y >> s) & lo[r])) : ((x & lo[r]) | ((y & lo[r]) << s));
}

#ifdef __CUDACC__

__device__ __forceinline__ uint32_t warp_transpose(uint32_t x, int lane) {
#pragma unroll
  for (int r = 0; r < 5; ++r)
    x = transpose_step(x, __shfl_xor_sync(0xFFFFFFFFu, x, 16 >> r), lane, r);
  return x;
}

// __ballot_sync(full, x & mask), the test written in PTX so that it
// compiles to one predicate-setting LOP3 beside the VOTE (from C++ the
// test comes out as shift, and, compare).
__device__ __forceinline__ uint32_t ballot_mask(uint32_t x, uint32_t mask) {
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\t.reg .b32 m;\n\t"
      "and.b32 m, %1, %2;\n\tsetp.ne.b32 p, m, 0;\n\t"
      "vote.sync.ballot.b32 %0, p, 0xffffffff;\n\t}"
      : "=r"(r) : "r"(x), "r"(mask));
  return r;
}

// The 128 ballots that re-bitslice a warp's blocks o (lane j's block in
// lane j) into plane words: words[bit k * 16 + byte i] gets bit j from
// lane j. Every lane stores the same words (one shared-memory pass each).
__device__ __forceinline__ void ballot_planes(const uint32_t o[4], uint32_t* words) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      words[k * 16 + i] = ballot_mask(o[i >> 2], 1u << (8 * (i & 3) + k));
  }
}

// This lane's block from the warp's 128 plane words: 4 loads a lane
// and 4 transposes (20 shuffles), where a gather of its bit from every
// word would make 128 loads.
__device__ __forceinline__ void warp_unbitslice(const uint32_t* __restrict__ p, size_t bit_stride,
                                                size_t byte_stride, int lane, uint32_t blk[4]) {
  uint32_t x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = p[plane_offset(lane, c, bit_stride, byte_stride)];
#pragma unroll
  for (int c = 0; c < 4; ++c) blk[c] = warp_transpose(x[c], lane);
}

#else

// Host model of warp_transpose: the same exchanges for all 32 lanes in
// lockstep; x[l] is lane l's word.
inline void transpose_lockstep(uint32_t x[32]) {
  uint32_t y[32];
  for (int r = 0; r < 5; ++r) {
    for (int l = 0; l < 32; ++l) y[l] = x[l ^ (16 >> r)];
    for (int l = 0; l < 32; ++l) x[l] = transpose_step(x[l], y[l], l, r);
  }
}

// Host model of warp_unbitslice: the same loads and exchanges for all 32
// lanes in lockstep; blk[l] is lane l's block.
inline void unbitslice_lockstep(const uint32_t* p, size_t bit_stride, size_t byte_stride,
                                uint32_t blk[32][4]) {
  for (int c = 0; c < 4; ++c) {
    uint32_t x[32];
    for (int l = 0; l < 32; ++l) x[l] = p[plane_offset(l, c, bit_stride, byte_stride)];
    transpose_lockstep(x);
    for (int l = 0; l < 32; ++l) blk[l][c] = x[l];
  }
}

#endif  // __CUDACC__

constexpr int kMaxTail = 16;  // stacked tail levels a launch walks

// Operands of one launch, laid out as the TPU kernel's (uint32 words):
// seeds (S,8,1,16,W), t (S,1,1,W), cw_s (S,tail,8,16,W),
// cw_tl / cw_tr (S,tail,1,W), fcw (S,8,n_blk,16,W),
// out (S,8,(1<<tail)*n_blk,16,W).
struct TailArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* cw_s;
  const uint32_t* cw_tl;
  const uint32_t* cw_tr;
  const uint32_t* fcw;
  int w;
  int tail;
  int n_blk;
};

// Every leaf of the `tail`-level subtree below a head node with seed st
// and t bit t, depth first: leaf(c, seed, t) for c = 0 .. 2^tail - 1,
// its branches MSB first (the output's chunk order). Each node is
// expanded once, 2^tail - 1 expansions of three AES blocks (the right
// child waits on a stack of one node per level). cw(l, blk, &tl, &tr)
// gives this lane's seed correction word and tL / tR bits of level l;
// it is called before each expansion, by every lane of a warp at once.
// keys = the three tree keys, 44 words each. The loops are not unrolled,
// so a kernel holds one copy of the PRG; the stack lives in local memory.
template <class Cw, class Leaf>
__device__ __forceinline__ void for_each_tail_leaf(const AesLanes& tb, const uint32_t* keys,
                                                   int tail, uint32_t st[4], uint32_t t,
                                                   Cw&& cw, Leaf&& leaf) {
  uint32_t sib[kMaxTail][4], tsib[kMaxTail];
  const int n = 1 << tail;
  int d = 0;
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
#pragma unroll 1
    for (; d < tail; ++d) {
      uint32_t cwb[4], tcl, tcr, sl[4], tl, sr[4], tr;
      cw(d, cwb, &tcl, &tcr);
      prg_children(tb, keys, st, true, true, sl, &tl, sr, &tr);
      correct_child(sl, &tl, cwb, t, tcl);
      correct_child(sr, &tr, cwb, t, tcr);
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
      const int lvl = tail - __ffs(~c);
#pragma unroll
      for (int i = 0; i < 4; ++i) st[i] = sib[lvl][i];
      t = tsib[lvl];
      d = lvl + 1;
    }
  }
}

// Leaf CTR block b of a leaf seed, before the t & fcw correction: MMO of
// seed ^ LE64(b) under the leaf key.
__device__ __forceinline__ void leaf_mmo(const AesLanes& tb, const uint32_t* leaf_key,
                                         const uint32_t st[4], int b, uint32_t o[4]) {
  const uint32_t x[4] = {st[0] ^ (uint32_t)b, st[1], st[2], st[3]};
  mmo(tb, leaf_key, x, o);
}

// Round-key byte `rb` (round * 16 + byte) of key `key` (0..2 tree, 3
// leaf) from the 0/~0 mask operands, bit 0 of each mask word:
// rk (11,8,3,16,1) shared or (S,11,8,3,16,W) per lane, rk_leaf
// (11,8,16,1) or (S,11,8,16,W); rk_lanes = 1 or W.
__device__ __forceinline__ uint32_t key_byte(const uint32_t* __restrict__ rk,
                                             const uint32_t* __restrict__ rk_leaf,
                                             int rk_lanes, int s, int lane_word,
                                             int key, int rb) {
  const int r = rb / 16, byte = rb % 16;
  const bool per_lane = rk_lanes != 1;
  const size_t lanes = (size_t)rk_lanes;
  uint32_t v = 0;
  for (int bit = 0; bit < 8; ++bit) {
    uint32_t m;
    if (key < 3) {
      const size_t base = per_lane ? (size_t)s * 11 * 8 * 3 * 16 * lanes : 0;
      m = rk[base + ((size_t)((r * 8 + bit) * 3 + key) * 16 + byte) * lanes +
             (per_lane ? lane_word : 0)];
    } else {
      const size_t base = per_lane ? (size_t)s * 11 * 8 * 16 * lanes : 0;
      m = rk_leaf[base + ((size_t)(r * 8 + bit) * 16 + byte) * lanes +
                  (per_lane ? lane_word : 0)];
    }
    v |= (m & 1u) << bit;
  }
  return v;
}

}  // namespace pir_tail
