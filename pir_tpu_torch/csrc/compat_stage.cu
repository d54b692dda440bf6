// One stage of the reference-exact (compat) DPF expansion cascade: every
// (query, chunk, lane word, bit position) node walks `tail` tree levels
// below it; the last stage turns each leaf into its PIR selection bit.
//
// Replaces the TPU kernel pir_tpu/ops/pallas_expand.py:
// compat_stage_pallas (_compat_stage_kernel, _varint_parity_packed).
// Same operands and the same outputs: with emit_bits off, the 2^tail
// children's seeds (Q,8,NC<<tail,16,W) and t bits (Q,NC<<tail,1,W) as
// bit planes, output chunk = input chunk * 2^tail + the stage's branch
// bits, first level most significant; with emit_bits on, packed
// selection words (Q,NC<<tail,1,W), bit = ~((parity & ~allcont) ^
// (t & fcw)), the Go-varint parity under db.go:142's inverted convention.
//
// What bounds it on an H100: AES. A node costs three AES-128 blocks
// (the MMO PRG under the query's three tree keys) and there is no AES
// unit, so at the serving shape (2^20 leaves, stages of 3, 3, 2 levels)
// a query's ~1.04e6 node expansions, ~3.1e6 blocks at ~440 int32
// operations each (PERF.md), outweigh its bytes: the stage-2 seed planes
// (4 MiB a query) move in ~1.3 us at 3.35 TB/s against ~80 us of
// operations at 16.75 Tops/s.
//
// Design: one thread per node. It un-bitslices its 128-bit seed from the
// input planes (4 loads a lane and a warp transpose), expands its whole
// 2^tail-leaf subtree in local memory (the minimum 2^tail - 1
// expansions, no ancestor recomputed; the loops are not unrolled, so
// each kernel holds one copy of the PRG and nvcc builds it in seconds),
// and re-bitslices with __ballot_sync: a warp's 32 threads are the 32
// bit positions of one lane word, so a ballot per (bit, byte) plane is
// one output word. AES is byte-oriented with the per-bank T-table of
// aes_lanes.cuh (lane j reads bank j: one shared-memory pass a lookup);
// each block rebuilds its query's three tree keys, correction words and
// t bits from the mask operands into shared memory once. Seed outputs
// are staged in shared memory and written as 32-byte runs.
//
// The second entry, compat_head_kernel, walks the head that feeds the
// first stage. It replaces no Pallas kernel: on the TPU the same walk is
// jnp under XLA's fusion (pir_tpu/models/pipeline.py:583-632,
// _compat_skip_walk and fused_compat_root_batch*_fn, with
// pir_tpu/dpf/device.py expand_planes_from_root), which eager torch
// cannot fuse: there every bitsliced gate was a launch of its own, ~17,000
// a 1,024-query batch. Per query it walks the one-child prefix (the dead
// skip levels, all left, then a mesh shard's path bits) and expands the
// split = 5 + log2(w) root-start levels in full, leaving the first stage's
// input planes: seeds (Q,8,1,16,W) and t (Q,1,1,W), node order as
// expand_planes_from_root leaves it (first 5 levels' branches in the
// word's bits, later ones in the lane word). What bounds it on an H100:
// AES again. At the serving shape (Q 1,024, w 128, skip 1) a batch is
// 12.58 M blocks, 0.27 ms at 356 integer operations a block at 16.75
// Tops/s, against 64.5 MiB of output planes, 0.02 ms at 3.35 TB/s. Design:
// one block a query, 2^g warps (g <= 3). The block expands the first
// 5 + g levels breadth first in shared memory (level l by its first 2^l
// threads) until each thread holds one node; thread (warp v, lane j)
// holds the node whose first 5 branches are j and next g are v, so the
// lanes of a warp are the bits of one output word. Each thread then walks
// its r = split - 5 - g level subtree depth first in registers
// (for_each_tail_leaf, 2^r - 1 expansions, none repeated) and at every
// leaf the warps re-bitslice with __ballot_sync; the block's 2^g warps
// hold 2^g adjacent lane words, which it stores as runs of 2^g words a
// plane. The breadth-first levels leave threads idle (3 AES blocks of
// latency a level); the depth-first part is ~95% of the blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "compat_stage.cuh"

namespace {

using pir_compat::CompatArgs;
using pir_compat::QueryConsts;

constexpr int kLanesPerBlock = 8;  // lane words per block, one warp each
constexpr int kThreads = 32 * kLanesPerBlock;

template <bool EMIT>
__global__ void __launch_bounds__(kThreads)
compat_stage_kernel(CompatArgs a, uint32_t* __restrict__ out_s, uint32_t* __restrict__ out_t) {
  __shared__ pir_tail::AesLaneTable table;
  __shared__ QueryConsts consts;
  __shared__ uint32_t stage[kLanesPerBlock][128];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w0 = blockIdx.x * kLanesPerBlock;
  const int chunk = blockIdx.y;
  const int q = blockIdx.z;
  // warps past the last lane word compute a copy of it and store nothing
  const int w = min(w0 + warp, a.w - 1);
  const bool store = w0 + warp < a.w;

  for (int i = tid; i < 2048; i += kThreads) pir_tail::fill_lane_table(table, i);
  for (int i = tid; i < pir_compat::kQueryItems; i += kThreads)
    pir_compat::fill_query(consts, a, q, i);
  __syncthreads();

  const size_t sw = (size_t)a.w;
  uint32_t s[pir_compat::kMaxLeaves][4], t[pir_compat::kMaxLeaves];
  pir_tail::warp_unbitslice(a.seeds + ((size_t)q * 8 * a.nc + chunk) * 16 * sw + w,
                            (size_t)a.nc * 16 * sw, sw, lane, s[0]);
  t[0] = (a.t[((size_t)q * a.nc + chunk) * sw + w] >> lane) & 1u;
  pir_compat::expand_subtree(pir_tail::lanes_of(table, lane), consts, a.tail, s, t);

  const size_t nco = (size_t)a.nc << a.tail;
  // seed outputs: the block stores its 8 lane words' 128 staged words as
  // 4 words a thread: lane word li, rows r0 + 32 m (bit r0 / 16 + 2 m,
  // byte r0 % 16)
  static_assert(128 * kLanesPerBlock == 4 * kThreads, "4 staged words a thread");
  const int li = tid % kLanesPerBlock;
  const int r0 = tid / kLanesPerBlock;
  const bool store_li = w0 + li < a.w;
  const size_t plane = 16 * sw;  // words from one (bit, chunk) plane to the next
  uint32_t* out_li = out_s + ((size_t)q * 8 + (r0 >> 4)) * nco * plane + (size_t)(r0 & 15) * sw +
                     (store_li ? w0 + li : 0);
#pragma unroll 1
  for (int c = 0; c < (1 << a.tail); ++c) {
    const size_t oc = ((size_t)chunk << a.tail) + c;
    if constexpr (EMIT) {
      const uint32_t word =
          __ballot_sync(0xFFFFFFFFu, pir_compat::select_bit(s[c], t[c], consts.fcw));
      if (lane == 0 && store) out_s[((size_t)q * nco + oc) * sw + w] = word;
    } else {
      const uint32_t tword = __ballot_sync(0xFFFFFFFFu, t[c]);
      if (lane == 0 && store) out_t[((size_t)q * nco + oc) * sw + w] = tword;
      pir_tail::ballot_planes(s[c], stage[warp]);
      __syncthreads();
      if (store_li) {
#pragma unroll
        for (int m = 0; m < 4; ++m) out_li[(oc + 2 * m * nco) * plane] = stage[li][r0 + 32 * m];
      }
      __syncthreads();
    }
  }
}

constexpr int kHeadWarps = 1 << pir_compat::kHeadGroupBits;

// One block a query, 32 << head_group_bits(split) threads.
__global__ void __launch_bounds__(32 * kHeadWarps)
compat_head_kernel(pir_compat::HeadArgs a, uint32_t* __restrict__ out_s,
                   uint32_t* __restrict__ out_t) {
  __shared__ pir_tail::AesLaneTable table;
  __shared__ pir_compat::HeadConsts consts;
  __shared__ uint32_t node_s[32 * kHeadWarps][4];
  __shared__ uint32_t node_t[32 * kHeadWarps];
  __shared__ uint32_t stage[kHeadWarps][128];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = blockIdx.x;
  const int g = pir_compat::head_group_bits(a.split);

  for (int i = tid; i < 2048; i += blockDim.x) pir_tail::fill_lane_table(table, i);
  for (int i = tid; i < pir_compat::kHeadItems; i += blockDim.x)
    pir_compat::fill_head(consts, a, q, i);
  __syncthreads();
  const pir_tail::AesLanes tb = pir_tail::lanes_of(table, lane);

  if (tid == 0) {
    uint32_t s[4], t;
    pir_compat::head_root(tb, consts, a, q, s, &t);
#pragma unroll
    for (int i = 0; i < 4; ++i) node_s[0][i] = s[i];
    node_t[0] = t;
  }
  // breadth first: node n of level l (its branches, first level least
  // significant) has children n and n + 2^l
  const int bf = 5 + g;
#pragma unroll 1
  for (int l = 0; l < bf; ++l) {
    const int n = 1 << l;
    const bool act = tid < n;
    uint32_t s[4], t = 0;
    __syncthreads();
    if (act) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = node_s[tid][i];
      t = node_t[tid];
    }
    __syncthreads();
    if (act) {
      uint32_t sl[4], tl, sr[4], tr;
      pir_compat::head_children(tb, consts, a.prefix + l, s, t, true, true, sl, &tl, sr, &tr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        node_s[tid][i] = sl[i];
        node_s[tid + n][i] = sr[i];
      }
      node_t[tid] = tl;
      node_t[tid + n] = tr;
    }
  }
  __syncthreads();
  uint32_t st[4], t0;
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = node_s[tid][i];
  t0 = node_t[tid];

  // depth first below; each leaf's 2^g lane words go out as runs: thread
  // tid stores lane word li = tid % 2^g of plane rows r0 + 32 m
  const int r = a.split - bf;
  const int base = a.prefix + bf;
  const size_t w = (size_t)1 << (a.split - 5);
  const int li = tid & ((1 << g) - 1);
  const int r0 = tid >> g;
  uint32_t* out_q = out_s + (size_t)q * 128 * w;
  pir_tail::for_each_tail_leaf(
      tb, &consts.q.keys[0][0], r, st, t0,
      [&](int d, uint32_t cwb[4], uint32_t* tcl, uint32_t* tcr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) cwb[i] = consts.cw[base + d][i];
        *tcl = consts.tcw[base + d][0];
        *tcr = consts.tcw[base + d][1];
      },
      [&](int c, const uint32_t* s, uint32_t t) {
        const int lw0 = pir_compat::head_words(g, r, c);
        const uint32_t tword = __ballot_sync(0xFFFFFFFFu, t);
        if (lane == 0) out_t[(size_t)q * w + lw0 + warp] = tword;
        pir_tail::ballot_planes(s, stage[warp]);
        __syncthreads();
#pragma unroll
        for (int m = 0; m < 4; ++m)
          out_q[(size_t)(r0 + 32 * m) * w + lw0 + li] = stage[li][r0 + 32 * m];
        __syncthreads();
      });
}

}  // namespace

// Pointers are device addresses of contiguous uint32 (int32) tensors with
// the shapes of CompatArgs; fcw may be null when emit_bits is 0. out_s
// receives the seeds (Q,8,NC<<tail,16,W), or the packed selection words
// (Q,NC<<tail,1,W) when emit_bits is 1; out_t the t bits (Q,NC<<tail,1,W)
// (unused when emit_bits is 1). tail is 1..3.
// Returns cudaGetLastError() after the launch.
extern "C" int pir_compat_stage(const void* seeds, const void* t, const void* cw_s,
                                const void* cw_tl, const void* cw_tr, const void* rk,
                                const void* fcw, void* out_s, void* out_t, int q_n, int nc,
                                int w, int tail, int emit_bits, void* stream) {
  CompatArgs a;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.t = static_cast<const uint32_t*>(t);
  a.cw_s = static_cast<const uint32_t*>(cw_s);
  a.cw_tl = static_cast<const uint32_t*>(cw_tl);
  a.cw_tr = static_cast<const uint32_t*>(cw_tr);
  a.rk = static_cast<const uint32_t*>(rk);
  a.fcw = static_cast<const uint32_t*>(fcw);
  a.nc = nc;
  a.w = w;
  a.tail = tail;
  if (tail < 1 || tail > pir_compat::kMaxTail) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* os = static_cast<uint32_t*>(out_s);
  uint32_t* ot = static_cast<uint32_t*>(out_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + kLanesPerBlock - 1) / kLanesPerBlock, nc, q_n);
  if (emit_bits)
    compat_stage_kernel<true><<<grid, kThreads, 0, st>>>(a, os, ot);
  else
    compat_stage_kernel<false><<<grid, kThreads, 0, st>>>(a, os, ot);
  return static_cast<int>(cudaGetLastError());
}

// Pointers are device addresses of contiguous uint32 (int32) tensors with
// the shapes of HeadArgs; d = cw_s.shape[1] >= prefix + split, split =
// 5 + log2(w) with w the output's lane words, prefix + split <=
// kMaxHeadLevels. out_s receives the seeds (Q,8,1,16,w), out_t the t bits
// (Q,1,1,w). Returns cudaGetLastError() after the launch.
extern "C" int pir_compat_head(const void* seeds, const void* t, const void* cw_s,
                               const void* cw_tl, const void* cw_tr, const void* rk, void* out_s,
                               void* out_t, int q_n, int d, int prefix, int path, int split,
                               void* stream) {
  pir_compat::HeadArgs a;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.t = static_cast<const uint32_t*>(t);
  a.cw_s = static_cast<const uint32_t*>(cw_s);
  a.cw_tl = static_cast<const uint32_t*>(cw_tl);
  a.cw_tr = static_cast<const uint32_t*>(cw_tr);
  a.rk = static_cast<const uint32_t*>(rk);
  a.d = d;
  a.prefix = prefix;
  a.path = path;
  a.split = split;
  if (split < 5 || prefix < 0 || prefix + split > d || prefix + split > pir_compat::kMaxHeadLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 << pir_compat::head_group_bits(split);
  compat_head_kernel<<<q_n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint32_t*>(out_s), static_cast<uint32_t*>(out_t));
  return static_cast<int>(cudaGetLastError());
}
