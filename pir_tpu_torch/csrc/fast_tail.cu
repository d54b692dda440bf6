// Per-query fast-DPF tail: each query's head frontier walks the last
// `levels` tree levels, then the n_blk-block leaf CTR PRG, emitting the
// scan's selection words in the classic bit-reversed storage order.
//
// Replaces the TPU kernel pir_tpu/ops/pallas_expand.py:
// fast_tail_expand_pallas (_tail_kernel). Same operands and the same
// output: (Q, 8, 16, n_blk * NWf) bit-plane words, lane = blk * NWf +
// word, bit j of word w belonging to node 32 w + j of the query's last
// level (lane concatenation, each level the most significant lane bit).
//
// What bounds it on an H100: AES. A node costs three AES-128 blocks and
// a leaf n_blk more, and there is no AES unit, so at the serving shape
// (depth 10, 5 tail levels, 8 leaf blocks) a query's 992 node
// expansions and 1024 x 8 leaf blocks, 11,168 blocks of 356 integer-pipe
// instructions each (chip_smoke.py AES_BLOCK_PIPES), take ~0.24 us of the
// card against ~0.04 us for its 128 KiB of output words at 3.35 TB/s.
//
// Design: the TPU kernel ran bitsliced AES on (bit, byte, lane) planes,
// doubling the lanes per level with Mosaic rolls for sR's byte shift.
// Here one thread owns one node a few levels below the head (see
// fast_tail.cuh for the geometry): it walks down to it expanding only the
// wanted child, then walks its subtree depth first, every node expanded
// once, with byte-oriented AES on the per-bank T-table of aes_lanes.cuh
// (lane j reads bank j: one shared-memory pass a lookup; the query's
// keys, correction words, t bits and fcw words rebuilt from the mask
// operands into shared memory once per block). The loops are not
// unrolled, so the kernel holds one copy of the PRG. A warp's 32 threads
// are the 32 bit positions of one lane word: its head seeds come through
// 4 plane loads a lane and a warp transpose, and a 32 x 32 warp
// transpose (five shuffles a word) re-bitslices a leaf block into its
// 128 output words, corrected there by t & fcw. A block of 8 warps, 8
// consecutive lane words of one query, stages each CTR block in one of
// two buffers, takes one barrier, and stores 32-byte runs.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_tail.cuh"

namespace {

using pir_fast::FastTailArgs;
using pir_fast::TailShared;

__global__ void __launch_bounds__(pir_fast::kThreads)
fast_tail_kernel(FastTailArgs a, uint32_t* __restrict__ out) {
  __shared__ TailShared sh;
  pir_fast::tail_block(a, blockIdx.x / a.groups, blockIdx.x % a.groups, sh, out);
}

}  // namespace

// Pointers are device addresses of contiguous uint32 (int32) tensors with
// the shapes of FastTailArgs; out is (Q, 8, 16, n_blk * (nw0 << levels)).
// rk_per_query is 0 for batch-shared round keys, 1 for per-query ones;
// levels is 0..kMaxLevels. Returns cudaGetLastError() after the launch.
extern "C" int pir_fast_tail(const void* seeds, const void* t, const void* cw_s,
                             const void* cw_tl, const void* cw_tr, const void* rk,
                             const void* fcw, const void* rk_leaf, void* out, int q_n, int nw0,
                             int levels, int n_blk, int rk_per_query, void* stream) {
  if (levels < 0 || levels > pir_fast::kMaxLevels || nw0 < 1 || n_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FastTailArgs a{static_cast<const uint32_t*>(seeds), static_cast<const uint32_t*>(t),
                 static_cast<const uint32_t*>(cw_s),  static_cast<const uint32_t*>(cw_tl),
                 static_cast<const uint32_t*>(cw_tr), static_cast<const uint32_t*>(rk),
                 static_cast<const uint32_t*>(fcw),   static_cast<const uint32_t*>(rk_leaf),
                 q_n, nw0, levels, n_blk, rk_per_query};
  pir_fast::init_geometry(a);
  const long long blocks = (long long)q_n * a.groups;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fast_tail_kernel<<<(unsigned)blocks, pir_fast::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
