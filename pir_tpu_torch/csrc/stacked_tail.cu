// Stacked fast-DPF tail: the last `tail` tree levels of k lane-packed
// queries plus the wide-leaf CTR PRG, emitting the scan's selection words.
//
// Replaces the TPU kernel pir_tpu/ops/pallas_expand.py:
// fast_tail_expand_stacked_pallas (_fast_stack_kernel). Same operands and
// the same output: (S, 8, 2^tail * n_blk, 16, W) bit-plane words, chunk =
// (leaf low bits) * n_blk + CTR block, bit j of lane word w belonging to
// tree node 32w + j of the step's head frontier.
//
// What bounds it on an H100: AES. There is no AES unit, so each block is
// ~10 rounds of table lookups and integer ops; the 512 MiB of output
// words at the serving shape take ~0.16 ms at 3.35 TB/s, far less.
//
// Design: the TPU kernel ran bitsliced AES on (bit, byte, lane) planes,
// whose rolls and masked selects were workarounds for Mosaic. Here one
// thread owns one (step s, lane word w, bit position j, tail leaf c): it
// un-bitslices its 128-bit head seed from the 128 input words, walks
// c's path with byte-oriented AES (T-table and S-box in shared memory;
// round keys rebuilt as bytes from the mask operands, per lane word for
// distinct-key batches), then runs the n_blk leaf CTR blocks. Ancestors
// shared by the 2^tail leaves are recomputed by each (at most `tail` = 3
// extra node walks per leaf). The 32 threads of a warp hold the 32 bit
// positions of one lane word, so one __ballot_sync per (bit plane, byte)
// re-bitslices a leaf block into output words; a block stages 8 lane
// words' outputs in shared memory and writes 32-byte runs.

#include <cstdint>
#include <cuda_runtime.h>

#include "stacked_tail.cuh"

namespace {

using pir_tail::AesTables;
using pir_tail::TailArgs;

constexpr int kLanesPerBlock = 8;  // lane words per block, one warp each
constexpr int kThreads = 32 * kLanesPerBlock;
constexpr int kKeys = 4;           // three tree PRF keys + the leaf key
constexpr int kKeyWords = 44;      // 11 round keys x 4 words
constexpr int kKeyBytes = 4 * kKeyWords;

__global__ void __launch_bounds__(kThreads)
stacked_tail_kernel(TailArgs a, const uint32_t* __restrict__ rk,
                    const uint32_t* __restrict__ rk_leaf, int rk_lanes,
                    uint32_t* __restrict__ out) {
  __shared__ AesTables tables;
  __shared__ uint32_t keys[kLanesPerBlock][kKeys][kKeyWords];
  __shared__ uint32_t stage[kLanesPerBlock][128];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w0 = blockIdx.x * kLanesPerBlock;
  const int c = blockIdx.y;
  const int s = blockIdx.z;
  // warps past the last lane word compute a copy of it and store nothing
  const int w = min(w0 + warp, a.w - 1);

  for (int i = tid; i < 256; i += kThreads) pir_tail::fill_tables(tables, i);
  // shared keys are one set for the block; distinct keys one per lane word
  const int key_sets = rk_lanes == 1 ? 1 : kLanesPerBlock;
  uint8_t* key_bytes = reinterpret_cast<uint8_t*>(&keys[0][0][0]);
  for (int idx = tid; idx < key_sets * kKeys * kKeyBytes; idx += kThreads) {
    const int set = idx / (kKeys * kKeyBytes);
    const int key = (idx / kKeyBytes) % kKeys;
    key_bytes[idx] = static_cast<uint8_t>(pir_tail::key_byte(
        rk, rk_leaf, rk_lanes, s, min(w0 + set, a.w - 1), key, idx % kKeyBytes));
  }
  __syncthreads();

  const uint32_t* my_keys = &keys[rk_lanes == 1 ? 0 : warp][0][0];
  uint32_t st[4], tbit;
  pir_tail::walk_tail(a, tables, my_keys, s, w, lane, c, st, &tbit);

  const int bn = (1 << a.tail) * a.n_blk;
  const size_t sw = (size_t)a.w;
  for (int b = 0; b < a.n_blk; ++b) {
    uint32_t o[4];
    pir_tail::leaf_block(a, tables, my_keys + 3 * kKeyWords, s, w, lane, st, tbit, b, o);
    // re-bitslice: word (bit k, byte i) gets bit j from thread j
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t word = __ballot_sync(0xFFFFFFFFu, (o[i >> 2] >> (8 * (i & 3) + k)) & 1u);
        if (lane == ((k * 16 + i) & 31)) stage[warp][k * 16 + i] = word;
      }
    }
    __syncthreads();
    const int chunk = c * a.n_blk + b;
    for (int idx = tid; idx < 128 * kLanesPerBlock; idx += kThreads) {
      const int row = idx / kLanesPerBlock;  // bit * 16 + byte
      const int li = idx % kLanesPerBlock;
      if (w0 + li < a.w) {
        out[(((size_t)s * 8 + (row >> 4)) * bn + chunk) * 16 * sw + (size_t)(row & 15) * sw +
            w0 + li] = stage[li][row];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Pointers are device addresses of contiguous uint32 (int32) tensors with
// the shapes of TailArgs; rk_lanes is 1 for batch-shared round keys
// (rk (11,8,3,16,1), rk_leaf (11,8,16,1)) or w for per-step, per-lane
// keys (rk (S,11,8,3,16,W), rk_leaf (S,11,8,16,W)).
// Returns cudaGetLastError() after the launch.
extern "C" int pir_stacked_tail(const void* seeds, const void* t, const void* cw_s,
                                const void* cw_tl, const void* cw_tr, const void* rk,
                                const void* fcw, const void* rk_leaf, void* out,
                                int s_n, int w, int tail, int n_blk, int rk_lanes,
                                void* stream) {
  TailArgs a;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.t = static_cast<const uint32_t*>(t);
  a.cw_s = static_cast<const uint32_t*>(cw_s);
  a.cw_tl = static_cast<const uint32_t*>(cw_tl);
  a.cw_tr = static_cast<const uint32_t*>(cw_tr);
  a.fcw = static_cast<const uint32_t*>(fcw);
  a.w = w;
  a.tail = tail;
  a.n_blk = n_blk;
  const dim3 grid((w + kLanesPerBlock - 1) / kLanesPerBlock, 1u << tail, s_n);
  stacked_tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(rk), static_cast<const uint32_t*>(rk_leaf), rk_lanes,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
