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
// thread owns one head node (step s, lane word w, bit position j) and
// walks its `tail`-level subtree depth first, each node expanded once
// (2^tail - 1 expansions of three blocks), then runs each leaf's n_blk
// CTR blocks. AES is byte-oriented with the per-bank T-table of
// aes_lanes.cuh (lane j reads bank j: one shared-memory pass a lookup);
// round keys are rebuilt as bytes from the mask operands, per lane word
// for distinct-key batches. The 32 threads of a warp hold the 32 bit
// positions of one lane word, so the planes common to a warp reach the
// lanes as 4 loads a lane and a warp transpose (the head seed and each
// level's seed correction word), and one __ballot_sync per (bit plane,
// byte) re-bitslices a leaf block into output words. The leaf
// correction t & fcw is applied to those words, as the TPU kernel does
// on its planes: fcw never reaches the lanes. A block stages 8 lane
// words' outputs in shared memory and writes 32-byte runs.

#include <cstdint>
#include <cuda_runtime.h>

#include "stacked_tail.cuh"

namespace {

using pir_tail::AesLanes;
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
  __shared__ pir_tail::AesLaneTable table;
  __shared__ __align__(16) uint32_t keys[kLanesPerBlock][kKeys][kKeyWords];
  __shared__ uint32_t stage[kLanesPerBlock][128];
  __shared__ uint32_t stage_t[kLanesPerBlock];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w0 = blockIdx.x * kLanesPerBlock;
  const int s = blockIdx.y;
  // warps past the last lane word compute a copy of it and store nothing
  const int w = min(w0 + warp, a.w - 1);

  for (int i = tid; i < 2048; i += kThreads) pir_tail::fill_lane_table(table, i);
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

  const AesLanes T = pir_tail::lanes_of(table, lane);
  const uint32_t* my_keys = &keys[rk_lanes == 1 ? 0 : warp][0][0];
  const size_t sw = (size_t)a.w;
  uint32_t st[4];
  pir_tail::warp_unbitslice(a.seeds + (size_t)s * 128 * sw + w, 16 * sw, sw, lane, st);
  const uint32_t t = (a.t[(size_t)s * sw + w] >> lane) & 1u;

  // the block stores its 8 lane words' 128 staged words as 4 words a
  // thread: lane word li, rows r0 + 32 m (bit r0 / 16 + 2 m, byte r0 % 16)
  static_assert(128 * kLanesPerBlock == 4 * kThreads, "4 staged words a thread");
  const int li = tid % kLanesPerBlock;
  const int r0 = tid / kLanesPerBlock;
  const bool store = w0 + li < a.w;
  const size_t plane = 16 * sw;  // words from one (bit, chunk) plane to the next
  const int bn = (1 << a.tail) * a.n_blk;
  const size_t col = (size_t)(r0 & 15) * sw + (store ? w0 + li : 0);
  uint32_t* out_t = out + ((size_t)s * 8 + (r0 >> 4)) * bn * plane + col;
  const uint32_t* fcw_t = a.fcw + ((size_t)s * 8 + (r0 >> 4)) * a.n_blk * plane + col;

  pir_tail::for_each_tail_leaf(
      T, my_keys, a.tail, st, t,
      [&](int l, uint32_t cw[4], uint32_t* tcl, uint32_t* tcr) {
        const size_t lvl = (size_t)s * a.tail + l;
        pir_tail::warp_unbitslice(a.cw_s + lvl * 128 * sw + w, plane, sw, lane, cw);
        *tcl = (a.cw_tl[lvl * sw + w] >> lane) & 1u;
        *tcr = (a.cw_tr[lvl * sw + w] >> lane) & 1u;
      },
      [&](int c, const uint32_t* ls, uint32_t lt) {
        const uint32_t tword = __ballot_sync(0xFFFFFFFFu, lt);
        if (lane == 0) stage_t[warp] = tword;
#pragma unroll 1
        for (int b = 0; b < a.n_blk; ++b) {
          uint32_t o[4];
          pir_tail::leaf_mmo(T, my_keys + 3 * kKeyWords, ls, b, o);
          pir_tail::ballot_planes(o, stage[warp]);
          __syncthreads();
          if (store) {
            const uint32_t tmask = stage_t[li];
            const size_t chunk = (size_t)c * a.n_blk + b;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const uint32_t f = fcw_t[((size_t)b + 2 * m * a.n_blk) * plane];
              out_t[(chunk + 2 * m * (size_t)bn) * plane] = stage[li][r0 + 32 * m] ^ (tmask & f);
            }
          }
          __syncthreads();
        }
      });
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
  if (tail < 0 || tail > pir_tail::kMaxTail || s_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kLanesPerBlock - 1) / kLanesPerBlock, s_n);
  stacked_tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint32_t*>(rk), static_cast<const uint32_t*>(rk_leaf), rk_lanes,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
