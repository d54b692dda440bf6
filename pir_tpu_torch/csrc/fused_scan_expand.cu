// Fused scan + per-query tail: in one launch, the packed-bits scan of
// batch i's selection words against the table and the per-query fast
// tail of batch i+1 (batch-shared keys, 128-bit leaves).
//
// Replaces the TPU kernel pir_tpu/ops/pallas_fused.py:
// fused_scan_expand_pallas (_fused_kernel). Same operands and the same
// two outputs: answers (Q, B) uint8, as packed_scan.cu gives them, and
// tail words (QE, 8, 16, NW0 << levels), as fast_tail.cu gives them.
//
// What bounds it on an H100: its two halves on two kinds of unit. The
// scan's bound is its int8 tensor-core route (8 bit planes x 2 Q H B
// operations at 1979 TOPS: 35.6 ms at Q = 4096 on the 1 GiB table), the
// tail's its AES (356 integer-pipe instructions a block at 16.75 Tops/s:
// ~2.8 ms for 4096 queries at depth 13); if they overlap fully, the larger. The
// scan half runs on the tensor cores (wgmma), the tail half on the
// integer pipes.
//
// Design: the TPU kernel ran MXU matmuls (scan) beside VPU AES (tail)
// in each grid step. Here one grid holds work items of both kinds, one
// per block of 8 warps, spread evenly through the block index so that
// both kinds stay resident side by side while the grid drains: a scan
// item is one tile of packed_planes.cuh (kernel 2's: wgmma on the bit
// planes, 128 queries x 32 byte columns) over one chunk of
// kChunkWordRows x 32 table rows, XORed into the zeroed answers with
// atomics (XOR is order-free, so the bytes equal the one-pass scan's); a
// tail item is one block of fast_tail.cuh (one query, 8 lane words). Row
// chunks make scan items short enough to interleave with tail items, and
// put every SM to work on the scan even when Q is small. Scan items run
// chunk-major, and query tiles fastest within a chunk, so the blocks
// resident at one time read one 16 MiB slice of the table (within the
// 50 MB L2). Both roles take the block's dynamic shared memory: the scan
// tile's ring and planes (~91 KB), or the tail's per-bank AES table, query
// constants and staging (~47 KB).
//
// Residency: one block of either kind an SM. The scan tile keeps 128
// accumulators a thread (ptxas: ~250 registers, which both roles get);
// its shared memory alone would let two blocks share an SM. A tile of
// 64 accumulators (N = 128) at two blocks an SM ran the 4096-query step
// slower in a trial on the card, so the kernel keeps kernel 2's tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_tail.cuh"
#include "packed_planes.cuh"

namespace {

static_assert(pir_planes::kThreads == pir_fast::kThreads, "one block size for both roles");
constexpr int kChunkWordRows = 512;  // 16384 table rows per scan item
constexpr int kSmemBytes = pir_planes::kSmemBytes > static_cast<int>(sizeof(pir_fast::TailShared))
                               ? pir_planes::kSmemBytes
                               : static_cast<int>(sizeof(pir_fast::TailShared));

struct ScanArgs {
  const uint32_t* table;
  const uint32_t* words;
  uint32_t* out;
  int h;
  int bw;
  int q;
  int col_tiles;
  int q_tiles;
  int chunks;
};

__global__ void __launch_bounds__(pir_fast::kThreads, 1)
fused_kernel(ScanArgs s, pir_fast::FastTailArgs a, uint32_t* __restrict__ tail_out,
             long long n_scan, long long n_total) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long i = blockIdx.x;
  // block i is a scan item when the even spread of n_scan items over
  // n_total blocks steps at i; scan items before it: floor(i n_scan / n_total)
  const long long before = i * n_scan / n_total;
  if ((i + 1) * n_scan / n_total > before) {
    const long long tiles = (long long)s.col_tiles * s.q_tiles;
    const long long chunk = before / tiles;
    const int tile = (int)(before % tiles);
    const long long r_begin = chunk * kChunkWordRows * 32;
    const long long r_end = min((long long)s.h, r_begin + kChunkWordRows * 32);
    pir_planes::scan_chunk<1>(s.table, s.words, s.out, s.h, s.bw, s.q,
                              (tile / s.q_tiles) * pir_planes::kColWords,
                              (tile % s.q_tiles) * pir_planes::kQueriesPerBlock, r_begin, r_end,
                              smem);
  } else {
    const long long item = i - before;
    pir_fast::tail_block(a, (int)(item / a.groups), (int)(item % a.groups),
                         *reinterpret_cast<pir_fast::TailShared*>(smem), tail_out);
  }
}

}  // namespace

// The dynamic shared memory a block takes (kSmemBytes), the scan tile's
// and the tail's, for the build log.
extern "C" void pir_fused_smem_bytes(int* out3) {
  out3[0] = kSmemBytes;
  out3[1] = pir_planes::kSmemBytes;
  out3[2] = static_cast<int>(sizeof(pir_fast::TailShared));
}

// Scan operands as pir_packed_scan's: table (h, 4 * bw) uint8 rows,
// words (h / 32, q), out (q, bw) words, which must be zero on entry.
// Tail operands as pir_fast_tail's for batch-shared keys and 128-bit
// leaves: seeds (qe,8,16,nw0), t (qe,1,nw0), cw_s (qe,levels,8,16,1),
// cw_tl / cw_tr (qe,levels), rk (11,8,3,16,1), fcw (qe,8,16,1),
// rk_leaf (11,8,16,1), tail_out (qe,8,16,nw0 << levels).
// Returns the first CUDA error of the launch.
extern "C" int pir_fused_scan_expand(const void* table, const void* words, const void* seeds,
                                     const void* t, const void* cw_s, const void* cw_tl,
                                     const void* cw_tr, const void* rk, const void* fcw,
                                     const void* rk_leaf, void* out, void* tail_out, int h,
                                     int bw, int q, int qe, int nw0, int levels, void* stream) {
  // bw < 2^23: the scan tile's 32-bit row offsets
  if (levels < 0 || levels > pir_fast::kMaxLevels || nw0 < 1 || h % 32 || bw >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs s{static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(words),
             static_cast<uint32_t*>(out), h, bw, q,
             (bw + pir_planes::kColWords - 1) / pir_planes::kColWords,
             (q + pir_planes::kQueriesPerBlock - 1) / pir_planes::kQueriesPerBlock,
             (h / 32 + kChunkWordRows - 1) / kChunkWordRows};
  pir_fast::FastTailArgs a{static_cast<const uint32_t*>(seeds), static_cast<const uint32_t*>(t),
                           static_cast<const uint32_t*>(cw_s), static_cast<const uint32_t*>(cw_tl),
                           static_cast<const uint32_t*>(cw_tr), static_cast<const uint32_t*>(rk),
                           static_cast<const uint32_t*>(fcw),
                           static_cast<const uint32_t*>(rk_leaf), qe, nw0, levels, 1, 0};
  pir_fast::init_geometry(a);
  const long long n_scan = q ? (long long)s.col_tiles * s.q_tiles * s.chunks : 0;
  const long long n_total = n_scan + (long long)qe * a.groups;
  if (n_total == 0) return 0;
  if (n_total > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kernel<<<(unsigned)n_total, pir_fast::kThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(s, a, static_cast<uint32_t*>(tail_out),
                                                      n_scan, n_total);
  return static_cast<int>(cudaGetLastError());
}
