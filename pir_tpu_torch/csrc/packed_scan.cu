// Packed-bits batched XOR scan for the 2-server PIR answer (kernel 2).
//
// Replaces the TPU kernel pir_tpu/ops/pallas_scan.py:mxu_batched_scan_packed_pallas
// (_packed_planes_scan_kernel): out[q] = XOR of the table rows r whose
// selection bit is set, bit j of words[w][q] selecting row 32w + j. The
// TPU kernel runs it as 8 int8 bit-plane products on the matrix unit,
// each taken mod 2; so does this one, on the tensor cores.
//
// What bounds it on an H100: operations. 8 planes x 2 Q H B int8
// operations at 1979 TOPS (1 GiB table: 35.56 ms at Q = 4096, 8.89 ms at
// Q = 1024), against bytes read once (table, words, answers: ~0.5 ms at
// 3.35 TB/s).
//
// Design: the tile of packed_planes.cuh (which fused_scan_expand.cu
// shares): wgmma m64n256k32 s8 with A spread from the packed words in
// registers and B the table's 8 bit planes of 32 byte columns, written
// into swizzled shared memory from raw stages that cp.async brings ahead
// of use. A block of 2 warpgroups owns 128 queries x 32 byte columns over
// one chunk of rows; rows are split into chunks over grid.z until the grid
// has ~32 blocks an SM, so that small batches (Q = 1024: 256 tiles) put
// every SM to work, and the partial parities are XORed into the zeroed
// answers with atomicXor. Query tiles run fastest in the grid, so the
// blocks resident at one time read the same rows and columns of the
// table, which the L2 serves after the first. One block an SM (the
// m64n256 product keeps 128 accumulators a thread; ~91 KB of shared
// memory).

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_planes.cuh"

namespace {

constexpr int kTargetBlocks = 32 * 132;  // ~32 blocks an SM over the grid
constexpr int kMaxGridYZ = 65535;

__global__ void __launch_bounds__(pir_planes::kThreads, 1)
packed_scan_kernel(const uint32_t* __restrict__ table,  // (h, bw) words
                   const uint32_t* __restrict__ words,  // (h / 32, q)
                   uint32_t* __restrict__ out,          // (q, bw), zeroed
                   int h, int bw, int q, long long chunk_rows) {
  extern __shared__ uint8_t smem[];
  const long long r_begin = blockIdx.z * chunk_rows;
  const long long r_end = min(static_cast<long long>(h), r_begin + chunk_rows);
  pir_planes::scan_chunk<1>(table, words, out, h, bw, q, blockIdx.y * pir_planes::kColWords,
                            blockIdx.x * pir_planes::kQueriesPerBlock, r_begin, r_end, smem);
}

}  // namespace

// table: (h, 4 * bw) uint8 rows as (h, bw) little-endian words, 4-byte
// aligned; words: (h / 32, q) selection words; out: (q, bw) words, zeroed
// by the caller. h % 32 == 0; q, h, bw >= 1. Grid: (query tiles, column
// tiles, row chunks). Returns the first CUDA error of the launch.
extern "C" int pir_packed_scan(const void* table, const void* words, void* out,
                               int h, int bw, int q, void* stream) {
  if (q < 1 || h < 1 || bw < 1 || h % 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long q_tiles = (q + pir_planes::kQueriesPerBlock - 1) / pir_planes::kQueriesPerBlock;
  const long long col_tiles = (bw + pir_planes::kColWords - 1) / pir_planes::kColWords;
  if (col_tiles > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunk_rows = pir_planes::chunk_rows_for(q_tiles * col_tiles, h, kTargetBlocks);
  const long long chunks = (h + chunk_rows - 1) / chunk_rows;
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(chunks));
  cudaError_t err = cudaFuncSetAttribute(
      packed_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pir_planes::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_scan_kernel<<<grid, pir_planes::kThreads, pir_planes::kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(words),
      static_cast<uint32_t*>(out), h, bw, q, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}
