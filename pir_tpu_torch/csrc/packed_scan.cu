// Packed-bits batched XOR scan for the 2-server PIR answer.
//
// Replaces the TPU kernel pir_tpu/ops/pallas_scan.py:mxu_batched_scan_packed_pallas
// (_packed_planes_scan_kernel): out[q] = XOR of the table rows r whose
// selection bit is set, bit j of words[w][q] selecting row 32w + j.
//
// What bounds it on an H100: the table is read once per block column
// and query tile, so bytes are cheap (1 GiB table + words, ~0.5 ms at
// 3.35 TB/s); the work is Q*H*B/4 32-bit "acc ^= row & mask" steps, one
// LOP3 each, on the integer pipes. The TPU ran the same function as
// int8 bit-plane matrix products; on this card that route is bounded by
// the int8 tensor-core rate, which is the target of a later kernel.
//
// Design: a block owns a tile of 32 queries x 128 4-byte columns and
// loops over the whole table in row tiles staged in shared memory (the
// loop takes the place of the TPU's sequential row grid: blocks run in no
// order, so the rows of one output are not split across blocks). The
// tile's body is packed_scan.cuh's, which fused_scan_expand.cu shares.

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_scan.cuh"

namespace {

constexpr int kWarps = 4;
using Tile = pir_scan::ScanTile<kWarps>;

__global__ void __launch_bounds__(Tile::kThreads)
packed_scan_kernel(const uint32_t* __restrict__ table,  // (H, BW) words
                   const uint32_t* __restrict__ words,  // (H / 32, Q)
                   uint32_t* __restrict__ out,          // (Q, BW)
                   int h, int bw, int q) {
  __shared__ Tile::Shared sh;
  pir_scan::scan_tile<kWarps, false>(table, words, out, h, bw, q, blockIdx.x * Tile::kColsPerBlock,
                                     blockIdx.y * Tile::kQueriesPerBlock, 0, h / 32, sh);
}

}  // namespace

// table: (h, 4 * bw) uint8 rows as (h, bw) little-endian words; words:
// (h / 32, q) selection words; out: (q, bw) words. h % 32 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int pir_packed_scan(const void* table, const void* words, void* out,
                               int h, int bw, int q, void* stream) {
  const dim3 grid((bw + Tile::kColsPerBlock - 1) / Tile::kColsPerBlock,
                  (q + Tile::kQueriesPerBlock - 1) / Tile::kQueriesPerBlock);
  packed_scan_kernel<<<grid, Tile::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(words),
      static_cast<uint32_t*>(out), h, bw, q);
  return static_cast<int>(cudaGetLastError());
}
