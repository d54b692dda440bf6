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
// Design: a block owns a tile of kQueriesPerBlock queries x
// kColsPerBlock 4-byte columns and loops over the whole table in row
// tiles staged in shared memory (the loop takes the place of the TPU's
// sequential row grid: blocks run in no order, so the rows of one output
// are not split across blocks). Each thread keeps u32 XOR accumulators
// for kQueriesPerThread queries x kColsPerThread columns in registers;
// a warp shares its queries (their selection words are broadcast from
// shared memory) and spreads its columns 32 apart, so shared-memory
// reads of the row tile are free of bank conflicts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueriesPerThread = 8;
constexpr int kColsPerThread = 4;
constexpr int kQueriesPerBlock = kWarps * kQueriesPerThread;  // 32
constexpr int kColsPerBlock = 32 * kColsPerThread;            // 128 words = 512 B
constexpr int kWordRowsPerTile = 2;                           // 64 table rows
constexpr int kRowsPerTile = 32 * kWordRowsPerTile;

__global__ void __launch_bounds__(kThreads)
packed_scan_kernel(const uint32_t* __restrict__ table,  // (H, BW) words
                   const uint32_t* __restrict__ words,  // (H / 32, Q)
                   uint32_t* __restrict__ out,          // (Q, BW)
                   int h, int bw, int q) {
  __shared__ uint32_t rows[kRowsPerTile][kColsPerBlock];
  __shared__ uint32_t sel[kWordRowsPerTile][kQueriesPerBlock];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = blockIdx.x * kColsPerBlock;
  const int q0 = blockIdx.y * kQueriesPerBlock;
  const int hw = h / 32;

  uint32_t acc[kQueriesPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kQueriesPerThread; ++i)
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) acc[i][k] = 0u;

  for (int wr0 = 0; wr0 < hw; wr0 += kWordRowsPerTile) {
    for (int idx = tid; idx < kRowsPerTile * kColsPerBlock; idx += kThreads) {
      const int r = idx / kColsPerBlock;
      const int cc = idx % kColsPerBlock;
      const int row = wr0 * 32 + r;
      const int col = col0 + cc;
      rows[r][cc] = (row < h && col < bw) ? table[(size_t)row * bw + col] : 0u;
    }
    for (int idx = tid; idx < kWordRowsPerTile * kQueriesPerBlock; idx += kThreads) {
      const int wr = idx / kQueriesPerBlock;
      const int qq = idx % kQueriesPerBlock;
      const int w = wr0 + wr;
      const int qi = q0 + qq;
      sel[wr][qq] = (w < hw && qi < q) ? words[(size_t)w * q + qi] : 0u;
    }
    __syncthreads();

#pragma unroll
    for (int wr = 0; wr < kWordRowsPerTile; ++wr) {
      uint32_t bits[kQueriesPerThread];
#pragma unroll
      for (int i = 0; i < kQueriesPerThread; ++i)
        bits[i] = sel[wr][warp * kQueriesPerThread + i];
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        uint32_t v[kColsPerThread];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k) v[k] = rows[wr * 32 + j][lane + 32 * k];
#pragma unroll
        for (int i = 0; i < kQueriesPerThread; ++i) {
          const uint32_t m = 0u - ((bits[i] >> j) & 1u);
#pragma unroll
          for (int k = 0; k < kColsPerThread; ++k) acc[i][k] ^= v[k] & m;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerThread; ++i) {
    const int qi = q0 + warp * kQueriesPerThread + i;
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int col = col0 + lane + 32 * k;
      if (qi < q && col < bw) out[(size_t)qi * bw + col] = acc[i][k];
    }
  }
}

}  // namespace

// table: (h, 4 * bw) uint8 rows as (h, bw) little-endian words; words:
// (h / 32, q) selection words; out: (q, bw) words. h % 32 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int pir_packed_scan(const void* table, const void* words, void* out,
                               int h, int bw, int q, void* stream) {
  const dim3 grid((bw + kColsPerBlock - 1) / kColsPerBlock,
                  (q + kQueriesPerBlock - 1) / kQueriesPerBlock);
  packed_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(words),
      static_cast<uint32_t*>(out), h, bw, q);
  return static_cast<int>(cudaGetLastError());
}
