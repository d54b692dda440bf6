// The per-tile body of the packed-bits batched XOR scan, shared by
// packed_scan.cu (whole tables, one tile per block) and
// fused_scan_expand.cu (row chunks of a tile, XORed into the output with
// atomics): out[q] ^= XOR of the table rows r whose selection bit is
// set, bit j of words[w][q] selecting row 32w + j.
//
// A block owns a tile of kQueriesPerBlock queries x kColsPerBlock 4-byte
// columns and loops over its rows in row tiles staged in shared memory.
// Each thread keeps u32 XOR accumulators for kQueriesPerThread queries x
// kColsPerThread columns in registers; a warp shares its queries (their
// selection words are broadcast from shared memory) and spreads its
// columns 32 apart, so shared-memory reads of the row tile are free of
// bank conflicts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pir_scan {

template <int kWarps>
struct ScanTile {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQueriesPerThread = 8;
  static constexpr int kColsPerThread = 4;
  static constexpr int kQueriesPerBlock = kWarps * kQueriesPerThread;
  static constexpr int kColsPerBlock = 32 * kColsPerThread;  // 128 words = 512 B
  static constexpr int kWordRowsPerTile = 2;                 // 64 table rows
  static constexpr int kRowsPerTile = 32 * kWordRowsPerTile;

  struct Shared {
    uint32_t rows[kRowsPerTile][kColsPerBlock];
    uint32_t sel[kWordRowsPerTile][kQueriesPerBlock];
  };
};

// The tile (columns col0.., queries q0..) over the selection word rows
// [wr_begin, wr_end) (table rows 32 wr_begin .. 32 wr_end): table (h, bw)
// words, words (h / 32, q), out (q, bw) words, stored, or XORed in with
// atomicXor when ATOMIC (out then starts at zero).
template <int kWarps, bool ATOMIC>
__device__ __forceinline__ void scan_tile(const uint32_t* __restrict__ table,
                                          const uint32_t* __restrict__ words,
                                          uint32_t* __restrict__ out, int h, int bw, int q,
                                          int col0, int q0, int wr_begin, int wr_end,
                                          typename ScanTile<kWarps>::Shared& sh) {
  using T = ScanTile<kWarps>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  uint32_t acc[T::kQueriesPerThread][T::kColsPerThread];
#pragma unroll
  for (int i = 0; i < T::kQueriesPerThread; ++i)
#pragma unroll
    for (int k = 0; k < T::kColsPerThread; ++k) acc[i][k] = 0u;

  for (int wr0 = wr_begin; wr0 < wr_end; wr0 += T::kWordRowsPerTile) {
    for (int idx = tid; idx < T::kRowsPerTile * T::kColsPerBlock; idx += T::kThreads) {
      const int r = idx / T::kColsPerBlock;
      const int cc = idx % T::kColsPerBlock;
      const int row = wr0 * 32 + r;
      const int col = col0 + cc;
      sh.rows[r][cc] = (row < h && col < bw) ? table[(size_t)row * bw + col] : 0u;
    }
    for (int idx = tid; idx < T::kWordRowsPerTile * T::kQueriesPerBlock; idx += T::kThreads) {
      const int wr = idx / T::kQueriesPerBlock;
      const int qq = idx % T::kQueriesPerBlock;
      const int w = wr0 + wr;
      const int qi = q0 + qq;
      sh.sel[wr][qq] = (w < wr_end && qi < q) ? words[(size_t)w * q + qi] : 0u;
    }
    __syncthreads();

#pragma unroll
    for (int wr = 0; wr < T::kWordRowsPerTile; ++wr) {
      uint32_t bits[T::kQueriesPerThread];
#pragma unroll
      for (int i = 0; i < T::kQueriesPerThread; ++i)
        bits[i] = sh.sel[wr][warp * T::kQueriesPerThread + i];
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        uint32_t v[T::kColsPerThread];
#pragma unroll
        for (int k = 0; k < T::kColsPerThread; ++k) v[k] = sh.rows[wr * 32 + j][lane + 32 * k];
#pragma unroll
        for (int i = 0; i < T::kQueriesPerThread; ++i) {
          const uint32_t m = 0u - ((bits[i] >> j) & 1u);
#pragma unroll
          for (int k = 0; k < T::kColsPerThread; ++k) acc[i][k] ^= v[k] & m;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::kQueriesPerThread; ++i) {
    const int qi = q0 + warp * T::kQueriesPerThread + i;
#pragma unroll
    for (int k = 0; k < T::kColsPerThread; ++k) {
      const int col = col0 + lane + 32 * k;
      if (qi < q && col < bw) {
        if constexpr (ATOMIC)
          atomicXor(&out[(size_t)qi * bw + col], acc[i][k]);
        else
          out[(size_t)qi * bw + col] = acc[i][k];
      }
    }
  }
}

}  // namespace pir_scan
