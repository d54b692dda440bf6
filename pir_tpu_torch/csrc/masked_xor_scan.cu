// Masked-XOR scan of a word table: one PIR answer share per query.
//
// Replaces the TPU kernel pir_tpu/ops/pallas_scan.py:masked_xor_scan_pallas
// (_scan_kernel): out[q] = XOR over the table rows r of row r & (0 - bits[q][r]),
// for a table of (H, C) 32-bit words and up to 8 queries a launch.
//
// What bounds it on an H100: bytes. The table is read once for all the
// queries of a launch (1 GiB: 0.32 ms at 3.35 TB/s), the bits once (Q x H
// bytes); masking and XOR-ing is 2 integer operations a word a query, under
// the byte bound for Q <= 8 (8 x 2^28 words x 2 = 4.3e9 operations, 0.26 ms
// at 16.75 Tops/s).
//
// Design: the TPU kernel carries its accumulator across a sequential row
// grid (o_ref ^= x). Blocks on the GPU run in no order, so the rows are
// split into chunks, enough of them to put several blocks on each of the
// 132 SMs even at Q = 1. A block first stages its chunk's bits in shared
// memory, one byte a row holding the Q selection bits, so it loads them
// once. Then each thread walks its column's rows of the chunk, keeping its
// Q partial words in registers: neighbouring threads read neighbouring
// words, 16 bytes a thread where C % 4 == 0 (VEC = 4) and 4 bytes
// otherwise, and the threads of a block not needed for the columns take
// further rows. At the end the block folds its threads' partials in shared
// memory and XORs them into the zeroed output with atomicXor; XOR is
// order-free, so every run gives equal bytes. Ragged edges (any H, any
// C >= 1) are masked by the loop bounds and a column test.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 8;
constexpr int kMaxChunkRows = 4096;  // one selection byte a row in shared memory
constexpr int kTargetBlocks = 2048;  // ~16 blocks an SM over the grid
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[1]) {
  w[0] = __ldg(p);
}

__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[4]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// A block is tx_n (a power of two) threads across vector columns by
// kThreads / tx_n across rows; blockIdx.x picks the column tile, and
// blockIdx.y walks row chunks of chunk_rows (a multiple of the row count).
template <int NQ, int VEC>
__global__ void __launch_bounds__(kThreads)
masked_xor_scan_kernel(const uint32_t* __restrict__ table,  // (h, c) words
                       const uint8_t* __restrict__ bits,     // (NQ, h) {0, 1}
                       uint32_t* __restrict__ out,           // (NQ, c), zeroed
                       int h, int c, int tx_n, int chunk_rows) {
  __shared__ uint8_t sel[kMaxChunkRows];
  __shared__ uint32_t red[kThreads * VEC];
  const int t = threadIdx.x;
  const int tx = t & (tx_n - 1);
  const int ty = t / tx_n;
  const int ty_n = kThreads / tx_n;
  const int col = blockIdx.x * tx_n + tx;  // vector column
  const bool live = col < c / VEC;
  uint32_t acc[NQ][VEC];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[q][v] = 0;
  }

  for (long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows; r0 < h;
       r0 += static_cast<long long>(gridDim.y) * chunk_rows) {
    const int n = static_cast<int>(min(static_cast<long long>(chunk_rows), h - r0));
    __syncthreads();  // the previous chunk's selection bytes are read
    for (int j = t; j < n; j += kThreads) {
      uint32_t m = 0;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        m |= static_cast<uint32_t>(bits[static_cast<size_t>(q) * h + r0 + j] & 1) << q;
      }
      sel[j] = static_cast<uint8_t>(m);
    }
    __syncthreads();
    if (live) {
      const uint32_t* p = table + static_cast<size_t>(r0 + ty) * c + static_cast<size_t>(col) * VEC;
      const size_t step = static_cast<size_t>(ty_n) * c;
#pragma unroll 4
      for (int j = ty; j < n; j += ty_n, p += step) {
        uint32_t w[VEC];
        load_words(p, w);
        const uint32_t m = sel[j];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const uint32_t mask = 0u - ((m >> q) & 1u);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[q][v] ^= w[v] & mask;
        }
      }
    }
  }

  // fold the ty_n partials of each column; one atomic a word and block
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[t * VEC + v] = acc[q][v];
    __syncthreads();
    for (int s = ty_n / 2; s > 0; s >>= 1) {
      if (ty < s) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) red[t * VEC + v] ^= red[(t + s * tx_n) * VEC + v];
      }
      __syncthreads();
    }
    if (ty == 0 && live) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const uint32_t x = red[t * VEC + v];
        if (x) atomicXor(out + static_cast<size_t>(q) * c + static_cast<size_t>(col) * VEC + v, x);
      }
    }
    __syncthreads();
  }
}

template <int VEC>
cudaError_t launch(int q, dim3 grid, cudaStream_t stream, const uint32_t* table,
                   const uint8_t* bits, uint32_t* out, int h, int c, int tx_n, int chunk_rows) {
#define PIR_XOR_SCAN_CASE(NQ)                                                     \
  case NQ:                                                                        \
    masked_xor_scan_kernel<NQ, VEC><<<grid, kThreads, 0, stream>>>(table, bits, out, h, c, \
                                                                   tx_n, chunk_rows);      \
    break;
  switch (q) {
    PIR_XOR_SCAN_CASE(1)
    PIR_XOR_SCAN_CASE(2)
    PIR_XOR_SCAN_CASE(3)
    PIR_XOR_SCAN_CASE(4)
    PIR_XOR_SCAN_CASE(5)
    PIR_XOR_SCAN_CASE(6)
    PIR_XOR_SCAN_CASE(7)
    PIR_XOR_SCAN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PIR_XOR_SCAN_CASE
  return cudaGetLastError();
}

}  // namespace

// table: (h, c) words, 16-byte aligned when vec == 4; bits: (q, h) bytes
// {0, 1}; out: (q, c) words, zeroed by the caller. 1 <= q <= 8, h, c >= 1,
// vec 1 or 4 with c % vec == 0. Returns cudaGetLastError() after the launch.
extern "C" int pir_masked_xor_scan(const void* table, const void* bits, void* out, int h, int c,
                                   int q, int vec, void* stream) {
  if (q < 1 || q > kMaxQ || h < 1 || c < 1 || (vec != 1 && vec != 4) || c % vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cv = c / vec;
  int tx_n = 1;
  while (tx_n < cv && tx_n < kThreads) tx_n <<= 1;
  const int ty_n = kThreads / tx_n;
  const int col_tiles = (cv + tx_n - 1) / tx_n;
  const long long want = col_tiles >= kTargetBlocks ? 1 : kTargetBlocks / col_tiles;
  long long rows = (h + want - 1) / want;
  rows = (rows + ty_n - 1) / ty_n * ty_n;
  if (rows > kMaxChunkRows) rows = kMaxChunkRows;  // a multiple of every ty_n
  long long chunks = (h + rows - 1) / rows;
  if (chunks > kMaxGridY) chunks = kMaxGridY;  // blocks then walk several chunks
  const dim3 grid(col_tiles, static_cast<unsigned>(chunks));
  const auto* tbl = static_cast<const uint32_t*>(table);
  const auto* b = static_cast<const uint8_t*>(bits);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec == 4 ? launch<4>(q, grid, s, tbl, b, o, h, c, tx_n, static_cast<int>(rows))
                                   : launch<1>(q, grid, s, tbl, b, o, h, c, tx_n, static_cast<int>(rows));
  return static_cast<int>(err);
}
