// Batched XOR scan from unpacked selection bytes, as int8 bit-plane
// products on the tensor cores (kernel 6).
//
// Replaces the TPU kernel pir_tpu/ops/pallas_scan.py:mxu_batched_scan_pallas
// (_planes_scan_kernel): table (h, B) uint8 and selection bytes (q, h)
// give out (q, B) uint8, row i the XOR of the table rows query i selects
// (bit 0 of each byte; the product's parity, as the plain version's, sees
// no other bit). As on the TPU the XOR is taken bit plane by bit plane:
// plane p of the answer is the parity of the int8 product of the
// selection bits with plane_p(table)[r][b] = (table[r][b] >> p) & 1.
//
// What bounds it on an H100: operations. 8 planes x 2 q h B int8
// operations (1 GiB table: 0.556 ms at Q = 64, 8.89 ms at Q = 1024, at
// 1979 TOPS) against bytes read once (table, bytes, output: 0.34 / 0.64 ms
// at 3.35 TB/s).
//
// Design: kernel 2's wgmma tile (packed_planes.cuh: m64n256k32 s8, A
// spread from packed selection words in registers, B the table's bit
// planes in swizzled shared memory from cp.async stages) after a pack
// pre-pass. The pre-pass packs the (q, h) bytes into the tile's (ceil(h /
// 32), q) words, bit j of word w the byte of row 32 w + j, rows past h
// zero: one thread a word, 32 bytes read as two 16-byte loads where the
// shapes allow it (h % 16 == 0, bytes 16-byte aligned), byte loads
// otherwise. It reads the q h bytes once (0.02 ms at Q = 64, 0.32 ms at
// Q = 1024 on the 1 GiB table) and writes an eighth of that. A batch of
// <= 64 queries scans on the small-batch tile (kSets = 2: 64 queries x
// 64 byte columns a block, no products for absent queries); larger ones
// on the 128-query tile. Rows are split into chunks over grid.z until the
// grid has ~8 blocks an SM, and the partial parities are XORed into the
// zeroed answers with atomicXor (XOR is order-free: every run gives equal
// bytes). One block an SM (128 accumulators a thread).

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_planes.cuh"

namespace {

constexpr int kTargetBlocks = 8 * 132;  // ~8 blocks an SM over the grid
constexpr int kMaxGridY = 65535;
constexpr int kPackThreads = 256;
constexpr int kSmallBatch = pir_planes::TileShape<2>::kQueries;  // 64

// Bit 0 of each of x's 4 bytes -> bits 0..3: the multiply moves byte i's
// bit to bit 24 + i with no carry into bits 24..27.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
}

// words[w][qi] (w < ceil(h / 32), qi < q; word index w q + qi, one a
// thread, queries fastest): bit j = bit 0 of bits[qi][32 w + j], zero
// past h. vec: h % 16 == 0 and bits 16-byte aligned.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint8_t* __restrict__ bits, uint32_t* __restrict__ words, int h, int q,
            long long n_words, int vec) {
  const long long i = static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (i >= n_words) return;
  const long long w = i / q;
  const uint8_t* src = bits + (i - w * q) * static_cast<long long>(h) + 32 * w;
  uint32_t word = 0;
  if (vec && 32 * w + 32 <= h) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    word = pack16(__ldg(s4)) | pack16(__ldg(s4 + 1)) << 16;
  } else {
    for (int j = 0; j < 32 && 32 * w + j < h; ++j) word |= (__ldg(src + j) & 1u) << j;
  }
  words[i] = word;
}

template <int kSets>
__global__ void __launch_bounds__(pir_planes::kThreads, 1)
planes_scan_kernel(const uint32_t* __restrict__ table,  // (h, bw) words
                   const uint32_t* __restrict__ words,  // (ceil(h / 32), q)
                   uint32_t* __restrict__ out,          // (q, bw), zeroed
                   int h, int bw, int q, long long chunk_rows) {
  using S = pir_planes::TileShape<kSets>;
  extern __shared__ uint8_t smem[];
  const long long r_begin = blockIdx.z * chunk_rows;
  const long long r_end = min(static_cast<long long>(h), r_begin + chunk_rows);
  pir_planes::scan_chunk<kSets>(table, words, out, h, bw, q, blockIdx.y * S::kColWords,
                                blockIdx.x * S::kQueries, r_begin, r_end, smem);
}

// Grid: (query tiles, column tiles, row chunks).
template <int kSets>
cudaError_t launch_scan(const uint32_t* table, const uint32_t* words, uint32_t* out, int h,
                        int bw, int q, cudaStream_t stream) {
  using S = pir_planes::TileShape<kSets>;
  const long long q_tiles = (q + S::kQueries - 1) / S::kQueries;
  const long long col_tiles = (bw + S::kColWords - 1) / S::kColWords;
  if (col_tiles > kMaxGridY) return cudaErrorInvalidValue;
  const long long chunk_rows = pir_planes::chunk_rows_for(q_tiles * col_tiles, h, kTargetBlocks);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>((h + chunk_rows - 1) / chunk_rows));
  cudaError_t err = cudaFuncSetAttribute(
      planes_scan_kernel<kSets>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  planes_scan_kernel<kSets><<<grid, pir_planes::kThreads, S::kSmemBytes, stream>>>(
      table, words, out, h, bw, q, chunk_rows);
  return cudaGetLastError();
}

}  // namespace

// table: (h, 4 bw) uint8 rows, 4-byte aligned; bits: (q, h) bytes,
// 16-byte aligned with h % 16 == 0 when vec_bits; words: scratch of
// ceil(h / 32) x q words; out: (q, bw) words, zeroed by the caller.
// q, h, bw >= 1, bw < 2^23. Returns the first CUDA error of the launches.
extern "C" int pir_planes_scan(const void* table, const void* bits, void* words, void* out,
                               int h, int bw, int q, int vec_bits, void* stream) {
  if (q < 1 || h < 1 || bw < 1 || bw >= (1 << 23) || (vec_bits && h % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_words = static_cast<long long>((h + 31) / 32) * q;
  const long long pack_blocks = (n_words + kPackThreads - 1) / kPackThreads;
  if (pack_blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  auto* w = static_cast<uint32_t*>(words);
  pack_kernel<<<static_cast<unsigned>(pack_blocks), kPackThreads, 0, s>>>(
      static_cast<const uint8_t*>(bits), w, h, q, n_words, vec_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tbl = static_cast<const uint32_t*>(table);
  auto* o = static_cast<uint32_t*>(out);
  err = q <= kSmallBatch ? launch_scan<2>(tbl, w, o, h, bw, q, s)
                         : launch_scan<1>(tbl, w, o, h, bw, q, s);
  return static_cast<int>(err);
}
