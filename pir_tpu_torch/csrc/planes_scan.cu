// Batched XOR scan as int8 bit-plane products on the tensor cores (kernel 6).
//
// Replaces the TPU kernel pir_tpu/ops/pallas_scan.py:mxu_batched_scan_pallas
// (_planes_scan_kernel): table (h, B) uint8 and selection bits (q, h) {0, 1}
// uint8 give out (q, B) uint8, row i the XOR of the table rows query i
// selects. As on the TPU the XOR is taken bit plane by bit plane: plane p of
// the answer is the parity of the int8 product bits x plane_p(table), with
// plane_p(table)[r][b] = (table[r][b] >> p) & 1.
//
// What bounds it on an H100: operations. 8 planes x 2 q h B int8 operations
// (1 GiB table: 0.556 ms at Q = 64, 8.89 ms at Q = 1024, at 1979 TOPS)
// against bytes read once (table, bits, output: 0.34 / 0.64 ms at 3.35 TB/s).
//
// Design. The TPU kernel keeps a resident accumulator across a sequential
// row grid. Blocks on the GPU run in no order, so the rows are split into
// chunks across blocks (grid.z), each block owning a tile of 16 MF queries x
// 64 byte columns over one chunk; at the end it takes each accumulator's
// parity, packs the 8 planes into the answer byte, and XORs the bytes into
// the zeroed output with atomicXor on 32-bit words. XOR does not depend on
// order, so every run gives equal bytes.
// - Per tile of 256 rows, the block stages the bits (16 MF queries x 256
//   rows) and the table (256 rows x 64 bytes) in shared memory. The table
//   tile is stored transposed, [byte column][row], 4 rows a 32-bit word (a
//   4 x 4 byte transpose in registers), so one 32-bit load gives a column's
//   bytes of the 4 rows an mma B fragment register covers, and the 8 bit
//   planes of that register are (x >> p) & 0x01010101: the planes are
//   unpacked from the u8 tile in registers and never stored.
// - Each warp owns 8 byte columns (one n8 fragment column per plane) and all
//   16 MF queries; per k32 step it issues MF x 8 mma.sync m16n8k32 s8 x s8 ->
//   s32, accumulating in int32 (exact: a chunk has < 2^31 rows).
// - The next tile's global loads are issued into registers before the
//   current tile's products, so they overlap.
// - Row strides of 68 words keep every fragment load and every transposed
//   store free of shared-memory bank conflicts.
// - Any q >= 1 (queries past q load zero bits and are not stored; MF = 1, 2
//   or 4 fits the tile to small batches), any h (rows past h load zeros),
//   any B % 4 == 0 (columns past B load zeros and are not stored). 16-byte
//   loads where the shapes allow them (B % 16 == 0, h % 16 == 0 and aligned
//   pointers), 4-byte and 1-byte loads otherwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerWarp = 8;                        // bytes: one n8 fragment
constexpr int kColsPerBlock = kWarps * kColsPerWarp;  // 64 bytes
constexpr int kTileRows = 256;                         // 8 k32 steps
constexpr int kTileWords = kTileRows / 4;
constexpr int kStride = kTileWords + 4;  // 68 words: 4 g + t spreads the 32 banks
constexpr int kTargetBlocks = 8 * 132;   // ~8 blocks an SM over the grid
constexpr int kMaxGridYZ = 65535;

template <int MF>
struct Shared {
  uint32_t table_t[kColsPerBlock][kStride];  // [byte column][4 rows a word]
  uint32_t bits[MF * 16][kStride];           // [query][4 rows a word]
};

// o[j] holds byte j of w0, w1, w2, w3 (in that byte order): a 4 x 4 byte
// transpose of four rows' words into four columns' words.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t (&o)[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One tile's global data in registers: this thread's 4 rows x 16 bytes of
// the table (kw = its 4-row group, c16 = its 16-byte column group), and MF
// 16-byte pieces of the bits.
template <int MF>
struct TileRegs {
  uint32_t table[4][4];  // [row][word]
  uint4 bits[MF];
};

template <int MF, bool VEC_T, bool VEC_B>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ table,
                                          const uint8_t* __restrict__ bits, int h, int bw, int q,
                                          long long r0, int col_w0, int q0, TileRegs<MF>& regs) {
  const int tid = threadIdx.x;
  const int kw = tid % kTileWords;
  const int c16 = tid / kTileWords;
  const int cw = col_w0 + 4 * c16;  // first of this thread's 4 table words
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + 4 * kw + i;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(table) + r * bw;
    if (VEC_T) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < h && cw < bw) v = __ldg(reinterpret_cast<const uint4*>(row + cw));
      regs.table[i][0] = v.x;
      regs.table[i][1] = v.y;
      regs.table[i][2] = v.z;
      regs.table[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) regs.table[i][j] = (r < h && cw + j < bw) ? __ldg(row + cw + j) : 0u;
    }
  }
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    const int idx = tid + kThreads * m;
    const int qi = q0 + idx / 16;
    const long long r = r0 + 16 * (idx % 16);
    const uint8_t* src = bits + static_cast<long long>(qi) * h + r;
    if (VEC_B) {
      regs.bits[m] = (qi < q && r < h) ? __ldg(reinterpret_cast<const uint4*>(src))
                                       : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t x = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const long long rr = r + 4 * e + k;
          if (qi < q && rr < h) x |= static_cast<uint32_t>(__ldg(src + 4 * e + k)) << (8 * k);
        }
        w[e] = x;
      }
      regs.bits[m] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int MF>
__device__ __forceinline__ void store_tile(const TileRegs<MF>& regs, Shared<MF>& sh) {
  const int tid = threadIdx.x;
  const int kw = tid % kTileWords;
  const int c16 = tid / kTileWords;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t o[4];
    transpose4x4(regs.table[0][j], regs.table[1][j], regs.table[2][j], regs.table[3][j], o);
#pragma unroll
    for (int b = 0; b < 4; ++b) sh.table_t[16 * c16 + 4 * j + b][kw] = o[b];
  }
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    const int idx = tid + kThreads * m;
    *reinterpret_cast<uint4*>(&sh.bits[idx / 16][4 * (idx % 16)]) = regs.bits[m];
  }
}

template <int MF, bool VEC_T, bool VEC_B>
__global__ void __launch_bounds__(kThreads, 1)
planes_scan_kernel(const uint8_t* __restrict__ table,  // (h, 4 bw)
                   const uint8_t* __restrict__ bits,   // (q, h) {0, 1}
                   uint32_t* __restrict__ out,         // (q, bw) words, zeroed
                   int h, int bw, int q, long long chunk_rows) {
  __shared__ __align__(16) Shared<MF> sh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment group
  const int t = lane % 4;  // thread in group
  const int col_w0 = blockIdx.x * (kColsPerBlock / 4);
  const int q0 = blockIdx.y * MF * 16;
  const long long r_begin = blockIdx.z * chunk_rows;
  const long long r_end = min(static_cast<long long>(h), r_begin + chunk_rows);
  const int n0 = warp * kColsPerWarp;

  int acc[MF][8][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][p][i] = 0;

  TileRegs<MF> regs;
  load_tile<MF, VEC_T, VEC_B>(table, bits, h, bw, q, r_begin, col_w0, q0, regs);
  for (long long r0 = r_begin; r0 < r_end; r0 += kTileRows) {
    __syncthreads();  // the previous tile's fragments are read
    store_tile<MF>(regs, sh);
    __syncthreads();
    if (r0 + kTileRows < r_end)
      load_tile<MF, VEC_T, VEC_B>(table, bits, h, bw, q, r0 + kTileRows, col_w0, q0, regs);
#pragma unroll 2
    for (int ks = 0; ks < kTileRows / 32; ++ks) {
      const int w = 8 * ks + t;  // word of rows 32 ks + 4 t .. + 3; + 4: rows + 16
      uint32_t a[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        a[f][0] = sh.bits[16 * f + g][w];
        a[f][1] = sh.bits[16 * f + g + 8][w];
        a[f][2] = sh.bits[16 * f + g][w + 4];
        a[f][3] = sh.bits[16 * f + g + 8][w + 4];
      }
      const uint32_t x0 = sh.table_t[n0 + g][w];
      const uint32_t x1 = sh.table_t[n0 + g][w + 4];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t b0 = (x0 >> p) & 0x01010101u;
        const uint32_t b1 = (x1 >> p) & 0x01010101u;
#pragma unroll
        for (int f = 0; f < MF; ++f) mma_s8(acc[f][p], a[f], b0, b1);
      }
    }
  }

  // accumulator i of a fragment: query 16 f + g (+ 8 for i >= 2), byte
  // column n0 + 2 t + (i & 1); lanes t and t ^ 1 hold the two halves of a word
#pragma unroll
  for (int f = 0; f < MF; ++f) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        lo |= static_cast<uint32_t>(acc[f][p][2 * half] & 1) << p;
        hi |= static_cast<uint32_t>(acc[f][p][2 * half + 1] & 1) << p;
      }
      const uint32_t v = lo | (hi << 8);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, v, 1);
      const int qi = q0 + 16 * f + g + 8 * half;
      const int col_w = col_w0 + (n0 + 2 * t) / 4;
      const uint32_t word = v | (other << 16);
      if ((t & 1) == 0 && qi < q && col_w < bw && word)
        atomicXor(out + static_cast<long long>(qi) * bw + col_w, word);
    }
  }
}

template <int MF>
cudaError_t launch(const uint8_t* table, const uint8_t* bits, uint32_t* out, int h, int bw, int q,
                   bool vec_t, bool vec_b, cudaStream_t stream) {
  const long long col_tiles = (4LL * bw + kColsPerBlock - 1) / kColsPerBlock;
  const long long q_tiles = (q + MF * 16 - 1) / (MF * 16);
  if (q_tiles > kMaxGridYZ || col_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long tiles = (h + kTileRows - 1) / kTileRows;
  long long want = kTargetBlocks / (col_tiles * q_tiles);
  if (want < 1) want = 1;
  if (want > tiles) want = tiles;
  long long per_chunk = (tiles + want - 1) / want;
  if ((tiles + per_chunk - 1) / per_chunk > kMaxGridYZ) per_chunk = (tiles + kMaxGridYZ - 1) / kMaxGridYZ;
  const long long chunks = (tiles + per_chunk - 1) / per_chunk;
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(q_tiles),
                  static_cast<unsigned>(chunks));
  const long long chunk_rows = per_chunk * kTileRows;
#define PIR_PLANES_SCAN_CASE(VT, VB)                                                         \
  if (vec_t == VT && vec_b == VB)                                                            \
    planes_scan_kernel<MF, VT, VB><<<grid, kThreads, 0, stream>>>(table, bits, out, h, bw, q, \
                                                                  chunk_rows);
  PIR_PLANES_SCAN_CASE(true, true)
  PIR_PLANES_SCAN_CASE(true, false)
  PIR_PLANES_SCAN_CASE(false, true)
  PIR_PLANES_SCAN_CASE(false, false)
#undef PIR_PLANES_SCAN_CASE
  return cudaGetLastError();
}

}  // namespace

// table: (h, 4 bw) uint8 rows, 16-byte aligned when vec_table (then bw % 4
// == 0); bits: (q, h) bytes {0, 1}, 16-byte aligned with h % 16 == 0 when
// vec_bits; out: (q, bw) words, zeroed by the caller. q, h, bw >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int pir_planes_scan(const void* table, const void* bits, void* out, int h, int bw,
                               int q, int vec_table, int vec_bits, void* stream) {
  if (q < 1 || h < 1 || bw < 1 || (vec_table && bw % 4) || (vec_bits && h % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* tbl = static_cast<const uint8_t*>(table);
  const auto* b = static_cast<const uint8_t*>(bits);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q <= 16)
    err = launch<1>(tbl, b, o, h, bw, q, vec_table != 0, vec_bits != 0, s);
  else if (q <= 32)
    err = launch<2>(tbl, b, o, h, bw, q, vec_table != 0, vec_bits != 0, s);
  else
    err = launch<4>(tbl, b, o, h, bw, q, vec_table != 0, vec_bits != 0, s);
  return static_cast<int>(err);
}
