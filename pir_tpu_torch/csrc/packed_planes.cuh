// The packed-words bit-plane tile: the batched XOR scan of packed_scan.cu
// (kernel 2), of fused_scan_expand.cu's scan items (kernel 5) and of
// planes_scan.cu (kernel 6, after its pack pre-pass) as int8 products on
// the tensor cores. out[q] ^= XOR of the table rows r whose selection bit
// is set, bit j of words[w][q] selecting row 32w + j.
//
// As on the TPU (pir_tpu/ops/pallas_scan.py:_packed_planes_scan_kernel)
// the XOR is taken bit plane by bit plane: plane p of out[q][c] is the
// parity of sum_r sel[q][r] * ((table[r][c] >> p) & 1), an int8 product
// of the selection bits with plane p of the table.
//
// What bounds it: operations, 8 planes x 2 Q H B int8 operations at the
// card's 1979 TOPS; the bytes (table, words and answers read or written
// once) are ~1% of that time. Only wgmma reaches the full int8 rate.
//
// The product: wgmma.mma_async m64n256k32 .s32.s8.s8, N = 8 planes x 32
// byte columns (plane-major: n = 32 p + c), one warpgroup a 64-query
// slice, 2 warpgroups (256 threads, 128 queries) a block.
// - A (64 queries x 32 rows) comes from the packed words in registers.
//   One word covers the 32 rows of one k32 step for one query; an A
//   register holds 4 consecutive k bytes of one query row (the m16n8k32
//   layout, warp w of the group owning rows 16w..16w+15): bits 4t..4t+3
//   (or 16 + 4t..) of its word, spread to bytes of 0 / 1 by spread_nibble
//   in 3 integer operations. No (Q, H) byte matrix exists anywhere.
// - B (32 rows x N) is the table's bit planes in shared memory, K-major
//   with the 128-byte swizzle: each n is a 128-byte row of the stage's 128
//   table rows, 16-byte chunk c stored at chunk c ^ (n % 8). Threads write
//   the planes from the raw stage: a 16-byte load gives 4 rows of a
//   4-byte column word, a 4 x 4 byte transpose (__byte_perm) gives each
//   column's 4 rows, and plane p of such a word is x & (0x01010101 << p):
//   each byte 0 or 2^p (-128 for p = 7, as s8). The plane's parity lands
//   in bit p of its s32 accumulator (sums of 2^p n keep bit p = n mod 2,
//   also if they wrapped), and the epilogue masks it into the answer byte.
// - The raw table and the words of each 128-row stage arrive by cp.async
//   into a ring of kStages stages, kStages - 1 ahead of use; the planes are
//   double-buffered, so a stage's expansion runs while the previous
//   stage's wgmma run (one commit group a stage); see scan_chunk.
//
// Shared-memory budget (the tensor cores' rate, 4096 int8 products a clock
// an SM, against its 128 bytes a clock): a wgmma reads 32 N bytes of B for
// 64 x 32 N products, 64 products a byte, so B reads take 64 B a clock,
// half the budget, whatever N. The plane bytes are written once for the
// block's 128 queries: 256 x 32 bytes a k32 step against two wgmma,
// 32 B a clock. The raw stage (cp.async in, one 16-byte read
// out) and the words add ~10 B a clock: ~105 of 128 B a clock in all.
// Fewer queries a block would raise the plane writes to 64 B a clock,
// over budget (~148 B a clock in all, ~1.16x the products' time); more
// would need more registers than the 128 accumulators a thread the
// m64n256 product keeps. A batch of <= 64 queries still takes that shape
// (kSets = 2, TileShape): both warpgroups take the same 64 queries, each
// with the planes of its own 32 byte columns, so a block covers 64 byte
// columns and does no products for absent queries, where the 128-query
// tile would do twice the products of such a batch.
//
// The block's rows are one chunk of the table, split over blocks by the
// caller; at the end each accumulator's plane bit is packed into the
// answer bytes, a lane and its neighbour (__shfl_xor_sync 1) make a
// 32-bit word of 4 columns, and the word is XORed into the zeroed output
// with atomicXor. XOR does not depend on order, so every run gives equal
// bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pir_planes {

constexpr int kThreads = 256;                 // 2 warpgroups
constexpr int kQueriesPerBlock = 128;         // 64 a warpgroup
constexpr int kStageRows = 128;               // 4 k32 steps
constexpr int kStageWordRows = kStageRows / 32;
constexpr int kStages = 4;                    // ring of raw stages
constexpr int kRawStride = kStageRows + 4;    // words: 4 cw + r spreads the cp.async stores
// |accumulator| <= 128 x rows of a chunk stays inside int32
constexpr long long kMaxChunkRows = 1LL << 24;

constexpr int kCols = 32;                     // byte columns a block
constexpr int kN = 8 * kCols;                 // plane x column: N = 256
constexpr int kColWords = kCols / 4;          // 4-byte column words, one a warp
constexpr int kPlaneBytes = kN * kStageRows;  // one stage's planes
constexpr int kRawWords = kColWords * kRawStride;
constexpr int kWordsStage = kStageWordRows * kQueriesPerBlock;
constexpr int kAcc = kN / 2;                  // accumulators a thread
// planes (2 stages), then the ring of raw stages and words; + 1024 to
// align the planes to the swizzle's 1024-byte repeat
constexpr int kSmemBytes = 2 * kPlaneBytes + kStages * (kRawWords + kWordsStage) * 4 + 1024;

// A block's shape by its sets of planes: kSets = 1 is the tile above (128
// queries, 64 a warpgroup, x 32 byte columns); kSets = 2 the small-batch
// tile (64 queries, both warpgroups, x 64 byte columns, warpgroup g on
// the planes of columns 32 g ..).
template <int kSets>
struct TileShape {
  static_assert(kSets == 1 || kSets == 2, "one or two sets of planes");
  static constexpr int kQueries = kQueriesPerBlock / kSets;
  static constexpr int kColWords = kSets * pir_planes::kColWords;
  static constexpr int kRawWords = kColWords * kRawStride;
  static constexpr int kWordsStage = kStageWordRows * kQueries;
  static constexpr int kStagePlaneBytes = kSets * kPlaneBytes;
  static constexpr int kSmemBytes =
      2 * kStagePlaneBytes + kStages * (kRawWords + kWordsStage) * 4 + 1024;
};
static_assert(TileShape<1>::kSmemBytes == kSmemBytes, "kSets = 1 is the tile");

// Rows of table a block scans, for a grid of `tiles` (query tiles x
// column tiles) blocks a chunk: the h rows split into chunks of whole
// stages until the grid has about target_blocks blocks, at most 65535
// chunks and at most kMaxChunkRows rows a chunk.
inline long long chunk_rows_for(long long tiles, int h, long long target_blocks) {
  constexpr long long kMaxChunks = 65535;
  const long long stages = (h + kStageRows - 1) / kStageRows;
  long long want = target_blocks / tiles;
  if (want < 1) want = 1;
  if (want > stages) want = stages;
  long long per_chunk = (stages + want - 1) / want;
  if ((stages + per_chunk - 1) / per_chunk > kMaxChunks)
    per_chunk = (stages + kMaxChunks - 1) / kMaxChunks;
  if (per_chunk > kMaxChunkRows / kStageRows) per_chunk = kMaxChunkRows / kStageRows;
  return per_chunk * kStageRows;
}

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

// bits 0..3 of u -> bytes 0..3, each 0 or 1
__device__ __forceinline__ uint32_t spread_nibble(uint32_t u) {
  return ((u & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// B descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  uint64_t d = static_cast<uint64_t>((saddr >> 4) & 0x3FFF);  // start address
  d |= static_cast<uint64_t>(1) << 16;                       // leading offset (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;               // stride offset
  d |= static_cast<uint64_t>(1) << 62;                       // 128-byte swizzle
  return d;
}

// d (64 x N, s32) = a (64 x 32, s8, registers) * B (32 x N, s8, desc) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma(int (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
      "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
      "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
      "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
      "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
      "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
      "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
      "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
      "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
      "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
      "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Byte offset of plane byte (n, k) in a stage's planes: row n of 128 bytes
// (k = 0..127), 16-byte chunk k / 16 stored at chunk (k / 16) ^ (n % 8).
__device__ __forceinline__ int plane_offset(int n, int k) {
  return (n >> 3) * 1024 + (n & 7) * 128 + ((((k >> 4) ^ n) & 7) << 4) + (k & 15);
}

// The raw table words (a [column word][row] tile) and the selection words
// ([word row][query]) of stage s, rows from r0, into ring slot s % kStages;
// zeros past h, bw, w_end (the chunk's end) and q. Always commits a group.
template <int kSets>
__device__ __forceinline__ void issue_stage(const uint32_t* __restrict__ table,
                                            const uint32_t* __restrict__ words, int h, int bw,
                                            int q, int col_w0, int q0, long long r0, int w_end,
                                            bool live, uint32_t* raw, uint32_t* wsh, int slot) {
  using S = TileShape<kSets>;
  constexpr int kRowStep = kThreads / S::kColWords;  // rows between a thread's copies
  const int tid = threadIdx.x;
  if (live) {
    // a 64-bit base for the stage (the same in every thread), 32-bit
    // offsets from it (128 rows of bw < 2^24 words)
    const uint32_t* tb = table + r0 * bw + col_w0;
    const long long rows = h - r0;
    const int cw = tid % S::kColWords, r = tid / S::kColWords;
    const bool col_ok = col_w0 + cw < bw;
    const uint32_t dst = smem_u32(raw + slot * S::kRawWords + cw * kRawStride + r);
#pragma unroll
    for (int m = 0; m < kStageRows / kRowStep; ++m) {
      const bool ok = col_ok && r + m * kRowStep < rows;
      cp_async4(dst + 4 * m * kRowStep, ok ? tb + (r + m * kRowStep) * bw + cw : table, ok);
    }
    constexpr int kWordRowStep = kThreads / S::kQueries;
    const uint32_t* wb = words + (r0 / 32) * q + q0;
    const int wr = tid / S::kQueries, qq = tid % S::kQueries;
    const bool q_ok = q0 + qq < q;
    const long long w_rows = w_end - r0 / 32;
    const uint32_t wdst = smem_u32(wsh + slot * S::kWordsStage + wr * S::kQueries + qq);
#pragma unroll
    for (int m = 0; m < kStageWordRows / kWordRowStep; ++m) {
      const int w = wr + m * kWordRowStep;
      const bool ok = q_ok && w < w_rows;
      cp_async4(wdst + 4 * m * kWordRowStep * S::kQueries,
                ok ? wb + static_cast<long long>(w) * q + qq : words, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A stage's planes into pl (from raw slot `slot`), and this lane's
// selection words of the stage (queries qr and qr + 8 of the block, for
// each k32 step) into w. Warp w expands column words w, w + 8 (kSets = 2),
// each into its set of planes.
template <int kSets>
__device__ __forceinline__ void expand_stage(int slot, uint8_t* pl, const uint32_t* raw,
                                             const uint32_t* wsh, uint32_t (&w)[4][2]) {
  using S = TileShape<kSets>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int set = 0; set < kSets; ++set) {
    const int cw = warp + kColWords * set;
    // rows 4 lane .. 4 lane + 3 of column word cw
    const uint4 v = *reinterpret_cast<const uint4*>(raw + slot * S::kRawWords + cw * kRawStride +
                                                    4 * lane);
    uint32_t x[4];
    transpose4x4(v.x, v.y, v.z, v.w, x);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t mask = 0x01010101u << p;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        *reinterpret_cast<uint32_t*>(pl + set * kPlaneBytes +
                                     plane_offset(kCols * p + 4 * warp + b, 4 * lane)) =
            x[b] & mask;
    }
  }
  const uint32_t* ws = wsh + slot * S::kWordsStage;
  const int qr = 16 * (warp % 4) + (kSets == 1 ? 64 * (warp / 4) : 0) + lane / 4;
#pragma unroll
  for (int ks = 0; ks < kStageWordRows; ++ks) {
    w[ks][0] = ws[ks * S::kQueries + qr];
    w[ks][1] = ws[ks * S::kQueries + qr + 8];
  }
}

// This lane's A registers of a stage, spread from its selection words.
__device__ __forceinline__ void spread_a(const uint32_t (&w)[4][2], uint32_t (&a)[4][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < kStageWordRows; ++ks) {
    const uint32_t lo = w[ks][0] >> (4 * t), hi = w[ks][1] >> (4 * t);
    a[ks][0] = spread_nibble(lo);
    a[ks][1] = spread_nibble(hi);
    a[ks][2] = spread_nibble(lo >> 16);
    a[ks][3] = spread_nibble(hi >> 16);
  }
}

// The stage's 4 wgmma (planes at shared address pl) as one group; the
// first of a chunk overwrites the accumulators (scale-d 0), so they need
// no zeroing by other instructions.
__device__ __forceinline__ void issue_products(int (&acc)[kAcc], const uint32_t (&a)[4][4],
                                               uint32_t pl, bool first) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kStageWordRows; ++ks)
    wgmma(acc, a[ks], desc_sw128(pl + 32 * ks), first && ks == 0 ? 0 : 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The tile of TileShape<kSets> (byte columns from 4 col_w0, queries from
// q0) over rows [r_begin, r_end), r_begin a multiple of kStageRows,
// r_end <= h: table (h, bw) words, words (ceil(h / 32), q), out (q, bw)
// words, XORed in with atomicXor. smem: TileShape<kSets>::kSmemBytes of
// dynamic shared memory.
//
// Stage s's products run while the block expands stage s + 1 into the
// other plane buffer; then each warpgroup waits for its products
// (wait_group 0, in the same iteration) before it spreads stage s + 1's A
// registers. ptxas keeps the wgmma asynchronous only when no other
// instruction touches a register of an unfinished wgmma, and only when
// each group's wait follows it in the loop body; the selection words pass
// through the wait as operands so that the compiler cannot hoist the
// spread above it.
template <int kSets>
__device__ __forceinline__ void scan_chunk(const uint32_t* __restrict__ table,
                                           const uint32_t* __restrict__ words,
                                           uint32_t* __restrict__ out, int h, int bw, int q,
                                           int col_w0, int q0, long long r_begin, long long r_end,
                                           uint8_t* smem) {
  const int n_stages = static_cast<int>((r_end - r_begin + kStageRows - 1) / kStageRows);
  if (n_stages <= 0) return;
  using S = TileShape<kSets>;
  const int w_end = static_cast<int>((r_end + 31) / 32);
  // planes 1024-byte aligned; offsets from smem keep every access in the
  // shared window (st.shared, not generic stores)
  const uint32_t base = smem_u32(smem);
  uint8_t* planes = smem + (((base + 1023) & ~1023u) - base);
  uint32_t* raw = reinterpret_cast<uint32_t*>(planes + 2 * S::kStagePlaneBytes);
  uint32_t* wsh = raw + kStages * S::kRawWords;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this warpgroup's set of planes, its queries and its column words
  const int set_bytes = kSets == 2 ? (warp / 4) * kPlaneBytes : 0;
  const int q_wg = q0 + (kSets == 1 ? 64 * (warp / 4) : 0);
  const int col_wg = col_w0 + (kSets == 2 ? kColWords * (warp / 4) : 0);
  auto issue = [&](int s) {  // stage s's copies, into the slot stage s - kStages used
    issue_stage<kSets>(table, words, h, bw, q, col_w0, q0,
                       r_begin + static_cast<long long>(s) * kStageRows, w_end, s < n_stages, raw,
                       wsh, s % kStages);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  uint32_t w[4][2], a[4][4];
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
  __syncthreads();
  expand_stage<kSets>(0, planes, raw, wsh, w);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // planes -> wgmma
  issue(kStages - 1);
  spread_a(w, a);
  __syncthreads();

  int acc[kAcc];
  for (int s = 0; s < n_stages; ++s) {
    issue_products(acc, a, smem_u32(planes + (s & 1) * S::kStagePlaneBytes + set_bytes),
                   s == 0);
    const bool more = s + 1 < n_stages;
    if (more) {
      // stage s + 1 landed; stage s - 1's products, which read its plane
      // buffer, finished before the barrier that ended the last iteration
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
      __syncthreads();
      expand_stage<kSets>((s + 1) % kStages, planes + ((s + 1) & 1) * S::kStagePlaneBytes, raw,
                          wsh, w);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // planes -> wgmma
      issue(s + kStages);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n"
                 : "+r"(w[0][0]), "+r"(w[0][1]), "+r"(w[1][0]), "+r"(w[1][1]), "+r"(w[2][0]),
                   "+r"(w[2][1]), "+r"(w[3][0]), "+r"(w[3][1])
                 :
                 : "memory");
    if (more) spread_a(w, a);
    __syncthreads();  // both warpgroups' products of stage s are done
  }

  // accumulator 4 j + i: query 16 (warp % 4) + g (+ 8 for i >= 2) of the
  // warpgroup's 64, n = 8 j + 2 t + (i & 1), so plane j / 4 of byte
  // column 8 (j % 4) + 2 t + (i & 1); plane p's parity is its
  // bit p. Lanes t and t ^ 1 hold the two halves of a 4-byte word.
  constexpr int kGroups = kCols / 8;
#pragma unroll
  for (int cb = 0; cb < kGroups; ++cb) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        lo |= static_cast<uint32_t>(acc[4 * (kGroups * p + cb) + 2 * half]) & (1u << p);
        hi |= static_cast<uint32_t>(acc[4 * (kGroups * p + cb) + 2 * half + 1]) & (1u << p);
      }
      const uint32_t v = lo | (hi << 8);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, v, 1);
      const int qi = q_wg + 16 * (warp % 4) + g + 8 * half;
      const int col_w = col_wg + (8 * cb + 2 * t) / 4;
      const uint32_t word = v | (other << 16);
      if ((t & 1) == 0 && qi < q && col_w < bw && word)
        atomicXor(out + static_cast<long long>(qi) * bw + col_w, word);
    }
  }
}

}  // namespace pir_planes
