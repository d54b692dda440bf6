// Batched Montgomery modexps (kernel 9) and the single-server cPIR scan
// (kernel 10) for Paillier on the card.
//
// Replaces no Pallas kernel: pir_tpu/crypto/mont_tpu.py is jitted jnp
// (mont_exp, _powmod_core, _scan_chunk, _tree_product), which JAX fuses
// into one executable. Run eagerly in PyTorch it would be some 3 million
// small launches a batch (L = 144 radix-2^15 limbs a product at N^2 of a
// 1024-bit key, ~2,560 products a 2048-bit exponent), hence these kernels.
//
//   kernel 9, mont_powmod_kernel: out[i] = base[i]^e[i] mod m[i], one
//     modulus or a modulus per row (the CRT halves of the secret-key
//     batches share a launch); the counterpart of _powmod_core,
//     tpu_powmod_batch and tpu_powmod_batch_multi.
//   kernel 10, mont_table_kernel, mont_scan_kernel, then
//     mont_merge_kernel: out[w] = prod_r base[r]^e[r][w] mod m; the
//     counterpart of _scan_chunk, _tree_product and tpu_paillier_scan.
//     Exponent 0 gives the identity, the reference's `continue` on slots
//     out of range.
//
// Design: every Montgomery product runs on a group of G lanes of a warp
// with each lane's K words in registers (mont.cuh's group_mul), so a
// modexp's serial chain is L_pad rounds of a few dependent instructions,
// not L^2, and a batch of 64-1024 modexps fills the card. crypto/mont.py's
// planners (powmod_plan, scan_plan) pick G, K, the window and the
// chunking from a cost model; K is a template argument (the LANE_WORDS
// instances below), everything else is a runtime value, so nothing is
// compiled per shape.
//   - Kernel 9: one group a modexp, its window table (2^wbits entries) in
//     shared memory, lane l's words of entry e at (e K + k) 32 + lane: each
//     lane reads only what it wrote, with no barrier.
//   - Kernel 10: mont_table_kernel builds every row's table once (one group
//     a row, into global scratch, (row, entry, word, lane) order); a block
//     of mont_scan_kernel copies its chunk's tables into shared memory and
//     runs one group a column over the chunk's rows: Straus (squarings
//     shared by the rows, one partial a chunk) or Horner (one partial a
//     window, no squarings in the chunk); every group of a warp reads the
//     same table words at once (a broadcast). mont_merge_kernel (one group
//     a column) multiplies the chunks' partials by Horner's rule and
//     leaves the domain. Blocks run in no order and carry nothing over.
//
// Data-oblivious: exponent bits build masks only (mont.cuh): every window
// runs, the digit's table entry is read by masking all of them, and a
// product's final subtraction is a select. The loops depend on L, e_max
// and the row counts alone, so the secret-key batches (decryption, DDLEQ
// proofs) run the same instructions whatever their exponents.
//
// What bounds it on an H100: integer multiply-adds. A Montgomery product
// of L words needs 2 L^2 + L wide (32 x 32 -> 64) products; a wide product
// is two 32-bit integer multiply results, at 64 a clock an SM (the INT32
// rate, 16.75 T results/s over 132 SMs), so the least time of P products is
// P (2 L^2 + L) x 2 / 16.75e12 s, at the fewest products the function
// needs over every fixed window. The bytes are small beside it (a
// 2048-bit N^2 scan of 2^20 24-bit exponents reads 4 MiB). chip_smoke.py
// reckons the bound, counts the SASS of a round by pipe in phase 1
// (mont_sass_counts), and reports both.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

using pir_mont::bad_group;
using pir_mont::LaneGroup;
using pir_mont::Layout;

// Threads a block of the scan kernel may hold at K words a lane: its
// registers (about 6 K + 32 a thread) must fit an SM's 65,536.
constexpr int scan_threads(int K) { return K <= 4 ? 1024 : K <= 8 ? 512 : K <= 16 ? 256 : 128; }

// kernel 9. base: (B, Lw) words; e: (B, ew); n, r2, one: (B, L_pad) words
// when per_row, else (1, L_pad); n0inv: (B,) or (1,); out: (B, Lw).
// Shared memory: 2^wbits K 32 words a warp.
template <int K>
__global__ void __launch_bounds__(128)
mont_powmod_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ e,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ n,
                   const uint32_t* __restrict__ n0inv, const uint32_t* __restrict__ r2,
                   const uint32_t* __restrict__ one, int B, int Lw, int ew, int e_max, int wbits,
                   int G, int per_row) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31, l = lane % G, Lp = G * K;
  const long long grp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long row = grp < B ? grp : B - 1;  // past the end: the last row again
  const long long c = per_row ? row : 0;
  LaneGroup<K> g = LaneGroup<K>::make(G, l, n + c * Lp, n0inv[c]);
  uint32_t* tbl = smem + (long long)(threadIdx.x >> 5) * ((long long)K * 32 << wbits) + lane - l;
  pir_mont::powmod_chain(g, base + row * Lw, Lw, e + row * ew, ew, e_max, wbits, r2 + c * Lp,
                         one + c * Lp, tbl, Layout{(long long)K * 32, 32, 1}, out + row * Lw);
}

// kernel 10, tables: rows (rows, Lw) words < m -> tables (rows, 2^wbits,
// K, G) words, one group a row.
template <int K>
__global__ void __launch_bounds__(128)
mont_table_kernel(const uint32_t* __restrict__ bases, uint32_t* __restrict__ tables,
                  const uint32_t* __restrict__ n, uint32_t n0inv, const uint32_t* __restrict__ r2,
                  const uint32_t* __restrict__ one, int rows, int Lw, int wbits, int G) {
  const int l = (threadIdx.x & 31) % G, Lp = G * K;
  const long long grp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long row = grp < rows ? grp : rows - 1;
  LaneGroup<K> g = LaneGroup<K>::make(G, l, n, n0inv);
  pir_mont::table_chain(g, bases + row * Lw, Lw, r2, one, wbits,
                        tables + (row * Lp << wbits), Layout{(long long)K * G, G, 1});
}

// kernel 10, chunks: grid (column tiles, chunks of this launch); chunk c =
// chunk0 + blockIdx.y takes rows [c rc, min(h, (c + 1) rc)), whose tables
// start at tables + (c rc - row0) 2^wbits L_pad words. e: (h, w, ew);
// partials: (chunks, P, w, L_pad) words, P = the windows (horner) or 1.
// Shared memory: rc 2^wbits L_pad words. kThreads = scan_threads(K), a
// template argument: its registers bound the instance.
template <int K, int kThreads>
__global__ void __launch_bounds__(kThreads)
mont_scan_kernel(const uint32_t* __restrict__ tables, const uint32_t* __restrict__ e,
                 uint32_t* __restrict__ partials, const uint32_t* __restrict__ n, uint32_t n0inv,
                 int h, int w, int ew, int e_max, int wbits, int G, int rc, int horner, int row0,
                 int chunk0) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int Lp = G * K;
  const long long row_words = (long long)Lp << wbits;
  const int chunk = chunk0 + blockIdx.y, r0 = chunk * rc;
  const int rows = rc < h - r0 ? rc : h - r0;
  const uint4* src = reinterpret_cast<const uint4*>(tables + (long long)(r0 - row0) * row_words);
  for (long long i = threadIdx.x; i < rows * row_words / 4; i += blockDim.x) smem4[i] = src[i];
  __syncthreads();
  const int l = threadIdx.x % G;
  const long long grp = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const long long col = grp < w ? grp : w - 1;
  LaneGroup<K> g = LaneGroup<K>::make(G, l, n, n0inv);
  const int nwin = (e_max + wbits - 1) / wbits, P = horner ? nwin : 1;
  pir_mont::scan_chain(g, smem, row_words, Layout{(long long)K * G, G, 1}, rows,
                       e + ((long long)r0 * w + col) * ew, (long long)w * ew, ew, e_max, wbits,
                       horner, partials + ((long long)chunk * P * w + col) * Lp,
                       (long long)w * Lp);
}

// kernel 10, merge: one group a column; out (w, Lw) words < m.
template <int K>
__global__ void __launch_bounds__(128)
mont_merge_kernel(const uint32_t* __restrict__ partials, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ n, uint32_t n0inv, int chunks, int P, int w,
                  int Lw, int wbits, int G) {
  const int l = (threadIdx.x & 31) % G, Lp = G * K;
  const long long grp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long col = grp < w ? grp : w - 1;
  LaneGroup<K> g = LaneGroup<K>::make(G, l, n, n0inv);
  pir_mont::merge_chain(g, partials + col * Lp, (long long)P * w * Lp, (long long)w * Lp, chunks,
                        P, wbits, out + col * Lw, Lw);
}

template <class Kern>
cudaError_t allow_smem(Kern kernel, long long bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(bytes))
                           : cudaSuccess;
}


template <int K>
int launch_powmod(dim3 grid, int threads, long long smem, cudaStream_t s, const uint32_t* base,
                  const uint32_t* e, uint32_t* out, const uint32_t* n, const uint32_t* n0inv,
                  const uint32_t* r2, const uint32_t* one, int b, int Lw, int ew, int e_max,
                  int wbits, int G, int per_row) {
  const cudaError_t err = allow_smem(mont_powmod_kernel<K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mont_powmod_kernel<K><<<grid, threads, smem, s>>>(base, e, out, n, n0inv, r2, one, b, Lw, ew,
                                                    e_max, wbits, G, per_row);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_tables(dim3 grid, cudaStream_t s, const uint32_t* bases, uint32_t* tables,
                  const uint32_t* n, uint32_t n0inv, const uint32_t* r2, const uint32_t* one,
                  int rows, int Lw, int wbits, int G) {
  mont_table_kernel<K><<<grid, 128, 0, s>>>(bases, tables, n, n0inv, r2, one, rows, Lw, wbits, G);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_scan(dim3 grid, int threads, long long smem, cudaStream_t s, const uint32_t* tables,
                const uint32_t* e, uint32_t* partials, const uint32_t* n, uint32_t n0inv, int h,
                int w, int ew, int e_max, int wbits, int G, int rc, int horner, int chunk0) {
  constexpr int kThreads = scan_threads(K);
  const cudaError_t err = allow_smem(mont_scan_kernel<K, kThreads>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mont_scan_kernel<K, kThreads><<<grid, threads, smem, s>>>(
      tables, e, partials, n, n0inv, h, w, ew, e_max, wbits, G, rc, horner, chunk0 * rc, chunk0);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_merge(dim3 grid, cudaStream_t s, const uint32_t* partials, uint32_t* out,
                 const uint32_t* n, uint32_t n0inv, int chunks, int P, int w, int Lw, int wbits,
                 int G) {
  mont_merge_kernel<K><<<grid, 128, 0, s>>>(partials, out, n, n0inv, chunks, P, w, Lw, wbits, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The device's shared memory a block may opt in to, in bytes.
extern "C" int pir_mont_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// Kernel 9 over b rows, `warps` warps a block, G lanes of K words a
// modexp. Returns cudaGetLastError() after the launch.
extern "C" int pir_mont_powmod(const void* base, const void* e, void* out, const void* n,
                               const void* n0inv, const void* r2, const void* one, int b, int Lw,
                               int ew, int e_max, int wbits, int G, int K, int per_row, int warps,
                               void* stream) {
  if (b < 1 || ew < 1 || e_max < 1 || (e_max + 31) / 32 > ew || warps < 1 || warps > 4 ||
      bad_group(G, K, Lw, wbits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 32 * warps;
  const long long groups_per_block = threads / G;
  const dim3 grid(static_cast<unsigned>((b + groups_per_block - 1) / groups_per_block));
  const long long smem = (long long)warps * ((long long)K * 32 << wbits) * 4;
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define PIR_MONT_CASE(KK)                                                                       \
  case KK:                                                                                      \
    return launch_powmod<KK>(grid, threads, smem, s, static_cast<const uint32_t*>(base),        \
                             static_cast<const uint32_t*>(e), static_cast<uint32_t*>(out),      \
                             static_cast<const uint32_t*>(n), static_cast<const uint32_t*>(n0inv), \
                             static_cast<const uint32_t*>(r2), static_cast<const uint32_t*>(one), \
                             b, Lw, ew, e_max, wbits, G, per_row);
    PIR_MONT_LANE_WORDS(PIR_MONT_CASE)
#undef PIR_MONT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 10's tables for `rows` rows (bases at Lw words): tables (rows,
// 2^wbits, K, G) words.
extern "C" int pir_mont_tables(const void* bases, void* tables, const void* n, unsigned n0inv,
                               const void* r2, const void* one, int rows, int Lw, int wbits,
                               int G, int K, void* stream) {
  if (rows < 1 || bad_group(G, K, Lw, wbits)) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = 128 / G;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define PIR_MONT_CASE(KK)                                                                       \
  case KK:                                                                                      \
    return launch_tables<KK>(grid, s, static_cast<const uint32_t*>(bases),                      \
                             static_cast<uint32_t*>(tables), static_cast<const uint32_t*>(n),   \
                             n0inv, static_cast<const uint32_t*>(r2),                           \
                             static_cast<const uint32_t*>(one), rows, Lw, wbits, G);
    PIR_MONT_LANE_WORDS(PIR_MONT_CASE)
#undef PIR_MONT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 10's chunks [chunk0, chunk0 + chunks) of an (h, w) exponent
// matrix, `cols` columns (groups) a block; tables hold rows from row0 =
// chunk0 rc on. partials: (all chunks, P, w, G K) words.
extern "C" int pir_mont_scan(const void* tables, const void* e, void* partials, const void* n,
                             unsigned n0inv, int h, int w, int ew, int e_max, int wbits, int G,
                             int K, int rc, int horner, int cols, int chunk0, int chunks,
                             void* stream) {
  const long long threads = (long long)cols * G;
  if (h < 1 || w < 1 || rc < 1 || ew < 1 || e_max < 1 || (e_max + 31) / 32 > ew ||
      chunks < 1 || chunks > 65535 || chunk0 < 0 || (long long)(chunk0 + chunks - 1) * rc >= h ||
      threads % 32 || threads > scan_threads(K) || bad_group(G, K, 1, wbits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((w + cols - 1) / cols), static_cast<unsigned>(chunks));
  const long long smem = ((long long)rc * G * K << wbits) * 4;
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define PIR_MONT_CASE(KK)                                                                       \
  case KK:                                                                                      \
    return launch_scan<KK>(grid, static_cast<int>(threads), smem, s,                            \
                           static_cast<const uint32_t*>(tables), static_cast<const uint32_t*>(e), \
                           static_cast<uint32_t*>(partials), static_cast<const uint32_t*>(n),   \
                           n0inv, h, w, ew, e_max, wbits, G, rc, horner, chunk0);
    PIR_MONT_LANE_WORDS(PIR_MONT_CASE)
#undef PIR_MONT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 10's merge: out (w, Lw) words from (chunks, P, w, G K) partials.
extern "C" int pir_mont_merge(const void* partials, void* out, const void* n, unsigned n0inv,
                              int chunks, int P, int w, int Lw, int wbits, int G, int K,
                              void* stream) {
  if (chunks < 1 || P < 1 || w < 1 || bad_group(G, K, Lw, wbits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = 128 / G;
  const dim3 grid(static_cast<unsigned>((w + per_block - 1) / per_block));
  auto s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define PIR_MONT_CASE(KK)                                                                       \
  case KK:                                                                                      \
    return launch_merge<KK>(grid, s, static_cast<const uint32_t*>(partials),                    \
                            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(n), n0inv, \
                            chunks, P, w, Lw, wbits, G);
    PIR_MONT_LANE_WORDS(PIR_MONT_CASE)
#undef PIR_MONT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
