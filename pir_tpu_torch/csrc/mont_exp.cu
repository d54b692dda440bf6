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
//   kernel 10, mont_scan_kernel then mont_merge_kernel: out[w] = prod_r
//     base[r]^e[r][w] mod m; the counterpart of _scan_chunk, _tree_product
//     and tpu_paillier_scan. Exponent 0 gives the identity, the
//     reference's `continue` on slots out of range.
//
// Design (simple and right first): one thread per modexp (kernel 9) or per
// (column, row chunk) (kernel 10), with the per-thread arithmetic of
// mont.cuh on 32-bit words. A thread's running value and product scratch
// (2 (L + 1) words) lie in shared memory, interleaved [word][thread] so a
// warp's accesses take one pass, where a block's share fits; else in
// global scratch the wrapper allocates, interleaved the same way. Kernel 9
// keeps each thread's window table (2^wbits entries) in global scratch.
// Kernel 10's block takes one chunk of rows and a tile of columns: its
// threads first build the chunk's window tables (base^k, k < 2^wbits, in
// the Montgomery domain) in shared memory, one row a thread, then each
// thread runs Straus's multi-exponentiation for its column over the
// chunk's rows: the squarings are shared by the rows, and every row's
// entry is read by all the block's threads at once (a broadcast). Blocks
// run in no order and carry nothing over, so each writes its Montgomery-
// domain partial product, and mont_merge_kernel (one thread a column)
// multiplies the chunks' partials, leaves the domain and writes the
// fully reduced product. No row count needs to be a power of two.
//
// Data-oblivious: exponent bits build masks only (mont.cuh): every window
// runs, the digit's table entry is read by masking all of them, and a
// product's final subtraction is a select. The loops depend on L, e_max
// and the row counts alone, so the secret-key batches (decryption, DDLEQ
// proofs) run the same instructions whatever their exponents.
//
// What bounds it on an H100: integer multiply-adds. A Montgomery product
// of L words runs 2 L^2 + L wide (32 x 32 -> 64) products; a wide product
// is two 32-bit integer multiply results, at 64 a clock an SM (the INT32
// rate, 16.75 T results/s over 132 SMs), so the least time of P products is
// P (2 L^2 + L) x 2 / 16.75e12 s. The bytes are small beside it (a 2048-bit
// N^2 scan of 2^20 24-bit exponents reads 4 MiB). chip_smoke.py reckons
// the bound from the products each launch runs, counts the SASS of the
// inner loop by pipe in phase 1 (mont_sass_counts), and reports both.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

using pir_mont::CWords;
using pir_mont::Words;

// The thread's value and scratch: 2 (L + 1) words, in shared memory past
// `skip` words when kSmem, else in global `state` ([word][thread] over nth
// threads).
template <bool kSmem>
__device__ __forceinline__ void thread_state(uint32_t* smem, long long skip, uint32_t* state,
                                             long long gtid, long long nth, int L, Words& acc,
                                             Words& t) {
  if constexpr (kSmem) {
    uint32_t* p = smem + skip + threadIdx.x;
    acc = Words{p, (long long)blockDim.x};
    t = Words{p + (long long)(L + 1) * blockDim.x, (long long)blockDim.x};
  } else {
    acc = Words{state + gtid, nth};
    t = Words{state + gtid + (long long)(L + 1) * nth, nth};
  }
}

// kernel 9. base, r2: (B, L) words (r2 (L,) when !per_row); e: (B, ew);
// n: (L, B) words, word-major, when per_row, else (L,); n0inv: (B,) or (1,);
// tables: 2^wbits L words a thread, [word][thread]; out: (B, L).
template <bool kSmem>
__global__ void __launch_bounds__(128)
mont_powmod_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ e,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ n,
                   const uint32_t* __restrict__ n0inv, const uint32_t* __restrict__ r2,
                   uint32_t* state, uint32_t* tables, int B, int L, int ew, int e_max,
                   int wbits, int per_row) {
  extern __shared__ uint32_t smem[];
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const long long nth = (long long)gridDim.x * blockDim.x;
  Words acc{nullptr, 0}, t{nullptr, 0};
  thread_state<kSmem>(smem, 0, state, row, nth, L, acc, t);
  const CWords nv = per_row ? CWords{n + row, B} : CWords{n, 1};
  pir_mont::powmod(CWords{base + row * L, 1}, e + row * ew, 1, e_max, nv,
                   n0inv[per_row ? row : 0], CWords{r2 + (per_row ? row * L : 0), 1}, L, wbits,
                   Words{tables + row, nth}, acc, t, Words{out + row * L, 1});
}

// kernel 10, first pass. grid (column tiles, row chunks); chunk c takes rows
// [c rc, min(h, (c + 1) rc)). Shared memory: n (L words), the chunk's
// tables (rc 2^wbits L words), then, when kSmem, the threads' state.
// bases: (h, L) words < m; e: (h, w, ew); partials: (chunks, L, w) words,
// the chunk's product in the Montgomery domain.
template <bool kSmem>
__global__ void __launch_bounds__(128)
mont_scan_kernel(const uint32_t* __restrict__ bases, const uint32_t* __restrict__ e,
                 uint32_t* __restrict__ partials, const uint32_t* __restrict__ n,
                 uint32_t n0inv, const uint32_t* __restrict__ r2, uint32_t* state, int h, int w,
                 int L, int ew, int e_max, int wbits, int rc) {
  extern __shared__ uint32_t smem[];
  const int chunk = blockIdx.y;
  const int r0 = chunk * rc;
  const int rows = min(rc, h - r0);
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long block_id = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long nth = (long long)gridDim.x * gridDim.y * blockDim.x;
  const long long row_words = (long long)L << wbits;
  uint32_t* ns = smem;
  uint32_t* tables = smem + L;
  Words acc{nullptr, 0}, t{nullptr, 0};
  thread_state<kSmem>(smem, L + rc * row_words, state, block_id * blockDim.x + threadIdx.x, nth,
                      L, acc, t);
  for (int j = threadIdx.x; j < L; j += blockDim.x) ns[j] = n[j];
  __syncthreads();
  const CWords nv{ns, 1};
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    pir_mont::build_table(CWords{bases + (long long)(r0 + r) * L, 1}, CWords{r2, 1}, nv, n0inv,
                          L, wbits, Words{tables + r * row_words, 1}, t);
  __syncthreads();
  if (col >= w) return;
  pir_mont::straus_rows(tables, 1, rows, e + ((long long)r0 * w + col) * ew, (long long)w * ew, 1,
                        e_max, wbits, nv, n0inv, L, acc, t);
  pir_mont::copy_words(acc, Words{partials + (long long)chunk * L * w + col, w}, L);
}

// kernel 10, second pass: one thread a column multiplies the chunks'
// partials, leaves the Montgomery domain and writes out (w, L) words < m.
// state: 2 (L + 1) words a thread, [word][thread].
__global__ void __launch_bounds__(128)
mont_merge_kernel(const uint32_t* __restrict__ partials, uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ n, uint32_t n0inv, uint32_t* state, int chunks,
                  int w, int L) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;
  const long long nth = (long long)gridDim.x * blockDim.x;
  Words acc{state + col, nth}, t{state + col + (long long)(L + 1) * nth, nth};
  const CWords nv{n, 1};
  pir_mont::copy_words(CWords{partials + col, w}, acc, L);
  for (int c = 1; c < chunks; ++c) {
    pir_mont::mont_mul(CWords{partials + (long long)c * L * w + col, w}, acc, nv, n0inv, L, t);
    pir_mont::swap_words(acc, t);
  }
  pir_mont::mont_mul(pir_mont::Unit{}, acc, nv, n0inv, L, t);
  pir_mont::copy_words(t, Words{out + col * L, 1}, L);
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

bool bad_shape(int L, int e_max, int wbits, int block) {
  return L < 1 || e_max < 1 || (wbits != 1 && wbits != 4) || block < 1 || block > 128;
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

// Kernel 9 over b rows, `block` threads a block. smem_state: the threads'
// state in shared memory (2 (L + 1) words a thread), else in `state`
// (2 (L + 1) words for each of the grid's threads). tables: 2^wbits L words
// for each of the grid's threads. Returns cudaGetLastError() after the
// launch.
extern "C" int pir_mont_powmod(const void* base, const void* e, void* out, const void* n,
                               const void* n0inv, const void* r2, void* state, void* tables,
                               int b, int L, int ew, int e_max, int wbits, int per_row,
                               int smem_state, int block, void* stream) {
  if (b < 1 || ew < 1 || bad_shape(L, e_max, wbits, block) || (e_max + 31) / 32 > ew) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((b + block - 1) / block);
  const int smem = smem_state ? 2 * (L + 1) * block * 4 : 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const uint32_t*>(base);
  const auto* ep = static_cast<const uint32_t*>(e);
  auto* op = static_cast<uint32_t*>(out);
  const auto* np = static_cast<const uint32_t*>(n);
  const auto* ip = static_cast<const uint32_t*>(n0inv);
  const auto* rp = static_cast<const uint32_t*>(r2);
  auto* sp = static_cast<uint32_t*>(state);
  auto* tp = static_cast<uint32_t*>(tables);
  cudaError_t err;
  if (smem_state) {
    err = allow_smem(mont_powmod_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mont_powmod_kernel<true><<<grid, block, smem, s>>>(bp, ep, op, np, ip, rp, sp, tp, b, L, ew,
                                                       e_max, wbits, per_row);
  } else {
    mont_powmod_kernel<false><<<grid, block, 0, s>>>(bp, ep, op, np, ip, rp, sp, tp, b, L, ew,
                                                     e_max, wbits, per_row);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 10's first pass over an (h, w) exponent matrix: column tiles of
// `block` threads by ceil(h / rc) row chunks; partials: (chunks, L, w)
// words. Shared memory: (L + rc 2^wbits L) words, plus 2 (L + 1) block
// words when smem_state (else `state` holds 2 (L + 1) words for each of the
// grid's threads).
extern "C" int pir_mont_scan(const void* bases, const void* e, void* partials, const void* n,
                             unsigned n0inv, const void* r2, void* state, int h, int w, int L,
                             int ew, int e_max, int wbits, int rc, int smem_state, int block,
                             void* stream) {
  if (h < 1 || w < 1 || rc < 1 || ew < 1 || bad_shape(L, e_max, wbits, block) ||
      (e_max + 31) / 32 > ew) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (h + rc - 1) / rc;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + block - 1) / block, static_cast<unsigned>(chunks));
  long long words = L + (long long)rc * ((long long)L << wbits);
  if (smem_state) words += 2LL * (L + 1) * block;
  const int smem = static_cast<int>(words * 4);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const uint32_t*>(bases);
  const auto* ep = static_cast<const uint32_t*>(e);
  auto* pp = static_cast<uint32_t*>(partials);
  const auto* np = static_cast<const uint32_t*>(n);
  const auto* rp = static_cast<const uint32_t*>(r2);
  auto* sp = static_cast<uint32_t*>(state);
  cudaError_t err;
  if (smem_state) {
    err = allow_smem(mont_scan_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mont_scan_kernel<true><<<grid, block, smem, s>>>(bp, ep, pp, np, n0inv, rp, sp, h, w, L, ew,
                                                     e_max, wbits, rc);
  } else {
    err = allow_smem(mont_scan_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mont_scan_kernel<false><<<grid, block, smem, s>>>(bp, ep, pp, np, n0inv, rp, sp, h, w, L, ew,
                                                      e_max, wbits, rc);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 10's second pass: out (w, L) words from (chunks, L, w) partials;
// state: 2 (L + 1) words for each of the grid's threads.
extern "C" int pir_mont_merge(const void* partials, void* out, const void* n, unsigned n0inv,
                              void* state, int chunks, int w, int L, int block, void* stream) {
  if (chunks < 1 || w < 1 || L < 1 || block < 1 || block > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((w + block - 1) / block);
  mont_merge_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(partials), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(n), n0inv, static_cast<uint32_t*>(state), chunks, w, L);
  return static_cast<int>(cudaGetLastError());
}
