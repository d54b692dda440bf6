// Overlap probe (kernel 8): an integer-pipe chain, an int8 tensor-core
// chain, and both in one warp-specialised kernel.
//
// Replaces the TPU probe benchmarks_overlap.py (vpu_kernel :63, mxu_kernel
// :72, mixed_kernel :87; pl.pallas_call at :110, :113, :116), which asks
// whether a TPU core co-issues VPU and MXU work. This asks the card the same
// of its integer pipes and its int8 tensor cores. Each kernel gives the TPU
// kernel's words exactly:
//   A (vpu):   v (64, 512) u32, `iters` dependent rounds of
//              4 x { v ^= v << 1; v |= v >> 3; v = (v & c) ^ (v << 2); v += c }
//   B (mxu):   acc (128, 256) s32 = 0; `iters` times
//              acc = (a + (acc[:, 0] & 1)) @ b, a (128, 4096) s8 (the add wraps
//              as int8), b (4096, 256) s8
//   C (mixed): both, on independent data, in one kernel body.
//
// What bounds each on an H100, counted for the whole card (132 SMs):
//   A: a quarter round is 3 shift + LOP3 pairs and one add, 7 instructions
//      ((v & c) ^ s is one LOP3), 28 an element a round, 2.3 x 10^8 at
//      iters = 256; every scheduler issues one warp instruction a clock,
//      and integer work has the integer pipe and (IMAD) the FMA pipe, so
//      at most 32 lanes a partition a clock: 67 TFLOP/s / 2 = 33.5 T
//      instructions/s, 0.0070 ms (operations).
//   B: 2 x 128 x 256 x 4096 int8 operations a round, 68.7 G at 256,
//      0.0347 ms at 1979 TOPS (operations).
//   C: the larger of the two if the units overlap fully, their sum if not.
// The grid below fills 64 of the 132 SMs, so each kernel runs at most at
// 64/132 of these rates: part of its gap to the bound is the grid.
//
// Design. One grid and one block shape for all three kernels, so every SM
// holds the same share of each chain in each: 64 blocks of 640 threads in
// clusters of 8, one block an SM (128 KiB of shared memory). Warps 0-15 run
// the mma chain, warps 16-19 (one a scheduler) the integer chain; A leaves
// the mma warps idle, B the integer warps, C runs both.
// - Integer chain: block i owns row i of v, 4 elements a thread in registers,
//   so each warp carries 4 independent dependency chains.
// - mma chain: b is 1 MiB and no block holds it, so cluster c owns rows
//   16c..16c+15 of a and block r of the cluster columns 32r..32r+31 of b.
//   Each mma warp owns 8 k32 steps (256 of K) and the 4 n8 tiles: its 64
//   B-fragment registers stay in registers for every round. The A fragments
//   of the 16 rows, for a and for a + 1 (both wrap as int8), sit in shared
//   memory in fragment order (one conflict-free 8-byte load per row half and
//   k step), so the round's row bits pick a buffer and the products need no
//   integer work. Every round issues every product:
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, as kernel 6 issues it.
// - The round's dependency is the parity of column 0, which only rank 0 of a
//   cluster computes: its warps write their column-0 partial sums to shared
//   memory, one warp adds them, and lane c of that warp stores the 16 parity
//   bits into block c of the cluster (distributed shared memory) and arrives
//   on its "full" mbarrier; each block's mma warps wait on it, and
//   acknowledge on rank 0's "empty" mbarrier, two slots deep. The integer
//   warps take part in no barrier but the cluster barriers at entry and exit.
// - Only the last round's other columns are summed across warps and stored;
//   the mma instructions are volatile, so no round's products are dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kM = 128, kK = 4096, kN = 256;
constexpr int kVCols = 512;
constexpr uint32_t kC = 0x9E3779B9u;

constexpr int kCluster = 8;                          // blocks a 16-row block of a
constexpr int kBlocks = (kM / 16) * kCluster;        // 64, one row of v each
constexpr int kMmaWarps = 16;
constexpr int kIntWarps = 4;
constexpr int kThreads = 32 * (kMmaWarps + kIntWarps);
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kSteps = kK / 32;                      // k32 steps
constexpr int kStepsPerWarp = kSteps / kMmaWarps;    // 8
constexpr int kTiles = 4;                            // n8 tiles: 32 columns a block
constexpr int kElems = kVCols / (32 * kIntWarps);    // 4 elements of v a thread
constexpr int kMmaBarrier = 1;                       // named barrier of the mma warps

static_assert(kBlocks == 64 && kSteps % kMmaWarps == 0, "probe geometry");

// Shared memory: the A fragments, [variant (a, a + 1)][row half][k step][lane]
// as (k 4t..4t+3, k 16+4t..16+4t+3) word pairs, 128 KiB, then Tail.
constexpr int kFrags = 2 * 2 * kSteps * 32;
struct Tail {
  int red[kMmaWarps][16];       // rank 0: column-0 partial sum of each warp and row
  uint32_t slot[2];             // parity bits of round t's column 0, slot t & 1
  unsigned long long full[2];   // mbarriers: slot written (1 arrival, from rank 0)
  unsigned long long empty[2];  // rank 0's: slot read by every block (kCluster arrivals)
};
constexpr size_t kSmemBytes = kFrags * sizeof(uint2) + sizeof(Tail);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kMmaBarrier), "n"(kMmaThreads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_addr)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t cluster_addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(cluster_addr), "r"(v) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate. Volatile:
// a round's products for columns other than 0 feed only the last round's
// output, and must still be issued every round.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// each byte plus one, wrapping as int8 (no carry between bytes)
__device__ __forceinline__ uint32_t inc_bytes(uint32_t w) {
  return ((w & 0x7F7F7F7Fu) + 0x01010101u) ^ (w & 0x80808080u);
}

__device__ __forceinline__ uint32_t vpu_round(uint32_t v) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v ^= v << 1;
    v |= v >> 3;
    v = (v & kC) ^ (v << 2);
    v += kC;
  }
  return v;
}

__device__ __forceinline__ void int_chain(const uint32_t* __restrict__ v, uint32_t* __restrict__ vo,
                                          int iters) {
  const int i0 = threadIdx.x - kMmaThreads;
  const uint32_t* src = v + blockIdx.x * kVCols;
  uint32_t x[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) x[e] = src[i0 + 32 * kIntWarps * e];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) x[e] = vpu_round(x[e]);
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) vo[blockIdx.x * kVCols + i0 + 32 * kIntWarps * e] = x[e];
}

__device__ __forceinline__ void mma_chain(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                                          int32_t* __restrict__ mo, int iters, uint2* frag,
                                          Tail& tl) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t rank = cluster_rank();
  const int row0 = (blockIdx.x / kCluster) * 16;
  const int col0 = static_cast<int>(rank) * 32;
  const int ks0 = kStepsPerWarp * warp;

  // this warp's B fragments: k rows 32 ks + 16 h + 4 t .. + 3, column 8 j + g
  uint32_t bf[kStepsPerWarp][kTiles][2];
#pragma unroll
  for (int s = 0; s < kStepsPerWarp; ++s)
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int8_t* p = b + (32 * (ks0 + s) + 16 * h + 4 * t) * kN + col0 + 8 * j + g;
        uint32_t x = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) x |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + i * kN))) << (8 * i);
        bf[s][j][h] = x;
      }
  // A fragments of the block's 16 rows, of a and of a + 1
  for (int e = threadIdx.x; e < 2 * kSteps * 32; e += kMmaThreads) {
    const int ln = e % 32, ks = (e / 32) % kSteps, half = e / (32 * kSteps);
    const int8_t* p = a + static_cast<long long>(row0 + ln / 4 + 8 * half) * kK + 32 * ks + 4 * (ln % 4);
    const uint32_t lo = __ldg(reinterpret_cast<const uint32_t*>(p));
    const uint32_t hi = __ldg(reinterpret_cast<const uint32_t*>(p + 16));
    frag[(half * kSteps + ks) * 32 + ln] = make_uint2(lo, hi);
    frag[((2 + half) * kSteps + ks) * 32 + ln] = make_uint2(inc_bytes(lo), inc_bytes(hi));
  }
  mma_sync();

  int acc[kTiles][4] = {};
  uint32_t bits = 0;  // row r's previous column-0 parity at bit r
  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      const int s = (it - 1) & 1;
      mbar_wait(smem_addr(&tl.full[s]), ((it - 1) >> 1) & 1);
      bits = *reinterpret_cast<volatile uint32_t*>(&tl.slot[s]);
    }
    const uint2* pg = frag + (((bits >> g) & 1) * 2 * kSteps + ks0) * 32 + lane;
    const uint2* pg8 = frag + ((((bits >> (g + 8)) & 1) * 2 + 1) * kSteps + ks0) * 32 + lane;
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
#pragma unroll
    for (int s = 0; s < kStepsPerWarp; ++s) {
      const uint2 x = pg[32 * s], y = pg8[32 * s];  // rows g and g + 8
#pragma unroll
      for (int j = 0; j < kTiles; ++j) mma_s8(acc[j], x.x, y.x, x.y, y.y, bf[s][j][0], bf[s][j][1]);
    }
    // accumulator 0 of tile 0 on lanes t == 0: row g, column 0; 2: row g + 8
    if (rank == 0 && t == 0) {
      tl.red[warp][g] = acc[0][0];
      tl.red[warp][g + 8] = acc[0][2];
    }
    mma_sync();
    if (threadIdx.x == 0 && it > 0) mbar_arrive_cluster(in_rank(smem_addr(&tl.empty[(it - 1) & 1]), 0));
    if (rank == 0 && warp == 0 && it + 1 < iters) {
      int sum = 0;
      if (lane < 16) {
#pragma unroll
        for (int w = 0; w < kMmaWarps; ++w) sum += tl.red[w][lane];
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, lane < 16 && (sum & 1));
      // lane c serves block c, so the 8 remote round trips overlap (each
      // release-arrive waits for its own store)
      if (lane < kCluster) {
        const int s = it & 1;
        mbar_wait(smem_addr(&tl.empty[s]), ((it >> 1) & 1) ^ 1);  // slot s read twice ago
        st_cluster(in_rank(smem_addr(&tl.slot[s]), lane), mask);
        mbar_arrive_cluster(in_rank(smem_addr(&tl.full[s]), lane));
      }
      __syncwarp();
    }
  }

  // the last round's partial sums over the A fragments (every warp is past
  // its last k step), then each thread one output of the block's 16 x 32
  int* part = reinterpret_cast<int*>(frag);
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[(warp * 16 + g + 8 * (i / 2)) * 32 + 8 * j + 2 * t + (i % 2)] = acc[j][i];
  mma_sync();
  const int r = threadIdx.x / 32, c = threadIdx.x % 32;
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kMmaWarps; ++w) sum += part[(w * 16 + r) * 32 + c];
  mo[(row0 + r) * kN + col0 + c] = sum;
}

template <bool kInt, bool kMma>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    overlap_kernel(const uint32_t* __restrict__ v, const int8_t* __restrict__ a,
                   const int8_t* __restrict__ b, uint32_t* __restrict__ vo,
                   int32_t* __restrict__ mo, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* frag = reinterpret_cast<uint2*>(smem);
  Tail& tl = *reinterpret_cast<Tail*>(smem + kFrags * sizeof(uint2));
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_addr(&tl.full[s]), 1);
      mbar_init(smem_addr(&tl.empty[s]), kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any remote arrive
  if (threadIdx.x >= kMmaThreads) {
    if (kInt) int_chain(v, vo, iters);
  } else if (kMma) {
    mma_chain(a, b, mo, iters, frag, tl);
  }
  cluster_sync();  // no block exits while a peer may still reach its shared memory
}

template <bool kInt, bool kMma>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      overlap_kernel<kInt, kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  return attr;
}

template <bool kInt, bool kMma>
cudaError_t launch(const void* v, const void* a, const void* b, void* vo, void* mo, int iters,
                   void* stream) {
  const cudaError_t attr = allow_smem<kInt, kMma>();
  if (attr != cudaSuccess) return attr;
  overlap_kernel<kInt, kMma><<<kBlocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(v), static_cast<const int8_t*>(a),
      static_cast<const int8_t*>(b), static_cast<uint32_t*>(vo), static_cast<int32_t*>(mo), iters);
  return cudaGetLastError();
}

// how many clusters of this kernel the card holds at once
template <bool kInt, bool kMma>
cudaError_t max_clusters(int* out) {
  const cudaError_t attr = allow_smem<kInt, kMma>();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(overlap_kernel<kInt, kMma>), &cfg);
}

}  // namespace

// v, vo: (64, 512) u32; a: (128, 4096) s8; b: (4096, 256) s8; mo: (128, 256)
// s32; every pointer 16-byte aligned, contiguous. Each returns
// cudaGetLastError() after its launch on `stream`.
extern "C" int pir_overlap_vpu(const void* v, void* vo, int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true, false>(v, nullptr, nullptr, vo, nullptr, iters, stream));
}

extern "C" int pir_overlap_mxu(const void* a, const void* b, void* mo, int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false, true>(nullptr, a, b, nullptr, mo, iters, stream));
}

extern "C" int pir_overlap_mixed(const void* v, const void* a, const void* b, void* vo, void* mo,
                                 int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true, true>(v, a, b, vo, mo, iters, stream));
}

// out[0..2]: the most clusters of 8 blocks of the vpu, mxu and mixed kernels
// resident on the card at once (each launch is 8 clusters).
extern "C" int pir_overlap_max_clusters(int* out) {
  cudaError_t e = max_clusters<true, false>(out);
  if (e == cudaSuccess) e = max_clusters<false, true>(out + 1);
  if (e == cudaSuccess) e = max_clusters<true, true>(out + 2);
  return static_cast<int>(e);
}
