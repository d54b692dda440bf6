// Overlap probe (kernel 8): an integer-pipe chain, an int8 tensor-core
// chain, and both in one kernel, in two placements.
//
// Replaces the TPU probe benchmarks_overlap.py (vpu_kernel :63, mxu_kernel
// :72, mixed_kernel :87; pl.pallas_call at :110, :113, :116), which asks
// whether a TPU core co-issues VPU and MXU work. This asks the card the same
// of its integer pipes and its int8 tensor cores (wgmma). Each kernel gives
// the TPU kernel's words exactly:
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
// Beside those, the chain floor: `iters` times the least latency of one
// round's dependent path. A: one element's 28 dependent instructions. B:
// kKSteps dependent m64n8k32 steps (the critical tile below) and one hop
// over distributed shared memory. pir_overlap_latency measures the three
// latencies on the card with clock64 (chip_smoke.py phase 1).
//
// Design. B and C: 64 blocks in 4 clusters of kCluster = 16 (a
// non-portable size), one block an SM (its shared memory), scheduled with
// the spread preference. Cluster c holds m-tile c / 2 (rows 64 (c / 2) ..)
// and N-group c % 2 (columns 128 (c % 2) ..); its block of rank r holds
// the K slice 256 r .. 256 r + 255. The card holds 7 clusters of 16 at one
// block an SM. A grid of 128 blocks (8 clusters, 64 columns a block) put
// two blocks on some SMs, since the card has too few SMs in a GPC for 8
// clusters of 16, and the chain of a cluster on shared SMs set the pace; 8
// clusters of 8 would double the critical tile's dependent steps. No block
// holds b (1 MiB): each keeps its slice of b resident in shared memory in
// the layout a wgmma descriptor reads (K-major, 128-byte swizzle, the tile
// code of packed_planes.cuh): the N-group's 128 columns and columns 0..7.
// - Products: wgmma.mma_async m64nNk32 .s32.s8.s8, A from registers. The A
//   fragments of the block's 64 rows and K slice sit in shared memory in
//   register order, four variants of each lane's four registers: rows g and
//   g + 8 of the lane each from a or from a + 1 (each byte plus one,
//   wrapping as int8). A round's two row bits pick the variant, so the
//   products need no integer work: one conflict-free 16-byte load a k32
//   step straight into the wgmma's A registers. Each k step's descriptor is
//   the slice's plus the step's offset. Every round issues every product of
//   the block.
// - The critical warpgroup (warps 0-3) computes only the 8-column tile that
//   holds column 0 (m64n8k32, kKSteps steps), commits it on its own and
//   waits for it; the bulk warpgroup (warps 4-7) computes the N-group's 128
//   columns (m64n128k32). The next round's critical tile starts once the
//   bits arrive, while the bulk's products of this round drain: a round
//   costs the larger of the critical path's latency and the bulk's
//   throughput. The bulk loads its A registers only once the critical tile
//   has issued its own ("issued", local), so the critical loads find the
//   shared-memory pipe free. Redundant products: every cluster computes
//   columns 0..7 once more in its critical tile, 8 of each N-group's 128
//   columns, 6.25% of the function's products (the bounds count only
//   2 M N K a round).
// - Round t + 1's rows are chosen from round t's product, never from a
//   parity precomputed from a and b (which the algebra would allow, and
//   which would turn the chain into something the TPU probe does not
//   measure): the parity of column 0 of round t's accumulator is the XOR of
//   the parities of the 16 K slices' partial sums, each read from the
//   critical tile's accumulators. One hop a round: each critical warp
//   ballots its 16 rows' partial bits into one word (row 16 w + g at bit
//   4 g, row 16 w + g + 8 at bit 4 g + 1), the 4 words meet in shared
//   memory (one named barrier of the warpgroup), and lane q of warp w
//   stores the 16-byte vector into block 4 w + q's slot over distributed
//   shared memory with st.async, which counts the bytes on that block's
//   "full" mbarrier (a transaction barrier that expects the 16 vectors of
//   a round; no fence on the path: a release arrive at cluster scope
//   compiles to MEMBAR.ALL.GPU, a wait for every earlier memory operation
//   of the thread to reach the whole card). Every
//   block XORs the 16 vectors itself: lane r of each warp loads word w of
//   sender r, and one warp reduction (redux.sync xor) gives the warp's
//   word. No leader, no round trip on the path. kSlots slots;
//   back-pressure: while its products run, a block's critical warpgroup
//   waits until its own bulk warpgroup has read the slot of round
//   t - kSlots + 1 ("free", local), so a peer writes a slot only after
//   every reader of the block is past it; the critical readers themselves
//   are past it by the data dependence. The block's critical warpgroup
//   arms each slot's next phase once it has read it.
// - Only the last round's bulk accumulators are summed across the K split
//   (each block stores its partial sums, and block r adds the 16 blocks'
//   partials of rows 4 r .. 4 r + 3 over distributed shared memory).
// - C, one body ("mixed", the TPU's placement): the bulk warpgroup runs one
//   integer round on its four words of v between wgmma.commit_group and
//   wgmma.wait_group, every round. C, split ("mixed_split"): a warpgroup of
//   its own runs the integer rounds, four words a thread. Block b of B and
//   C owns words 512 b .. 512 b + 511 of v.
// - A alone: 128 blocks of 128 threads (a warp a scheduler), two words a
//   thread, block b words 256 b .., no shared memory and no cluster, so
//   that its blocks can sit on the SMs that B's blocks hold (the two-stream
//   run).

#include <cstdint>
#include <cuda_runtime.h>

#include "packed_planes.cuh"

namespace {

constexpr int kM = 128, kK = 4096, kN = 256;
constexpr uint32_t kC = 0x9E3779B9u;

constexpr int kCluster = 16;                           // K split, blocks a cluster
constexpr int kMTiles = kM / 64;                       // 2
constexpr int kNGroups = 2;                            // clusters an m-tile
constexpr int kBlocks = kMTiles * kNGroups * kCluster; // 64, one an SM
constexpr int kBulkN = kN / kNGroups;                  // 128 columns a block
constexpr int kCritN = 8;                              // the tile of column 0
constexpr int kKSlice = kK / kCluster;                 // 256
constexpr int kKSteps = kKSlice / 32;                  // 8 k32 steps
constexpr int kKBlocks = kKSlice / 128;                // 128-byte swizzle rows
constexpr int kSlots = 4;
constexpr int kVWords = 64 * 512 / kBlocks;            // 512 words of v a block (B, C)
constexpr int kBodyElems = kVWords / 128;              // C in one body: 4 words a bulk thread
constexpr int kVpuBlocks = 128;                        // A alone
constexpr int kVpuWords = 64 * 512 / kVpuBlocks;       // 256 words of v a block
constexpr int kIntThreads = 128;                       // A alone: a warp a scheduler, 2 words each
constexpr int kSplitThreads = 128;                     // C split: a warp a scheduler, 4 words each
constexpr int kMmaThreads = 256;                       // critical + bulk warpgroups

static_assert(kBlocks == 64 && kKSteps == 8 && kKBlocks == 2, "probe geometry");

// Shared memory (dynamic, from its 1024-aligned start): the A fragments
// [variant][k step][warp][lane] as the lane's 4 registers (row g k 4t..,
// row g + 8 k 4t.., row g k 16+4t.., row g + 8 k 16+4t..), variant v
// taking row g from a + (v & 1) and row g + 8 from a + (v >> 1); b's
// bulk slice [k block][128 n][128 k], b's critical slice [k block][8 n]
// [128 k], the bulk's partial sums, then Tail.
constexpr int kFragBytes = 4 * kKSteps * 4 * 32 * 16;         // 64 KiB
constexpr int kBulkBBytes = kKBlocks * kBulkN * 128;           // 32 KiB
constexpr int kCritBBytes = kKBlocks * kCritN * 128;           // 2 KiB
constexpr int kPartBytes = 64 * kBulkN * 4;                    // 32 KiB
constexpr int kOffBulkB = kFragBytes;
constexpr int kOffCritB = kOffBulkB + kBulkBBytes;
constexpr int kOffPart = kOffCritB + kCritBBytes;
constexpr int kOffTail = kOffPart + kPartBytes;
struct Tail {
  uint4 slot[kSlots][kCluster];        // [round % kSlots][sender rank]: its 4 warps' row bits
  uint4 mine;                          // this block's 4 words of the round, before the sends
  unsigned long long full[kSlots];     // 1 arrival (the block's own) and kSlotBytes
  unsigned long long free_[kSlots];    // 4 arrivals: the bulk warps have read the slot
  unsigned long long issued[kSlots];   // 1 arrival: the critical tile's round is issued
};
constexpr size_t kSmemBytes = kOffTail + sizeof(Tail) + 1024;
constexpr uint32_t kSlotBytes = kCluster * 16;  // a round's words into one block

using pir_planes::desc_sw128;
using pir_planes::plane_offset;
using pir_planes::smem_u32;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t c;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(c));
  return c;
}

// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}

// wait for the phase of the given parity of a barrier of this block (the
// words st.async counted on it are visible after it)
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// this block's arrival on a transaction barrier, expecting `bytes` more
__device__ __forceinline__ void mbar_expect(uint32_t addr, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(addr), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_local(uint32_t addr) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(addr)
               : "memory");
}

// v into a peer's shared memory, its 16 bytes counted on the peer's
// transaction barrier (both shared::cluster addresses of that peer)
__device__ __forceinline__ void st_async(uint32_t cluster_addr, uint4 v, uint32_t cluster_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(cluster_addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(cluster_bar)
      : "memory");
}

// the critical warpgroup's own barrier (named barrier 1, its 128 threads)
__device__ __forceinline__ void critical_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ int ld_cluster(uint32_t cluster_addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(cluster_addr) : "memory");
  return v;
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
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

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// d (64 x 8, s32) = a (64 x 32, s8, registers) * B (32 x 8, s8, desc) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_n8(int (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (64 x 128, s32) = a (64 x 32, s8, registers) * B (32 x 128, s8, desc) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The descriptor of k32 step ks of a [k block][n][128 k] slice of n_rows
// rows, from the slice's own: the step's byte offset added to the start
// address field (bits 0-13, in 16-byte units; every shared address here
// is below 2^18, so the field does not carry).
__device__ __forceinline__ uint64_t step_desc(uint64_t desc0, int n_rows, int ks) {
  return desc0 + (((ks / 4) * (n_rows * 128) + 32 * (ks % 4)) >> 4);
}

// The round's row bits of this lane's warp: the XOR of word w of the
// kCluster senders' vectors in slot s (row 16 w + g at bit 4 g, + 8 at
// 4 g + 1). Lane r < kCluster loads sender r's word (one conflict-free
// pass), and one warp reduction XORs them.
__device__ __forceinline__ uint32_t read_bits(const Tail& tl, int s, int w, int lane) {
  const uint32_t x =
      lane < kCluster ? reinterpret_cast<const uint32_t*>(tl.slot[s])[4 * lane + w] : 0u;
  return __reduce_xor_sync(0xffffffffu, x);
}

// This lane's A registers of the round: the variant its rows' two bits
// pick (row g at bit 4 g, row g + 8 at bit 4 g + 1 of warp w's word).
__device__ __forceinline__ void load_a(const uint4* frag, uint32_t bits, int w, int lane,
                                       uint32_t (&a)[kKSteps][4]) {
  const uint4* p = frag + (((bits >> (4 * (lane / 4))) & 3) * kKSteps * 4 + w) * 32 + lane;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const uint4 x = p[ks * 4 * 32];
    a[ks][0] = x.x;
    a[ks][1] = x.y;
    a[ks][2] = x.z;
    a[ks][3] = x.w;
  }
}

// The critical warpgroup: the column-0 tile, then its 4 warps' words of
// row bits, as one 16-byte vector, to every block of the cluster, round
// after round.
__device__ __forceinline__ void critical_chain(const uint4* frag, uint32_t crit_b, Tail& tl,
                                               int iters) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = cluster_rank();
  const uint64_t desc0 = desc_sw128(crit_b);
  // lane q < 4 of warp w sends to block 4 w + q: its slot row and barrier
  // there, for slot 0 (slot s is s rows and s barriers further)
  const uint32_t peer = 4 * w + (lane & 3);
  const uint32_t to_slot = in_rank(smem_u32(&tl.slot[0][rank]), peer);
  const uint32_t to_full = in_rank(smem_u32(&tl.full[0]), peer);
  uint32_t bits = 0;
  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      const int s = (it - 1) % kSlots;
      mbar_wait(smem_u32(&tl.full[s]), ((it - 1) / kSlots) & 1);
      bits = read_bits(tl, s, w, lane);
    }
    uint32_t a[kKSteps][4];
    load_a(frag, bits, w, lane, a);
    int d[4];
    __syncwarp();  // converged after the spin before the warpgroup's products
    fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
      wgmma_n8(d, a[ks], step_desc(desc0, kCritN, ks), ks > 0);
    commit();
    // the bulk's loads of the round may start: the critical tile's are done
    if (threadIdx.x == 0) mbar_arrive_local(smem_u32(&tl.issued[it % kSlots]));
    // while the products run: the slot this round's words go to was read
    // by this block's bulk (the round kSlots - 1 back; see the header)
    const int freed = it - kSlots + 1;
    if (it + 1 < iters && freed >= 0)
      mbar_wait(smem_u32(&tl.free_[freed % kSlots]), (freed / kSlots) & 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (it + 1 == iters) break;
    // accumulators 0 and 2 of lanes t == 0: rows g and g + 8, column 0
    const bool col0 = lane % 4 == 0;
    const uint32_t word = __ballot_sync(0xffffffffu, col0 && (d[0] & 1)) |
                          (__ballot_sync(0xffffffffu, col0 && (d[2] & 1)) << 1);
    reinterpret_cast<uint32_t*>(&tl.mine)[w] = word;
    critical_sync();
    // lane q of warp w sends the block's vector to block 4 w + q
    const int s = it % kSlots;
    if (lane < kCluster / 4)
      st_async(to_slot + s * sizeof(tl.slot[0]), tl.mine, to_full + s * sizeof(tl.full[0]));
    // the last round's slot, read above by every critical warp, takes its
    // next phase (round it - 1 + kSlots); the bulk reads it before any
    // writer of that phase sends (the free wait above, in the peers)
    if (it > 0 && threadIdx.x == 0) mbar_expect(smem_u32(&tl.full[(it - 1) % kSlots]), kSlotBytes);
    critical_sync();  // tl.mine read by every sender before the next round's words
  }
}

// The bulk warpgroup: the N-group's 128 columns, round after round; with
// kInt, one integer round on its kBodyElems words of v (x) between each
// round's commit and wait. Returns the last round's partial sums in acc.
template <bool kInt>
__device__ __forceinline__ void bulk_chain(const uint4* frag, uint32_t bulk_b, Tail& tl,
                                           int iters, int (&acc)[64],
                                           uint32_t (&x)[kBodyElems]) {
  const int w = threadIdx.x / 32 - 4, lane = threadIdx.x % 32;
  const uint64_t desc0 = desc_sw128(bulk_b);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;  // the result of 0 rounds
  uint32_t bits = 0;
  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      const int s = (it - 1) % kSlots;
      mbar_wait(smem_u32(&tl.full[s]), ((it - 1) / kSlots) & 1);
      bits = read_bits(tl, s, w, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive_local(smem_u32(&tl.free_[s]));
    }
    // the critical tile's loads and products of the round go first
    mbar_wait(smem_u32(&tl.issued[it % kSlots]), (it / kSlots) & 1);
    uint32_t a[kKSteps][4];
    load_a(frag, bits, w, lane, a);
    __syncwarp();
    fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
      wgmma_n128(acc, a[ks], step_desc(desc0, kBulkN, ks), ks > 0);
    if (kInt) {
      // the words pass through the commit and the wait, so the compiler
      // keeps the integer round between them
      static_assert(kBodyElems == 4, "the commit and wait below name 4 words");
      asm volatile("wgmma.commit_group.sync.aligned;\n"
                   : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]) : : "memory");
#pragma unroll
      for (int e = 0; e < kBodyElems; ++e) x[e] = vpu_round(x[e]);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n"
                   : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]) : : "memory");
    } else {
      commit();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
  }
}

// the block's kWords words of v over kThreads threads, words i0 + kThreads e
// of thread i0, `iters` rounds
template <int kWords, int kThreads>
__device__ __forceinline__ void int_chain(const uint32_t* __restrict__ v, uint32_t* __restrict__ vo,
                                          int i0, int iters) {
  constexpr int kElems = kWords / kThreads;
  const uint32_t* src = v + blockIdx.x * kWords;
  uint32_t x[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) x[e] = src[i0 + kThreads * e];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) x[e] = vpu_round(x[e]);
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) vo[blockIdx.x * kWords + i0 + kThreads * e] = x[e];
}

// A alone: 128 threads a block, no shared memory, no cluster
__global__ void __launch_bounds__(kIntThreads) vpu_kernel(const uint32_t* __restrict__ v,
                                                          uint32_t* __restrict__ vo, int iters) {
  int_chain<kVpuWords, kIntThreads>(v, vo, threadIdx.x, iters);
}

enum Mode { kMxu = 0, kMixed = 1, kMixedSplit = 2 };

template <int kMode>
struct Shape {
  static constexpr int kThreads = kMmaThreads + (kMode == kMixedSplit ? kSplitThreads : 0);
};

// B and C: see the header. Launched in clusters of kCluster (launch_mma).
template <int kMode>
__global__ void __launch_bounds__(Shape<kMode>::kThreads, 1)
    overlap_kernel(const uint32_t* __restrict__ v, const int8_t* __restrict__ a,
                   const int8_t* __restrict__ b, uint32_t* __restrict__ vo,
                   int32_t* __restrict__ mo, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // every region from the 1024-aligned start (the swizzle's repeat); offsets
  // from the extern array keep accesses in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint4* frag = reinterpret_cast<uint4*>(smem);
  unsigned char* bulk_b = smem + kOffBulkB;
  unsigned char* crit_b = smem + kOffCritB;
  int* part = reinterpret_cast<int*>(smem + kOffPart);
  Tail& tl = *reinterpret_cast<Tail*>(smem + kOffTail);

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int c = static_cast<int>(cluster_id());
  const int row0 = 64 * (c / kNGroups), col0 = kBulkN * (c % kNGroups);
  const int k0 = kKSlice * static_cast<int>(rank);

  if (tid < kMmaThreads) {
    // the A fragments of rows row0.., k0.., each row from a or from a + 1
    for (int e = tid; e < kKSteps * 4 * 32; e += kMmaThreads) {
      const int ln = e % 32, w = (e / 32) % 4, ks = e / 128;
      const int8_t* p = a + static_cast<long long>(row0 + 16 * w + ln / 4) * kK + k0 + 32 * ks +
                        4 * (ln % 4);
      uint32_t r[2][4];  // [+ 1][row g k lo, row g + 8 k lo, row g k hi, row g + 8 k hi]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[0][i] = __ldg(reinterpret_cast<const uint32_t*>(p + 8 * kK * (i & 1) + 16 * (i >> 1)));
        r[1][i] = inc_bytes(r[0][i]);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v)
        frag[(v * kKSteps + ks) * 128 + w * 32 + ln] =
            make_uint4(r[v & 1][0], r[v >> 1][1], r[v & 1][2], r[v >> 1][3]);
    }
    // b's slices, K-major with the 128-byte swizzle: byte (n, k) of k block
    // k / 128 at plane_offset(n, k % 128)
    for (int e = tid; e < kKSlice * kBulkN; e += kMmaThreads) {
      const int n = e % kBulkN, k = e / kBulkN;
      bulk_b[(k / 128) * (kBulkN * 128) + plane_offset(n, k % 128)] =
          static_cast<unsigned char>(__ldg(b + static_cast<long long>(k0 + k) * kN + col0 + n));
    }
    for (int e = tid; e < kKSlice * kCritN; e += kMmaThreads) {
      const int n = e % kCritN, k = e / kCritN;
      crit_b[(k / 128) * (kCritN * 128) + plane_offset(n, k % 128)] =
          static_cast<unsigned char>(__ldg(b + static_cast<long long>(k0 + k) * kN + n));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // b -> wgmma
  }
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(smem_u32(&tl.full[s]), 1);
      mbar_init(smem_u32(&tl.free_[s]), 4);
      mbar_init(smem_u32(&tl.issued[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kSlots; ++s) mbar_expect(smem_u32(&tl.full[s]), kSlotBytes);
  }
  // the slices are in place and every block's barriers exist before any
  // remote arrive
  cluster_sync();

  if (tid < 128) {
    critical_chain(frag, smem_u32(crit_b), tl, iters);
  } else if (tid < kMmaThreads) {
    int acc[64];
    const int i = tid - 128;
    uint32_t x[kBodyElems] = {};
    if (kMode == kMixed) {
#pragma unroll
      for (int e = 0; e < kBodyElems; ++e) x[e] = v[blockIdx.x * kVWords + i + 128 * e];
    }
    bulk_chain<kMode == kMixed>(frag, smem_u32(bulk_b), tl, iters, acc, x);
    if (kMode == kMixed) {
#pragma unroll
      for (int e = 0; e < kBodyElems; ++e) vo[blockIdx.x * kVWords + i + 128 * e] = x[e];
    }
    // accumulator 4 j + q: row 16 w + g (+ 8 for q >= 2), column 8 j + 2 t + (q & 1)
    const int w = i / 32, g = (i % 32) / 4, t = i % 4;
#pragma unroll
    for (int j = 0; j < kBulkN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[(16 * w + g + 8 * (q / 2)) * kBulkN + 8 * j + 2 * t + (q & 1)] = acc[4 * j + q];
  } else if (kMode == kMixedSplit) {
    int_chain<kVWords, kSplitThreads>(v, vo, tid - kMmaThreads, iters);
  }
  cluster_sync();  // every block's partial sums stored

  // block r: rows 4 r .. 4 r + 3 of the tile, the sum of the 16 K slices
  if (tid < kMmaThreads) {
#pragma unroll
    for (int e = 0; e < 4 * kBulkN / kMmaThreads; ++e) {
      const int o = tid + kMmaThreads * e;
      const int r = 4 * static_cast<int>(rank) + o / kBulkN, col = o % kBulkN;
      const uint32_t addr = smem_u32(part + r * kBulkN + col);
      int sum = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) sum += ld_cluster(in_rank(addr, q));
      mo[(row0 + r) * kN + col0 + col] = sum;
    }
  }
  cluster_sync();  // no block exits while a peer may still read its shared memory
}

template <int kMode>
cudaError_t set_attrs() {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(overlap_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(overlap_kernel<kMode>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return attr;
}

// the launch configuration of B and C: kBlocks blocks in clusters of
// kCluster, each cluster's blocks spread over distinct SMs where it can
struct MmaLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  template <int kMode>
  static MmaLaunch make(cudaStream_t stream) {
    MmaLaunch l;
    l.cfg.gridDim = dim3(kBlocks);
    l.cfg.blockDim = dim3(Shape<kMode>::kThreads);
    l.cfg.dynamicSmemBytes = kSmemBytes;
    l.cfg.stream = stream;
    l.attrs[0].id = cudaLaunchAttributeClusterDimension;
    l.attrs[0].val.clusterDim.x = kCluster;
    l.attrs[0].val.clusterDim.y = 1;
    l.attrs[0].val.clusterDim.z = 1;
    l.attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
    l.attrs[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
    l.cfg.numAttrs = 2;
    return l;
  }
};

template <int kMode>
cudaError_t launch_mma(const void* v, const void* a, const void* b, void* vo, void* mo, int iters,
                       void* stream) {
  const cudaError_t attr = set_attrs<kMode>();
  if (attr != cudaSuccess) return attr;
  MmaLaunch l = MmaLaunch::make<kMode>(static_cast<cudaStream_t>(stream));
  l.cfg.attrs = l.attrs;
  const cudaError_t e = cudaLaunchKernelEx(
      &l.cfg, overlap_kernel<kMode>, static_cast<const uint32_t*>(v),
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<uint32_t*>(vo),
      static_cast<int32_t*>(mo), iters);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// how many clusters of this kernel the card holds at once
template <int kMode>
cudaError_t max_clusters(int* out) {
  const cudaError_t attr = set_attrs<kMode>();
  if (attr != cudaSuccess) return attr;
  MmaLaunch l = MmaLaunch::make<kMode>(nullptr);
  l.cfg.attrs = l.attrs;
  return cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(overlap_kernel<kMode>),
                                        &l.cfg);
}

// registers a block holds: per warp, the thread's count rounded up to 8, x 32
int block_regs(const cudaFuncAttributes& f, int threads) {
  return ((f.numRegs + 7) / 8 * 8) * 32 * ((threads + 31) / 32);
}

// ---- latency probes (chip_smoke.py phase 1) --------------------------------

// one element's dependent rounds of A, on one thread
__global__ void lat_int_kernel(uint32_t* io, int n, long long* out) {
  uint32_t x = io[0];
  const long long t0 = clock64(), g0 = globaltimer();
  for (int i = 0; i < n; ++i) x = vpu_round(x);
  const long long t1 = clock64(), g1 = globaltimer();
  io[0] = x;
  out[0] = t1 - t0;
  out[1] = g1 - g0;
}

// one warpgroup: n groups of kKSteps dependent m64n8k32 products, each
// group committed and waited for, as the critical tile runs them
__global__ void __launch_bounds__(128) lat_wgmma_kernel(uint32_t* io, int n, long long* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sb = smem_raw + (((raw + 1023) & ~1023u) - raw);
  for (int i = threadIdx.x; i < kCritBBytes; i += 128) sb[i] = static_cast<unsigned char>(i * 37);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = io[4 * threadIdx.x + i];
  int d[4] = {0, 0, 0, 0};
  const uint64_t desc0 = desc_sw128(smem_u32(sb));
  const long long t0 = clock64(), g0 = globaltimer();
  for (int i = 0; i < n; ++i) {
    fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) wgmma_n8(d, a, step_desc(desc0, kCritN, ks), 1);
    commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  const long long t1 = clock64(), g1 = globaltimer();
#pragma unroll
  for (int i = 0; i < 4; ++i) io[4 * threadIdx.x + i] = d[i];
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = g1 - g0;
  }
}

// a cluster of 2: thread 0 of each block stores a 16-byte vector into the
// other's shared memory with st.async, counted on the other's transaction
// barrier, as the critical tile sends its bits; n round trips (2 n hops)
__global__ void __cluster_dims__(2, 1, 1) lat_dsmem_kernel(int n, long long* out) {
  __shared__ unsigned long long bar;
  __shared__ uint4 box;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  if (threadIdx.x == 0) {
    box = make_uint4(0, 0, 0, 0);
    mbar_init(smem_u32(&bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(smem_u32(&bar), sizeof(uint4));
  }
  cluster_sync();
  if (threadIdx.x == 0) {
    const uint32_t to_box = in_rank(smem_u32(&box), peer), to_bar = in_rank(smem_u32(&bar), peer);
    uint32_t bad = 0;
    const long long t0 = clock64(), g0 = globaltimer();
    for (int i = 0; i < n; ++i) {
      // each block reads its box before it sends: the peer's next store
      // comes only after that send
      const uint32_t want = static_cast<uint32_t>(i + 1);
      const uint4 v = make_uint4(want, want, want, want);
      if (rank == 0) {
        st_async(to_box, v, to_bar);
        mbar_wait(smem_u32(&bar), i & 1);
        bad |= (box.x ^ want) | (box.w ^ want);
        mbar_expect(smem_u32(&bar), sizeof(uint4));
      } else {
        mbar_wait(smem_u32(&bar), i & 1);
        bad |= (box.x ^ want) | (box.w ^ want);
        mbar_expect(smem_u32(&bar), sizeof(uint4));
        st_async(to_box, v, to_bar);
      }
    }
    const long long t1 = clock64(), g1 = globaltimer();
    if (rank == 0) {
      out[0] = t1 - t0;
      out[1] = g1 - g0;
      out[2] = bad;
    }
  }
  cluster_sync();  // no block exits while its peer may still reach its shared memory
}

}  // namespace

// v, vo: (64, 512) u32; a: (128, 4096) s8; b: (4096, 256) s8; mo: (128, 256)
// s32; every pointer 16-byte aligned, contiguous. Each returns the launch's
// error, else cudaGetLastError(), after its launch on `stream`.
extern "C" int pir_overlap_vpu(const void* v, void* vo, int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  vpu_kernel<<<kVpuBlocks, kIntThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(vo), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pir_overlap_mxu(const void* a, const void* b, void* mo, int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma<kMxu>(nullptr, a, b, nullptr, mo, iters, stream));
}

extern "C" int pir_overlap_mixed(const void* v, const void* a, const void* b, void* vo, void* mo,
                                 int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma<kMixed>(v, a, b, vo, mo, iters, stream));
}

extern "C" int pir_overlap_mixed_split(const void* v, const void* a, const void* b, void* vo,
                                       void* mo, int iters, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mma<kMixedSplit>(v, a, b, vo, mo, iters, stream));
}

// out[0]: blocks of the vpu kernel an SM holds; out[1..3]: the most
// clusters of kCluster blocks of the mxu, mixed and mixed_split kernels
// resident on the card at once (each launch is kBlocks / kCluster
// clusters); out[4]: how many pairs of one mxu block and one vpu block an
// SM holds by registers, shared memory and threads (the two-stream run
// needs 1); out[5]: the cluster size.
extern "C" int pir_overlap_max_clusters(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, vpu_kernel, kIntThreads, 0);
  if (e == cudaSuccess) e = max_clusters<kMxu>(out + 1);
  if (e == cudaSuccess) e = max_clusters<kMixed>(out + 2);
  if (e == cudaSuccess) e = max_clusters<kMixedSplit>(out + 3);
  cudaFuncAttributes fa, fb;
  int dev = 0;
  cudaDeviceProp prop;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, vpu_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fb, overlap_kernel<kMxu>);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaGetDeviceProperties(&prop, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int regs = block_regs(fb, kMmaThreads) + block_regs(fa, kIntThreads);
  const size_t smem = fb.sharedSizeBytes + kSmemBytes + prop.reservedSharedMemPerBlock * 2 +
                      fa.sharedSizeBytes;
  int pairs = prop.regsPerMultiprocessor / regs;
  const int by_smem = static_cast<int>(prop.sharedMemPerMultiprocessor / smem);
  const int by_threads = prop.maxThreadsPerMultiProcessor / (kMmaThreads + kIntThreads);
  if (by_smem < pairs) pairs = by_smem;
  if (by_threads < pairs) pairs = by_threads;
  out[4] = pairs;
  out[5] = kCluster;
  return 0;
}

// One latency probe, synchronous on `stream`'s queue: which 0 = one round
// of A on one thread (io: 1 word), 1 = a group of kKSteps dependent
// m64n8k32 s8 products (io: 512 words), 2 = a 16-byte st.async into a
// peer's shared memory, counted on its transaction barrier and seen by
// the peer (a round trip is two); n repetitions. out (device, 3 int64): clock64 cycles and
// globaltimer ns over the n repetitions, and (2) a count of wrong words.
extern "C" int pir_overlap_latency(int which, int n, void* io, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  if (which == 0) {
    lat_int_kernel<<<1, 1, 0, s>>>(static_cast<uint32_t*>(io), n, o);
  } else if (which == 1) {
    lat_wgmma_kernel<<<1, 128, kCritBBytes + 1024, s>>>(static_cast<uint32_t*>(io), n, o);
  } else if (which == 2) {
    lat_dsmem_kernel<<<2, 32, 0, s>>>(n, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
