#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (pir_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--out FILE]

From the repository root, on a machine with one NVIDIA H100 and nvcc:

0. prints the card (nvidia-smi name and power limit) and the versions;
1. builds the CUDA kernels from pir_tpu_torch/csrc with nvcc (nine
   sources, kernels 1-10), one nvcc per source, all at once, and logs
   ptxas's registers, spills, stack (local memory), static shared memory
   and warnings per kernel (--out: "ptxas", "ptxas_summary") and the fused
   kernel's dynamic shared memory, the larger of its scan tile's and its
   tail's (--out: "fused_smem"); meanwhile builds a probe of one AES-128
   block on the per-bank table, counts its SASS by pipe, and fails if the
   AES bound (AES_BLOCK_PIPES) counts more on a pipe (--out: "aes_sass");
   and a probe of one Montgomery group product (csrc/mont.cuh group_mul)
   at each instance K, whose round's SASS it counts by pipe a lane,
   failing if a round does fewer wide products than kernels 9 and 10's
   bound counts (--out: "mont_sass"); then measures with clock64 the
   three latencies of the overlap probe's chain floor (one round of its
   integer chain, one dependent wgmma m64n8k32 step, one st.async hop
   over distributed shared memory seen by the peer; --out:
   "chain_latencies");
2. builds a 2^20-row x 1024-byte table (1 GiB) from --seed, in the
   storage orders of every path (stacked and classic for 1024-bit keys,
   classic for the stream's 128-bit keys, compat), and holds each kernel
   against its plain torch version on the card, with equal bytes: the
   stacked tail at the serving geometry (depth 10, 8 leaf blocks, k = 32,
   tail 3) for shared and for distinct keys, the packed scan on the
   whole table with a 64-query slice, the compat stage on every stage of
   the (3, 3, 2) cascade for a 64-query slice of compat shares (one
   stage launch of the main path), the per-query tail (depth 10, 5 tail
   levels) on a 64-query slice of a 4096-batch's operands and on a
   distinct-key batch of 64, the fused scan + tail on the stream's
   table (depth 13) at 256 queries, both outputs, and the masked-XOR scan
   at Q = 1 on the natural-order word table (a fifth 1 GiB table) with a
   compat single's bits and at Q = 8 on the stacked table's word view,
   and the bit-plane scan at Q = 1, 13, 64 and 65 on a 2^16-row slice of
   the natural table's bytes and at Q = 13, 64 and 130 on a whole
   2^20-row table of 3-byte slots (4-byte rows); and the overlap probe's
   four kernels (integer chain, int8 wgmma chain, both in one body and
   both with the integer chain in warps of its own) and its two-stream
   run at 0, 1, 7 and 256 rounds, with equal int32 words;
3. serves, both shares, through TorchPirServer: 3 batches of 4096
   shared-key fast queries on the stacked path, 3 batches of 1024
   reference-exact (compat) queries (the last one through the async
   entry point), 3 batches of 4096 on the per-query tail path
   (fast_stacked=False; equal to the stacked path's bytes), and the
   serving stream in both modes, 3 batches of 4096 and a flush each
   (fused: 128-bit keys, equal to the batch API's bytes; stacked:
   default keys); recovers every answer by XOR and compares it with the
   table rows; prints per-batch seconds, queries per second, a
   stage-by-stage split of one share batch of each batch path and each
   path's kernel launch counts (every count set to 0 just before the
   path runs and read just after);
   Then single queries and small batches, indices 0, 2^20 - 1 and one
   random, both shares: fast singles through private_secret_shared_query
   on both fast paths, compat singles, batches of 3 of both key styles,
   and expand_shared_query + private_secret_shared_query_with_expanded_bits
   for both key styles; each answer equals the host golden model and
   recovers its row, the masked-XOR scan is launched on every such path
   and the packed scan on none of the fast singles; per-query latency
   and a split of one single of each kind. Then the tiny tables: a fast
   batch of depth < 5 (per query), and a compat batch of 8 on a 32-row
   table of 5 device levels (the preplane route: one bit-plane scan
   launch a share). Then, with 2^20 distinct keywords on
   the rows, a keyword batch of 64 (both shares, and a split of one),
   keyword singles (one absent), 3-party index and keyword singles,
   their device bits against the host golden, and lookups in both
   keyword search trees (PrivateSqrtST, PrivateBST) made with no device;
   then the overlap probe (pir_tpu_torch.benchmarks_overlap.run) at 256
   rounds and at PROBE_LONG_ITERS;
4. serves one distinct-key fast batch of 64 queries on each fast path;
   then live updates: with a stream of each mode open (one batch
   submitted), 4096 seeded row updates go to both servers' 1 GiB tables
   (TorchPirServer.apply_updates; seconds split into the database copy,
   host permutations and packing, and the device patch), and both
   shares of a fast batch of 4096 on both fast paths, a compat batch of
   1024, a fast and a compat single and one more step of each stream,
   half or more on updated rows, recover the new rows (the stacked
   stream's first batch, dispatched before the update, the old ones);
   then the database goes through save(mmap_capable=True) and
   load(mmap=True), and a server on the map serves a fast batch;
   4c. the serving shell (service_phase): two PirServices with the
   default config (TorchPirServer on the card) over the 1 GiB table, its
   keywords and a 2^20-row table of 32-byte auth keys, on 127.0.0.1; a
   port PirClient sends metadata, 3 fast batches of 4096, 3 compat
   batches of 1024, fast and compat singles, a stream of 3 fast batches
   of 4096 and a flush, a keyword batch of 8 and a keyword single, a
   3-party index single (a third service), a shared ASPIR batch of 64
   with one wrong key (its item refused) and a wrong-key single
   (OP_DENIED), 4096 row updates through PirService.apply_updates and a
   fast batch on the new rows, and OP_METRICS; each batch, single, the
   stream and both ASPIR requests also through the engines directly,
   with equal bytes (ASPIR: equal verdicts and released answers) and
   equal launch counts; the wire encode and decode of a 4096-share
   batch; then a second pair serves the cPIR yardstick table (2^10 x
   3 B) with a 1024-bit Paillier key: an encrypted query, a recursive
   one, and AHE ASPIR with the right and a wrong key (the default cPIR
   engine: the services' scans and proof checks on the card, the
   client's modexps in CPython);
   4d. cPIR on the card (cpir_phase), a 1024-bit key: kernels 9 and 10
   against their plain versions on the card, then, with the launch counts
   set to 0, against CPython pow at full size (an encryption batch of
   1024, its CRT decryption, 64 level-2 modexps), the yardstick queries
   through engine "torch" (equal to engine "python"), one encrypted query
   on the sqrt grid of 2^20 slots x 3 B with its split and 8 columns
   against CPython, an AHE ASPIR round under device_modexp (right and
   wrong key), and a PirService with paillier_engine="torch" whose
   answers equal a CPython service's bytes; every row recovered, both
   kernels launched;
   4e. the mesh engine (mesh_phase): MeshPirServer over ["cuda:0"] * 8,
   4 row shards by 2 batch slices on the one card, on the 1 GiB table:
   both shares of 4096 shared-key fast queries on the stacked and the
   per-query tail root steps, 1024 compat queries (compat root step), 64
   distinct-key fast queries and 64 compat queries on a 3-shard grid
   (host-prefix steps), a keyword batch of 8 and a 3-party index batch of
   4 (point steps), 4096 row updates and a fast batch, and two
   PirServices with PirConfig(engine="mesh") (1 x 1) serving a fast and
   a compat batch; every answer equals the single-card server's bytes
   and recovers its row, each route launches exactly its kernels
   (counts set to 0 just before, read just after), seconds per batch
   beside the single card's;
   4f. the last modules (rest_phase): (a) both shares of a 4096-batch of
   shared-key fast queries through the per-query tail route with
   all_xla_expand (the whole walk and leaf PRG in plain torch) on a fresh
   classic table, equal to the tail-kernel route's bytes, every row
   recovered, one packed scan launch a share and no tail kernel, seconds
   and max_memory_allocated; a distinct-key batch raises ValueError; (b)
   8 fast queries with per-query payloads through each of the six
   fused_fast_answer* functions (the natural word table, its bytes, or the
   storage-order word table scattered once), equal to the host golden
   model, the masked-XOR scan or the bit-plane scan launched as the
   function says; (c) the native C++ engine: the host CPU and its AES-NI
   and AVX2 flags, the g++ build, NativePirServer answering the card's
   shares on the 1 GiB table (fast and compat batches of 16, fast and
   compat singles, a keyword single, a 3-party index single) with equal
   bytes and no kernel launched, a PirService pair with
   PirConfig(engine="native", paillier_engine="native") on the cPIR
   yardstick table equal to a default pair's response bytes, an encrypted
   query's ints equal through the "native", "torch" and "python" scan
   engines, and native.powmod_batch equal to kernel 9 on phase 4d's 1024
   encryptions; seconds beside the card's;
5. times each kernel, its plain version and its PyTorch yardstick at the
   main paths' shapes (the masked-XOR scan at Q = 1 and Q = 8, the
   bit-plane scan at Q = 64 and Q = 1024 on the natural table's bytes,
   the probe at 256 rounds and at PROBE_LONG_ITERS (beside its operations
   bound, its chain floor from phase 1's latencies), kernel 9 on phase
   4d's encryption, CRT decryption and level-2 batches, kernel 10 on its
   grid and on a recursive query's level-2 scan (32 rows, one column,
   exponents of bits(N^2) mod N^3), both also at phase 4d (a)'s shapes
   beside their plain versions, each on its planner's plan, with bounds
   from their Montgomery products and the SASS floor of the plan's
   products, sampled rows and columns against CPython), the fused kernel's
   step against each of its halves alone (co-issue: near the larger half
   or near their sum); where Nsight Compute (ncu) is installed, reads its
   shared-memory bank conflicts, LSU instructions and ALU pipe share on
   one stacked tail launch and one last-stage compat launch at the main
   paths' shapes, in a child process, if `ncu --query-metrics` runs
   clean (else logs why not); and
   prints one JSON line of kernels.

Every failed check raises, so the exit code is not 0. The last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing any result; it imports nothing of JAX or of pir_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HEIGHT = 1 << 20
SLOT_BYTES = 1024
BATCH = 4096
BATCHES = 3
DISTINCT_BATCH = 64
SCAN_CHECK_Q = 64
TAIL_CHECK_STEPS = 4
COMPAT_BATCH = 1024
COMPAT_BATCHES = 2  # plus one through the async entry point
STREAM_LEAF_BITS = 128  # the fused stream's 128-bit leaves: depth 13 here
TAIL_CHECK_Q = 64  # per-query tail: queries of the 4096-batch checked in phase 2
FUSED_CHECK_Q = 256  # fused kernel: queries checked in phase 2 (plain scan ~0.5 s)
SMALL_BATCH = 3  # small batches of both key styles on the single-query paths
PREPLANE_ROWS = 32  # a compat table of 5 device levels (one dead level): the preplane route
PREPLANE_BATCH = 8
TINY_FAST_ROWS = 1024  # fast keys of depth 3 (128-bit leaves)
TINY_BATCH = 12  # scanned as 8 + 4
PLANES_CHECK_ROWS = 1 << 16  # bit-plane scan: rows of the 1 GiB table checked in phase 2
KW_BATCH = 64  # keyword batch: queries a share batch
KW_TIMING_Q = (64, 1024)  # bit-plane scan: batch sizes timed in phase 5
GOLDEN_POINTS = 4096  # host golden of a keyword or multi-party single: random rows checked
MP_PARTIES = 3
TREE_KEYS = 1 << 16  # keyword search trees: a 256 x 256 sqrt tree, and a
BST_KEYS = 1 << 12   # binary search tree of 12 levels
PROBE_CHECK_ITERS = (0, 1, 7, 256)  # overlap probe: rounds checked in phase 2
PROBE_LONG_ITERS = 16384  # rounds at which both probe chains take over 1 ms
UPDATES = 4096  # live row updates of the 1 GiB tables
# phase 4c, the serving shell: two PirServices on the 1 GiB table
SVC_FAST_BATCH = 4096
SVC_COMPAT_BATCH = 1024
SVC_BATCHES = 3
SVC_KW_BATCH = 8  # a keyword batch of 64 would spend ~53 s in the plain-torch point walk
SVC_ASPIR_BATCH = 64
SVC_UPDATES = 4096
SVC_KEY_BYTES = 32  # the auth-key table: one 32-byte key a row
# phase 4e: the mesh engine over one card named MESH_TP * MESH_DP times
MESH_TP, MESH_DP = 4, 2
MESH_TP_ODD = 3  # compat batches take the host-prefix step off a power of two
MESH_FAST_BATCH = 4096
MESH_COMPAT_BATCH = 1024
MESH_PREFIX_BATCH = 64  # distinct-key fast and tp-3 compat batches
MESH_KW_BATCH = 8
MESH_MP_BATCH = 4
MESH_UPDATES = 4096
# phase 4f: the all-torch fast expansion, the per-query fast answers, the
# native C++ engine
REST_XLA_BATCH = 4096
REST_ANSWER_Q = 8
REST_NATIVE_BATCH = 16
# the cPIR yardstick (benchmarks_paillier_tpu.py's shape) and its key size
CPIR_ROWS = 1 << 10
CPIR_SLOT_BYTES = 3
CPIR_KEY_BYTES = 8  # AHE ASPIR auth keys (secparam bytes, test_constants.go:16)
# phase 4d, cPIR on the card (kernels 9 and 10) with a config.PAILLIER_BITS key
CPIR_CHECK_ROWS, CPIR_CHECK_COLS = 64, 4  # (a): a level-1 scan chunk, kernel vs plain
CPIR_CHECK_MODEXPS, CPIR_CHECK_BITS = 16, 256  # (a): modexps mod N^2, kernel vs plain
CPIR_BATCH = 1024  # (b): encryptions and decryptions against CPython pow
CPIR_L2_MODEXPS = 64  # (b): modexps mod N^3 with exponents of bits(N^2)
CPIR_L2_SCAN_ROWS = 32  # phase 5: a level-2 scan, the yardstick's 32 blocks of one column
CPIR_GRID_ROWS = 1 << 20  # (d): the sqrt grid, 1024 x 1024 slots of CPIR_SLOT_BYTES
CPIR_GRID_SAMPLES = 8  # (d): columns held against CPython
# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer rate: 64 INT32 lanes per SM per clock against the 128
# float32 lanes behind the 67 TFLOP/s float32 figure (which counts an
# FMA as two operations), so a quarter of it
INT32_OPS_PER_S = 67e12 / 4
# integer instructions at the issue rate: a scheduler issues one warp
# instruction a clock and integer work has the integer pipe and (IMAD) the
# FMA pipe, 32 lanes a scheduler, so half the float32 figure
INT_ISSUE_PER_S = 67e12 / 2
# shared memory: 32 banks of 4 bytes a clock an SM, so one conflict-free
# 32-lane load a clock, half the integer rate
SMEM_WORDS_PER_S = 67e12 / 8
# One T-table AES-128 block (csrc/aes_lanes.cuh), by the pipe each
# instruction needs. Integer (ALU) pipe: in each of rounds 1-9, 16 byte
# extractions (PRMT), 12 rotations (SHF) and 8 three-input XORs (LOP3);
# in round 10, 16 extractions, 12 byte assemblies (PRMT) and 4 XORs (the
# first key's XORs fold into the three-input XOR that made the input).
# FMA pipe: one IMAD a lookup (its shared address). Shared memory: 160
# lookups, one pass each on the per-bank table (the 11 warp-uniform
# round-key loads are left out). Phase 1 counts the same from the SASS
# of one block (aes_sass_counts) and fails if the SASS needs fewer.
AES_BLOCK_PIPES = {"alu": 9 * (16 + 12 + 8) + (16 + 12 + 4), "fma": 160, "lds": 160}
AES_PIPE_RATES = {"alu": INT32_OPS_PER_S, "fma": INT32_OPS_PER_S, "lds": SMEM_WORDS_PER_S}
# ptxas -v fields logged per kernel in phase 1
PTXAS_FIELDS = (("registers", r"Used (\d+) registers"),
                ("static_smem_bytes", r"(\d+) bytes smem"),
                ("stack_bytes", r"(\d+) bytes stack frame"),
                ("spill_store_bytes", r"(\d+) bytes spill stores"),
                ("spill_load_bytes", r"(\d+) bytes spill loads"))
# Nsight Compute metrics read on one launch of kernels 1 and 3
NCU_METRICS = ("l1tex__data_bank_conflicts_pipe_lsu_mem_shared_op_ld.sum",
               "smsp__inst_executed_pipe_lsu.sum",
               "sm__pipe_alu_cycles_active.avg.pct_of_peak_sustained_active",
               "gpu__time_duration.sum")
NCU_TIMEOUT_S = 240

# Phase 1's probe of the AES: BLOCKS chained encryptions a thread on the
# per-bank table, as kernels 1 and 3 run them (round keys in shared memory)
AES_PROBE_CU = r"""
#include "aes_lanes.cuh"
extern "C" __global__ void aes_probe(const uint4* rk_in, uint4* io) {
  __shared__ pir_tail::AesLaneTable tb;
  __shared__ uint4 rk[11];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) pir_tail::fill_lane_table(tb, i);
  if (threadIdx.x < 11) rk[threadIdx.x] = rk_in[threadIdx.x];
  __syncthreads();
  const pir_tail::AesLanes T = pir_tail::lanes_of(tb, threadIdx.x & 31);
  const uint4 v = io[threadIdx.x];
  uint32_t s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int n = 0; n < BLOCKS; ++n) {
    uint32_t o[4];
    pir_tail::aes128(T, reinterpret_cast<const uint32_t*>(rk), s, o);
    for (int c = 0; c < 4; ++c) s[c] = o[c];
  }
  io[threadIdx.x] = make_uint4(s[0], s[1], s[2], s[3]);
}
"""
# SASS opcodes by the pipe that runs them (integer ALU, FMA, shared memory)
AES_SASS_PIPES = {"alu": ("LOP3", "SHF", "PRMT", "IADD3", "LEA", "ISETP", "SEL", "MOV"),
                  "fma": ("IMAD",), "lds": ("LDS",)}
# Phase 1's probe of one Montgomery product (csrc/mont.cuh group_mul), as
# kernels 9 and 10 run it: G lanes of K words a number in registers, one
# instance for each K of crypto/mont.py's LANE_WORDS
MONT_PROBE_CU = r"""
#include "mont.cuh"
template <int K>
__global__ void mont_probe(const uint32_t* n, uint32_t n0inv, int G, uint32_t* io) {
  auto g = pir_mont::LaneGroup<K>::make(G, (int)(threadIdx.x & 31) % G, n, n0inv);
  typename pir_mont::LaneGroup<K>::Val a;
  uint32_t* p = io + (threadIdx.x / G) * G * K;
  g.load(p, G * K, a);
  g.mul(a, a, a);
  g.store(p, G * K, a);
}
#define PROBE(K) template __global__ void mont_probe<K>(const uint32_t*, uint32_t, int, uint32_t*);
PROBE(1) PROBE(2) PROBE(3) PROBE(4) PROBE(6) PROBE(8) PROBE(12) PROBE(16) PROBE(24)
"""
# A Montgomery product of L words runs 2 L^2 + L wide (32 x 32 -> 64)
# products, each two 32-bit integer multiply results at the INT32 rate: the
# kernels' operations bound (mont_ms). A round of the group product does
# 2 K wide products a lane (2 L_pad a group, plus m_i's low multiply).
# Phase 1 counts the SASS of a round by pipe for each K (mont_sass_counts:
# a loop step holds K rounds for K <= 8, one above; an IMAD.WIDE takes two
# FMA-pipe slots, shuffles and ballots the shared-memory pipe's) and fails
# if a round does fewer wide products a lane than the bound's 2 K.
MONT_SASS_PIPES = {"alu": ("IADD3", "VIADD", "LOP3", "SHF", "SEL", "ISETP", "LEA", "MOV",
                           "IABS", "PRMT", "ISCADD"),
                   "fma": ("IMAD",), "lsu": ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDL",
                                             "STL", "SHFL", "VOTE")}
MONT_PIPE_RATES = {"alu": INT32_OPS_PER_S, "fma": INT32_OPS_PER_S, "lsu": SMEM_WORDS_PER_S}

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def aes_sass_counts(nvcc: str, csrc: str) -> dict:
    """One AES-128 block's SASS instructions, by opcode and by pipe: the
    probe built with two chained blocks less the probe with one."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "aes_probe.cu")
        with open(src, "w") as f:
            f.write(AES_PROBE_CU)
        procs = [subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                                   "-cubin", f"-DBLOCKS={n}", "-I", csrc,
                                   "-o", os.path.join(d, f"aes{n}.cubin"), src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for n in (1, 2)]
        counts = []
        for n, proc in zip((1, 2), procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                fail(f"the AES probe did not build:\n{out}")
            sass = subprocess.run([cuobjdump, "-sass", os.path.join(d, f"aes{n}.cubin")],
                                  capture_output=True, text=True, check=True).stdout
            ops = {}
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", sass):
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
            counts.append(ops)
    one = {op: counts[1].get(op, 0) - counts[0].get(op, 0) for op in {*counts[0], *counts[1]}}
    one = {op: n for op, n in sorted(one.items()) if n}
    return {"opcodes": one,
            "pipes": {p: sum(one.get(op, 0) for op in ops) for p, ops in AES_SASS_PIPES.items()}}


def mont_sass_counts(nvcc: str, csrc: str) -> dict:
    """One round of the group product (csrc/mont.cuh group_mul) for each
    instance K, by opcode and by pipe a lane, from the SASS of
    MONT_PROBE_CU: of each instance's innermost loops (a backward branch
    with no other inside it), the one whose body holds the most wide
    multiplies (IMAD.WIDE.U32 or IMAD.HI.U32), divided by its rounds (one
    SHFL.DOWN a round: K rounds a loop step for K <= 8, else one).
    {"found": any loop found, "per_k": {K: counts}}."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "mont_probe.cu")
        with open(src, "w") as f:
            f.write(MONT_PROBE_CU)
        out = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin",
                              "-std=c++17", "-I", csrc, "-o", os.path.join(d, "mont.cubin"), src],
                             capture_output=True, text=True)
        if out.returncode != 0:
            fail(f"the Montgomery probe did not build:\n{out.stdout}{out.stderr}")
        sass = subprocess.run([cuobjdump, "-sass", os.path.join(d, "mont.cubin")],
                              capture_output=True, text=True, check=True).stdout

    def wide(text):  # a 32 x 32 -> 64 product (an address's IMAD.WIDE is signed)
        return text.startswith(("IMAD.WIDE.U32", "IMAD.HI.U32"))

    per_k = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.match(r"\S*mont_probeILi(\d+)E", part)
        if not m:
            continue
        K = int(m.group(1))
        ins = [(int(x.group(1), 16), x.group(2)) for x in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([^;]*?)\s*;", part)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []  # (first, last) instruction of each loop, by its backward branch
        for i, (a, text) in enumerate(ins):
            b = re.match(r"BRA .*?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < a and int(b.group(1), 16) in at:
                loops.append((at[int(b.group(1), 16)], i))
        best = None
        for lo, hi in loops:
            if any(lo <= lo2 and hi2 < hi for lo2, hi2 in loops):
                continue  # not innermost
            n = sum(wide(t) for _, t in ins[lo:hi + 1])
            if n >= 2 and (best is None or n > best[0]):
                best = (n, ins[lo:hi + 1])
        if best is None:
            continue
        ops = {}
        for _, text in best[1]:
            op = text.split()[0]
            ops[op] = ops.get(op, 0) + 1
        rounds = ops.get("SHFL.DOWN", 0)  # the shift's shuffle: one a round
        if not rounds:
            continue
        pipes = {p: sum(c * (2 if op.startswith("IMAD.WIDE") else 1)
                        for op, c in ops.items() if op.split(".")[0] in names) / rounds
                 for p, names in MONT_SASS_PIPES.items()}
        per_k[K] = {"rounds_in_loop": rounds, "wide_per_round": best[0] / rounds,
                    "bound_wide_per_round": 2 * K,
                    "opcodes": {op: c / rounds for op, c in sorted(ops.items())},
                    "pipes": pipes}
    return {"found": bool(per_k), "per_k": per_k}


def mont_floor_ms(plan: dict, mont_sass: dict) -> float | None:
    """The SASS issue floor of a plan's products: each product's G K
    rounds on each of its G lanes, at the busiest pipe's rate."""
    counts = mont_sass["per_k"].get(plan["K"])
    if counts is None:
        return None
    G, K = plan["G"], plan["K"]
    return plan["products"] * G * G * K * max(
        c / MONT_PIPE_RATES[p] for p, c in counts["pipes"].items()) * 1e3


def mont_ms(products: int, L: int) -> float:
    """The least time of `products` Montgomery products of L words on the
    card: their 2 L^2 + L wide products, two INT32 results each, in ms."""
    return products * (2 * L * L + L) * 2 / INT32_OPS_PER_S * 1e3


def aes_ms(blocks: int) -> float:
    """The least time of `blocks` AES-128 blocks on the card: the time of
    their busiest pipe (AES_BLOCK_PIPES), in ms."""
    return max(blocks * n / AES_PIPE_RATES[p] for p, n in AES_BLOCK_PIPES.items()) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the kernels summary JSON here")
    ap.add_argument("--ncu-launches", metavar="S,W,TAIL,NBLK,Q,NC,WC,CTAIL",
                    help="(child of the ncu reading) launch the stacked tail once at "
                         "S steps x W lane words, and one emitting compat stage at Q "
                         "queries x NC chunks x WC lane words, on random operands; exit")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from pir_tpu_torch import _build
    from pir_tpu_torch import benchmarks_overlap as ov
    from pir_tpu_torch import server as server_mod
    from pir_tpu_torch.config import PirConfig
    from pir_tpu_torch.crypto import mont
    from pir_tpu_torch.database import Database, DBMetadata
    from pir_tpu_torch.dpf import host as dpf_host
    from pir_tpu_torch.dpf.device import (
        POINT_EVAL_CHUNK,
        _compat_perm,
        _fast_leaf_perm_root,
        _fast_leaf_perm_root_stacked,
        eval_point_operands_bits,
        make_compat_payload_batch,
        make_device_point_key,
        make_fast_payload_batch,
        point_eval_operands,
        u32_tensor,
        unpack_compat_root_payload,
        unpack_key_payload,
    )
    from pir_tpu_torch.keyword import new_private_bst, new_private_sqrt_st
    from pir_tpu_torch.models.pipeline import (
        MIN_BATCH,
        compat_head,
        expand_bits_planes,
        pertail_head,
        pertail_words_t,
        small_batch_scan,
        stacked_fast_geometry,
        stacked_head,
        stacked_words_t,
    )
    from pir_tpu_torch.ops import compat_head as head_op
    from pir_tpu_torch.ops.compat_stage import compat_stage, compat_stage_plain
    from pir_tpu_torch.ops.expand import (
        fast_tail_expand_stacked,
        fast_tail_expand_stacked_plain,
    )
    from pir_tpu_torch.ops.fast_tail import fast_tail_expand, fast_tail_expand_plain
    from pir_tpu_torch.ops.fused import fused_scan_expand, fused_scan_expand_plain
    from pir_tpu_torch.ops.packed_scan import packed_scan, packed_scan_plain, unpack_words_t
    from pir_tpu_torch.ops.matmul_scan import mxu_batched_scan
    from pir_tpu_torch.ops.planes_scan import planes_scan
    from pir_tpu_torch.ops.xor_scan import masked_xor_scan, masked_xor_scan_plain
    from pir_tpu_torch.query import (
        new_fast_index_query_shares,
        new_index_query_shares,
        new_index_query_shares_batch,
        new_keyword_query_shares,
        new_keyword_query_shares_batch,
        recover,
    )
    from pir_tpu_torch.server import COMPAT_Q_CHUNK, TorchPirServer
    from pir_tpu_torch.state import database_from_numpy
    from pir_tpu_torch.utils import pad_tile
    from pir_tpu_torch.utils.bits import num_bits_for_height

    dev = torch.device("cuda", 0)
    if args.ncu_launches:
        return ncu_launches(args.ncu_launches, dev, np, torch, compat_stage,
                            fast_tail_expand_stacked)

    # ---- phase 0: the card --------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: card {smi!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")

    # ---- phase 1: build -----------------------------------------------
    t = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        sass = pool.submit(aes_sass_counts, _build.nvcc_path(), str(_build.CSRC))
        msass = pool.submit(mont_sass_counts, _build.nvcc_path(), str(_build.CSRC))
        logs = _build.build()
        aes_sass, mont_sass = sass.result(), msass.result()
    log(f"phase 1: SASS of one AES-128 block (aes_lanes.cuh): by pipe {aes_sass['pipes']}, "
        f"the bound counts {AES_BLOCK_PIPES}; opcodes {aes_sass['opcodes']}")
    if any(aes_sass["pipes"][p] < n for p, n in AES_BLOCK_PIPES.items()):
        fail("the AES bound counts more instructions on a pipe than the SASS of a block has")
    log(f"phase 1: SASS of one round of the Montgomery group product (mont.cuh group_mul), "
        f"a lane, by K: {mont_sass}; the bound counts 2 K wide products a lane a round")
    if any(c["wide_per_round"] < 2 * K for K, c in mont_sass["per_k"].items()):
        fail("the Montgomery bound counts more wide products than a round's SASS has")
    ptxas = {}  # kernel (mangled name) -> ptxas lines on registers, spills, wgmma serialized
    for name, text in logs.items():
        func = "?"
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            if m:
                func = m.group(1)
            if "registers" in line or "spill" in line or "serialized" in line:
                ptxas.setdefault(f"{name}:{func}", []).append(line.split(":", 1)[-1].strip())
                log(f"  ptxas {name} {func}: {line.strip()}")
    ptxas_summary = {}
    for key, lines in ptxas.items():
        text = " ".join(lines)
        ptxas_summary[key] = {field: int(m.group(1)) for field, pat in PTXAS_FIELDS
                              if (m := re.search(pat, text))}
        kernel = re.search(r"([a-z_]+_kernel)(I\w*?EE)?", key)
        log(f"phase 1: {key.split(':')[0]} {kernel.group(0) if kernel else key}: "
            f"{ptxas_summary[key]}")
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t:.2f} s")
    # the overlap probe's chain floor: the latencies of its dependent paths
    t = time.perf_counter()
    chain_lat = ov.chain_latencies(dev)
    log(f"phase 1: overlap probe latencies a step (clock64 cycles, globaltimer ns) {chain_lat} "
        f"in {time.perf_counter() - t:.2f} s; a round of chain B is {ov.CRIT_STEPS} wgmma steps "
        f"and one hop")
    # the fused kernel's dynamic shared memory: the larger of its roles'
    smem3 = (ctypes.c_int * 3)()
    _build.load("fused_scan_expand").pir_fused_smem_bytes(smem3)
    fused_smem = {"kSmemBytes": smem3[0], "scan_tile_bytes": smem3[1],
                  "tail_shared_bytes": smem3[2]}
    log(f"phase 1: fused kernel dynamic shared memory {fused_smem}")
    if fused_smem["kSmemBytes"] != max(smem3[1], smem3[2]):
        fail("the fused kernel's shared memory is not the larger of its roles'")

    # ---- phase 2: table and kernel checks ------------------------------
    rng = np.random.default_rng(args.seed)
    keygen_rng = np.random.default_rng(args.seed + 1)
    t = time.perf_counter()
    data = np.frombuffer(rng.bytes(HEIGHT * SLOT_BYTES), np.uint8).reshape(HEIGHT, SLOT_BYTES)
    db = database_from_numpy(data, SLOT_BYTES)
    md = DBMetadata(SLOT_BYTES, HEIGHT)
    srv = TorchPirServer(db)
    leaf_bits = dpf_host.fast_leaf_bits_for_height(HEIGHT, dpf_host.DEFAULT_FAST_LEAF_BITS)
    depth = dpf_host.fast_depth_for_height(HEIGHT, leaf_bits)
    n_blk = leaf_bits // 128
    k, tail = stacked_fast_geometry(depth, n_blk)
    table = srv._root_table_u8(1, depth, n_blk)
    torch.cuda.synchronize()
    log(f"phase 2: table {tuple(table.shape)} uint8 on {table.device} in "
        f"{time.perf_counter() - t:.2f} s; depth {depth}, n_blk {n_blk}, k {k}, tail {tail}")

    def err(a, b):
        if a.shape != b.shape:
            fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    def batch_shares(n, distinct=False, compat=False, leaf_bits=None):
        idx = [int(i) for i in rng.integers(0, HEIGHT, n)]
        if compat:
            idx[0], idx[-1] = 0, HEIGHT - 1
            return idx, new_index_query_shares_batch(md, idx, 1, rand_bytes=keygen_rng.bytes)
        if distinct:
            pairs = [new_fast_index_query_shares(md, i, 1, leaf_bits=leaf_bits,
                                                 rand_bytes=keygen_rng.bytes) for i in idx]
        else:
            pairs = new_index_query_shares_batch(md, idx, 1, fast=True, leaf_bits=leaf_bits,
                                                 rand_bytes=keygen_rng.bytes)
        return idx, pairs

    def tail_ops(shares):
        pay, layout = make_fast_payload_batch(shares)
        return stacked_head(u32_tensor(pay, dev), layout), layout

    _, pairs = batch_shares(BATCH, distinct=False)
    ops, layout = tail_ops([p[0] for p in pairs])
    few = tuple(x[:TAIL_CHECK_STEPS] for x in ops[:5]) + (ops[5], ops[6][:TAIL_CHECK_STEPS], ops[7])
    e_tail_shared = err(fast_tail_expand_stacked(*few, tail=tail, n_blk=n_blk),
                        fast_tail_expand_stacked_plain(*few, tail=tail, n_blk=n_blk))
    _, dpairs = batch_shares(DISTINCT_BATCH, distinct=True)
    dops, dlayout = tail_ops([p[0] for p in dpairs])
    if dlayout.shared_rk:
        fail("distinct-key batch was built with the shared layout")
    e_tail_distinct = err(fast_tail_expand_stacked(*dops, tail=tail, n_blk=n_blk),
                          fast_tail_expand_stacked_plain(*dops, tail=tail, n_blk=n_blk))
    packed = fast_tail_expand_stacked(*ops, tail=tail, n_blk=n_blk)
    words_t = stacked_words_t(packed, k, table.shape[0])
    ws = words_t[:, :SCAN_CHECK_Q].contiguous()
    e_scan_slice = err(packed_scan(table, ws), packed_scan_plain(table, ws))
    log(f"phase 2: kernel vs plain max_abs_err (tolerance 0, equal bytes): "
        f"tail shared {e_tail_shared} "
        f"({TAIL_CHECK_STEPS} steps), tail distinct {e_tail_distinct} "
        f"({dops[0].shape[0]} steps), scan {e_scan_slice} ({SCAN_CHECK_Q} queries)")
    if e_tail_shared or e_tail_distinct or e_scan_slice:
        fail("a kernel disagrees with its plain version")

    # compat: the cascade's storage table, then every stage of one stage
    # launch's slice of q_chunk queries against its plain version, each
    # stage fed the kernel's output
    t = time.perf_counter()
    c_qc = COMPAT_Q_CHUNK
    nbd, cw_w, tails = srv._compat_geometry(1)
    c_split = 5 + cw_w.bit_length() - 1
    table_c = srv._compat_root_table_u8(1, nbd, cw_w, tails)
    torch.cuda.synchronize()
    log(f"phase 2: compat table {tuple(table_c.shape)} in {time.perf_counter() - t:.2f} s; "
        f"device_bits {nbd}, head {c_split} levels, stages {tails}, w {cw_w}, q_chunk {c_qc}")

    def compat_ops(shares):
        pay, layout = make_compat_payload_batch(shares, height=HEIGHT)
        return compat_head(u32_tensor(pay, dev), layout, cw_w)

    def stage_args(ops, seeds, t_, off, tl):
        _, _, cw_s, cw_tl, cw_tr, rk, fcw = ops
        return (seeds, t_, cw_s[:, off:off + tl].contiguous(), cw_tl[:, off:off + tl].contiguous(),
                cw_tr[:, off:off + tl].contiguous(), rk, fcw)

    def head_operands(pay_t, layout):
        """The head kernel's operands from a payload batch, as
        models.pipeline.compat_head unpacks them."""
        seeds, t_, cw_s, cw_tl, cw_tr, _, rk = unpack_compat_root_payload(pay_t, layout)
        return (seeds.contiguous(), t_.contiguous(), cw_s, cw_tl.contiguous(),
                cw_tr.contiguous(), rk)

    _, cpairs = batch_shares(c_qc, compat=True)
    # the head kernel against the plain walk on the slice's payloads
    hpay, hlayout = make_compat_payload_batch([p[0] for p in cpairs], height=HEIGHT)
    hops = head_operands(u32_tensor(hpay, dev), hlayout)
    h_got = head_op.compat_head(*hops, skip=hlayout.skip, w=cw_w)
    h_want = head_op.compat_head_plain(*hops, skip=hlayout.skip, w=cw_w)
    e_head = [max(err(h_got[0], h_want[0]), err(h_got[1], h_want[1]))]
    del hops, h_got, h_want
    log(f"phase 2: compat head kernel vs plain walk max_abs_err {e_head[0]} ({c_qc} queries, "
        f"skip {hlayout.skip}, {c_split} levels; tolerance 0, equal bytes)")
    if e_head[0]:
        fail("the compat head kernel disagrees with its plain version")
    cops = compat_ops([p[0] for p in cpairs])
    seeds_c, t_c = cops[0], cops[1]
    e_compat = []
    off = 0
    for si, tl in enumerate(tails):
        last = si == len(tails) - 1
        args_ = stage_args(cops, seeds_c, t_c, off, tl)
        got = compat_stage(*args_, tail=tl, emit_bits=last)
        want = compat_stage_plain(*args_, tail=tl, emit_bits=last)
        if last:
            e_compat.append(err(got, want))
        else:
            e_compat.append(max(err(got[0], want[0]), err(got[1], want[1])))
            seeds_c, t_c = got
        off += tl
    del got, want, seeds_c, t_c
    log(f"phase 2: compat stage vs plain max_abs_err per stage {e_compat} "
        f"({c_qc} queries; tolerance 0, equal bytes; the last stage emits bits)")
    if any(e_compat):
        fail("the compat stage kernel disagrees with its plain version")

    # per-query tail (fast_stacked=False): the classic tables of the
    # 1024-bit keys and of the stream's 128-bit keys; the tail kernel on a
    # 64-query slice of a 4096-batch's operands and on a distinct-key
    # batch of 64, the fused kernel on FUSED_CHECK_Q queries of each of
    # two 128-bit batches (words of one, tail operands of the next)
    t = time.perf_counter()
    srv_pt = TorchPirServer(db, fast_stacked=False)
    table_pt = srv_pt._root_table_u8(1, depth, n_blk, stacked=False)
    depth_s = dpf_host.fast_depth_for_height(HEIGHT, STREAM_LEAF_BITS)
    table_s = srv_pt._root_table_u8(1, depth_s, 1, stacked=False)
    torch.cuda.synchronize()

    def pertail_ops(shares):
        pay, layout = make_fast_payload_batch(shares)
        return pertail_head(u32_tensor(pay, dev), layout, srv_pt.tail_levels)

    pt_ops, pt_tail = pertail_ops([p[0] for p in pairs])
    log(f"phase 2: classic tables {tuple(table_pt.shape)} (depth {depth}) and "
        f"{tuple(table_s.shape)} (depth {depth_s}, 128-bit leaves) in "
        f"{time.perf_counter() - t:.2f} s; per-query tail: head {depth - pt_tail} levels, "
        f"tail {pt_tail}, NW0 {pt_ops[0].shape[-1]}")
    few = tuple(x if i in (5, 7) else x[:TAIL_CHECK_Q] for i, x in enumerate(pt_ops))
    e_pt_shared = err(fast_tail_expand(*few, levels=pt_tail),
                      fast_tail_expand_plain(*few, levels=pt_tail))
    dpt_ops, _ = pertail_ops([p[0] for p in dpairs])
    e_pt_distinct = err(fast_tail_expand(*dpt_ops, levels=pt_tail),
                        fast_tail_expand_plain(*dpt_ops, levels=pt_tail))
    del few, dpt_ops
    f_ops = [pertail_ops([p[0] for p in batch_shares(FUSED_CHECK_Q,
                                                     leaf_bits=STREAM_LEAF_BITS)[1]])
             for _ in range(2)]
    s_tail = f_ops[0][1]
    f_words = pertail_words_t(fast_tail_expand(*f_ops[0][0], levels=s_tail), table_s.shape[0])
    got = fused_scan_expand(table_s, f_words, *f_ops[1][0], levels=s_tail)
    want = fused_scan_expand_plain(table_s, f_words, *f_ops[1][0], levels=s_tail)
    e_fused = max(err(got[0], want[0]), err(got[1], want[1]))
    del f_ops, f_words, got, want
    log(f"phase 2: per-query tail vs plain max_abs_err: shared {e_pt_shared} "
        f"({TAIL_CHECK_Q} queries), distinct {e_pt_distinct} ({DISTINCT_BATCH} queries); "
        f"fused scan + tail (tail {s_tail} levels) {e_fused} ({FUSED_CHECK_Q} queries, "
        f"both outputs); tolerance 0, equal bytes")
    if e_pt_shared or e_pt_distinct or e_fused:
        fail("a per-query tail or fused kernel disagrees with its plain version")

    # masked-XOR scan (single queries and small batches): the natural-order
    # word table, a fifth 1 GiB table; the kernel at Q = 1 on it with the
    # bits of a compat single of the single-query paths below, and at
    # Q = MIN_BATCH on the stacked table's word view with that many
    # queries' selection words of the 4096-batch above
    t = time.perf_counter()
    table_w = srv._table(1)
    torch.cuda.synchronize()
    single_idx = [0, HEIGHT - 1, int(rng.integers(HEIGHT))]
    singles = {kind: [new_index_query_shares(md, i, 1, fast=kind == "fast",
                                             rand_bytes=keygen_rng.bytes) for i in single_idx]
               for kind in ("fast", "compat")}
    xs_bits1 = srv.expand_shared_query(singles["compat"][2][0])
    table_sw = table.view(torch.int32)
    xs_bits8 = unpack_words_t(words_t[:, :MIN_BATCH])
    e_xs1 = err(masked_xor_scan(table_w, xs_bits1), masked_xor_scan_plain(table_w, xs_bits1))
    e_xs8 = err(masked_xor_scan(table_sw, xs_bits8), masked_xor_scan_plain(table_sw, xs_bits8))
    log(f"phase 2: natural word table {tuple(table_w.shape)} int32 and a compat single's "
        f"expansion in {time.perf_counter() - t:.2f} s; masked-XOR scan vs plain max_abs_err: "
        f"Q = 1 on the natural table {e_xs1}, Q = {MIN_BATCH} on the stacked table's words "
        f"{tuple(table_sw.shape)} {e_xs8} (tolerance 0, equal bytes)")
    if e_xs1 or e_xs8:
        fail("the masked-XOR scan kernel disagrees with its plain version")

    # bit-plane scan (keyword batches): Q = 1, 13 and 64 (the small-batch
    # tile) and 65 (the 128-query tile) on a 2^16-row slice of the natural
    # table's bytes; Q = 13, 64 and 130 on a whole table of 3-byte slots,
    # whose rows pad to 4 bytes (the plain version's products are small there)
    t = time.perf_counter()
    table_b = table_w.view(torch.uint8)
    table_3 = TorchPirServer(database_from_numpy(np.ascontiguousarray(data[:, :3]), 3))._table(1)
    table_3 = table_3.view(torch.uint8)
    e_ps = {}
    for label, tbl, qs in ((f"{PLANES_CHECK_ROWS} rows x {SLOT_BYTES} B",
                            table_b[:PLANES_CHECK_ROWS], (1, 13, 64, 65)),
                           (f"{HEIGHT} rows x 3 B slots", table_3, (13, 64, 130))):
        for q in qs:
            bits = torch.from_numpy(rng.integers(0, 2, (q, tbl.shape[0]), dtype=np.uint8)).to(dev)
            e_ps[f"{label}, Q = {q}"] = err(planes_scan(tbl, bits), mxu_batched_scan(tbl, bits))
    del table_3, bits
    log(f"phase 2: bit-plane scan vs plain max_abs_err (tolerance 0, equal bytes) "
        f"{e_ps} in {time.perf_counter() - t:.2f} s")
    if any(e_ps.values()):
        fail("the bit-plane scan kernel disagrees with its plain version")

    # overlap probe (kernel 8): the integer chain, the wgmma chain, both in
    # one kernel in two placements, and the first two on two streams, at
    # PROBE_CHECK_ITERS rounds
    t = time.perf_counter()
    pv, pa, pb = ov.make_inputs(args.seed, dev)
    e_probe = {}
    for iters in PROBE_CHECK_ITERS:
        want_v, want_m = ov.vpu_chain(pv, iters), ov.mxu_chain(pa, pb, iters)
        got_c, got_s = ov.mixed_probe(pv, pa, pb, iters), ov.streams(pv, pa, pb, iters)
        got_cs = ov.mixed_split_probe(pv, pa, pb, iters)
        e_probe[iters] = {"A": err(ov.vpu_probe(pv, iters), want_v),
                          "B": err(ov.mxu_probe(pa, pb, iters), want_m),
                          "C": max(err(got_c[0], want_v), err(got_c[1], want_m)),
                          "C_split": max(err(got_cs[0], want_v), err(got_cs[1], want_m)),
                          "streams": max(err(got_s[0], want_v), err(got_s[1], want_m))}
    del want_v, want_m, got_c, got_s, got_cs
    log(f"phase 2: overlap probe vs plain max_abs_err by rounds (tolerance 0, equal int32 "
        f"words) {e_probe} in {time.perf_counter() - t:.2f} s")
    if any(any(e.values()) for e in e_probe.values()):
        fail("an overlap probe kernel disagrees with its plain version")

    def rows_of(results):
        return np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8) for r in results])

    def check_recovered(idx, answers, label, rows=None):
        """answers recover the database's rows at idx (or `rows`)."""
        rec = answers[0] ^ answers[1]
        want = db.data[np.asarray(idx)] if rows is None else rows
        bad = np.flatnonzero((rec != want).any(axis=1))
        if bad.size:
            fail(f"{label}: {bad.size} of {len(idx)} answers do not recover (first {bad[0]})")

    def serve_and_check(idx, pairs, label, asynchronous=False, server=None, answers=None):
        """Both shares through `server` (the stacked server by default);
        returns the per-share seconds and appends the two answer arrays
        to `answers` when given."""
        server = server or srv
        times = []
        ans = []
        if asynchronous:  # dispatch both shares, then fetch both
            t = time.perf_counter()
            futs = [server.private_secret_shared_query_batch_async([p[part] for p in pairs])
                    for part in (0, 1)]
            results = [f() for f in futs]
            times.append(time.perf_counter() - t)
        for part in (0, 1):
            if asynchronous:
                res = results[part]
            else:
                t = time.perf_counter()
                res = server.private_secret_shared_query_batch([p[part] for p in pairs])
                times.append(time.perf_counter() - t)
            ans.append(rows_of(res))
        check_recovered(idx, ans, label)
        if answers is not None:
            answers.append(ans)
        return times

    counted = {"stacked_tail": fast_tail_expand_stacked, "packed_scan": packed_scan,
               "compat_head": head_op.compat_head, "compat_stage": compat_stage,
               "fast_tail": fast_tail_expand,
               "fused_scan_expand": fused_scan_expand, "masked_xor_scan": masked_xor_scan,
               "planes_scan": planes_scan, "overlap_vpu": ov.vpu_probe,
               "overlap_mxu": ov.mxu_probe, "overlap_mixed": ov.mixed_probe,
               "overlap_mixed_split": ov.mixed_split_probe,
               "mont_powmod": mont.mont_powmod, "mont_scan": mont.mont_scan}
    path_launches = {}  # path -> {kernel: launches in that path's run}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts(path, needs, forbid=()):
        got = {name: fn.launches for name, fn in counted.items() if fn.launches}
        path_launches[path] = got
        log(f"  launches on the {path} path: {got}")
        if not all(got.get(name) for name in needs):
            fail(f"a kernel of the {path} path was never launched: {got} (needs {needs})")
        if any(got.get(name) for name in forbid):
            fail(f"the {path} path launched one of {forbid}: {got}")
        return got

    # ---- phase 3: the main paths -----------------------------------------
    reset_counts()
    per_batch = []
    for b in range(BATCHES):
        t = time.perf_counter()
        idx, pairs = batch_shares(BATCH, distinct=False)
        keygen_s = time.perf_counter() - t
        times = serve_and_check(idx, pairs, f"batch {b}")
        per_batch.extend(times)
        log(f"phase 3: batch {b}: keygen {keygen_s:.3f} s (client); server answers "
            f"{times[0]:.4f} s + {times[1]:.4f} s for the two shares = "
            f"{BATCH / times[0]:.0f} / {BATCH / times[1]:.0f} queries/s; all {BATCH} recovered")
    read_counts("stacked fast", ("stacked_tail", "packed_scan"))

    # one share batch again, stage by stage, each stage synchronised
    split = {}
    t = time.perf_counter()

    def mark(stage):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[stage] = now - t
        t = now

    pay, layout = make_fast_payload_batch([p[0] for p in pairs])
    mark("payload build")
    pay_t = u32_tensor(pay, dev)
    mark("upload")
    ops = stacked_head(pay_t, layout)
    mark("head walk")
    packed = fast_tail_expand_stacked(*ops, tail=tail, n_blk=n_blk)
    mark("tail kernel")
    words_t = stacked_words_t(packed, k, table.shape[0])
    mark("words regroup")
    out = packed_scan(table, words_t)
    mark("scan kernel")
    host = out.cpu().numpy()
    mark("download")
    srv._slice_batch_results(host, 1, BATCH)
    mark("result objects")
    log(f"phase 3: split of one {BATCH}-query share batch (s): " +
        ", ".join(f"{name} {sec:.4f}" for name, sec in split.items()) +
        f"; sum {sum(split.values()):.4f}")

    # compat: reference-exact batches through the same server
    reset_counts()
    per_compat_batch = []
    for b in range(COMPAT_BATCHES + 1):
        asynchronous = b == COMPAT_BATCHES
        t = time.perf_counter()
        idx, cpairs = batch_shares(COMPAT_BATCH, compat=True)
        keygen_s = time.perf_counter() - t
        times = serve_and_check(idx, cpairs, f"compat batch {b}", asynchronous)
        if asynchronous:
            log(f"phase 3: compat batch {b}: keygen {keygen_s:.3f} s (client); both shares "
                f"dispatched async, then fetched: {times[0]:.4f} s; all {COMPAT_BATCH} recovered")
        else:
            per_compat_batch.extend(times)
            log(f"phase 3: compat batch {b}: keygen {keygen_s:.3f} s (client); server answers "
                f"{times[0]:.4f} s + {times[1]:.4f} s for the two shares = "
                f"{COMPAT_BATCH / times[0]:.0f} / {COMPAT_BATCH / times[1]:.0f} queries/s; "
                f"all {COMPAT_BATCH} recovered (indices 0 and {HEIGHT - 1} among them)")
    read_counts("compat", ("compat_head", "compat_stage", "packed_scan"))

    # one compat share batch again, stage by stage, each stage synchronised
    split_c = {}
    t = time.perf_counter()

    def mark_c(stage):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split_c[stage] = now - t
        t = now

    cpay, clayout = make_compat_payload_batch([p[0] for p in cpairs], height=HEIGHT)
    mark_c("payload build")
    cpay_t = u32_tensor(cpay, dev)
    mark_c("upload")
    cops = compat_head(cpay_t, clayout, cw_w)
    mark_c("head walk")
    slices = [tuple(x[q0:q0 + c_qc] for x in cops) for q0 in range(0, COMPAT_BATCH, c_qc)]
    state = [(sl[0], sl[1]) for sl in slices]
    off = 0
    for si, tl in enumerate(tails):
        last = si == len(tails) - 1
        state = [compat_stage(*stage_args(sl, s_, t_, off, tl), tail=tl, emit_bits=last)
                 for sl, (s_, t_) in zip(slices, state)]
        off += tl
        mark_c(f"stage {si + 1} kernel (tail {tl})")
    cwords = torch.cat([x.reshape(x.shape[0], -1) for x in state])
    pad = table_c.shape[0] // 32 - cwords.shape[1]
    if pad:  # zero bits for the XOR-neutral padded rows
        cwords = torch.cat([cwords, cwords.new_zeros(COMPAT_BATCH, pad)], dim=1)
    cwords_t = cwords.t().contiguous()
    mark_c("word pad")
    cout = packed_scan(table_c, cwords_t)
    mark_c("scan kernel")
    chost = cout.cpu().numpy()
    mark_c("download")
    srv._slice_batch_results(chost, 1, COMPAT_BATCH)
    mark_c("result objects")
    del state, cwords, cout
    log(f"phase 3: split of one {COMPAT_BATCH}-query compat share batch (s): " +
        ", ".join(f"{name} {sec:.4f}" for name, sec in split_c.items()) +
        f"; sum {sum(split_c.values()):.4f}")

    # per-query tail (fast_stacked=False): 4096-query batches against the
    # classic table; then, outside the counted run, the stacked path on
    # the same shares, which must give the same bytes
    reset_counts()
    per_pt_batch, pt_runs = [], []
    for b in range(BATCHES):
        idx, pairs = batch_shares(BATCH)
        answers = []
        times = serve_and_check(idx, pairs, f"per-query tail batch {b}", server=srv_pt,
                                answers=answers)
        per_pt_batch.extend(times)
        pt_runs.append((pairs, answers[0]))
        log(f"phase 3: per-query tail batch {b}: server answers {times[0]:.4f} s + "
            f"{times[1]:.4f} s for the two shares = {BATCH / times[0]:.0f} / "
            f"{BATCH / times[1]:.0f} queries/s; all {BATCH} recovered")
    read_counts("per-query tail", ("fast_tail", "packed_scan"))
    for b, (pairs, answers) in enumerate(pt_runs):
        for part in (0, 1):
            if not np.array_equal(rows_of(srv.private_secret_shared_query_batch(
                    [p[part] for p in pairs])), answers[part]):
                fail(f"per-query tail batch {b} share {part} differs from the stacked path")
    log(f"phase 3: per-query tail answers equal the stacked path's bytes "
        f"({BATCHES} batches, both shares)")
    del pt_runs

    # one per-query tail share batch again, stage by stage, synchronised
    split_pt = {}
    t = time.perf_counter()

    def mark_pt(stage):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split_pt[stage] = now - t
        t = now

    pay, layout = make_fast_payload_batch([p[0] for p in pairs])
    mark_pt("payload build")
    pay_t = u32_tensor(pay, dev)
    mark_pt("upload")
    pt_ops, pt_tail = pertail_head(pay_t, layout, srv_pt.tail_levels)
    mark_pt("head walk")
    pt_packed = fast_tail_expand(*pt_ops, levels=pt_tail)
    mark_pt("tail kernel")
    pt_words_t = pertail_words_t(pt_packed, table_pt.shape[0])
    mark_pt("words")
    out = packed_scan(table_pt, pt_words_t)
    mark_pt("scan kernel")
    host = out.cpu().numpy()
    mark_pt("download")
    srv_pt._slice_batch_results(host, 1, BATCH)
    mark_pt("result objects")
    del pt_words_t, out
    log(f"phase 3: split of one {BATCH}-query per-query tail share batch (s): " +
        ", ".join(f"{name} {sec:.4f}" for name, sec in split_pt.items()) +
        f"; sum {sum(split_pt.values()):.4f}")

    # the serving stream, both modes: 3 batches and a flush per share,
    # counted apart; then the same shares through the batch API
    stream_s = {}
    for mode, server, lb, needs in (
            ("fused", srv_pt, STREAM_LEAF_BITS, ("fused_scan_expand",)),
            ("stacked", srv, None, ("stacked_tail", "packed_scan"))):
        s_batches = [batch_shares(BATCH, leaf_bits=lb) for _ in range(BATCHES)]
        reset_counts()
        rows, secs = [], []
        for part in (0, 1):
            stream = server.fast_serving_stream()
            t = time.perf_counter()
            futs = [stream.submit([p[part] for p in pairs]) for _, pairs in s_batches]
            futs = futs[1:] + [stream.flush()]
            rows.append([rows_of(f()) for f in futs])
            secs.append(time.perf_counter() - t)
        read_counts(f"{mode} stream", needs)
        stream_s[mode] = secs
        for b, (idx, pairs) in enumerate(s_batches):
            check_recovered(idx, [rows[0][b], rows[1][b]], f"{mode} stream batch {b}")
            for part in (0, 1):
                if not np.array_equal(rows[part][b], rows_of(
                        server.private_secret_shared_query_batch([p[part] for p in pairs]))):
                    fail(f"{mode} stream batch {b} share {part} differs from the batch API")
        log(f"phase 3: {mode} stream ({'128-bit' if lb else 'default'} keys): "
            f"{BATCHES} batches of {BATCH} and a flush in {secs[0]:.4f} s + {secs[1]:.4f} s "
            f"for the two shares = {BATCHES * BATCH / secs[0]:.0f} / "
            f"{BATCHES * BATCH / secs[1]:.0f} queries/s per server; all recovered, equal to "
            f"the batch API's bytes")
    del rows, s_batches

    # single queries and small batches on the 1 GiB table: the host golden
    # of every share first (numpy, in threads), then each path with the
    # launch counts set to 0 just before it and read just after
    t = time.perf_counter()
    sh_keys = [(kind, q, part) for kind in singles for q in range(len(single_idx))
               for part in (0, 1)]

    def host_answer(key):
        kind, q, part = key
        return bytes(server_mod.private_secret_shared_query(db, singles[kind][q][part])
                     .shares[0].data)

    with ThreadPoolExecutor(max_workers=min(len(sh_keys), os.cpu_count() or 1)) as pool:
        golden = dict(zip(sh_keys, pool.map(host_answer, sh_keys)))
    log(f"phase 3: host golden of {len(sh_keys)} single shares in "
        f"{time.perf_counter() - t:.2f} s")

    def check_answers(kind, label, got):
        """got[q][part]: answer bytes of singles[kind][q][part]."""
        for q, idx in enumerate(single_idx):
            for part in (0, 1):
                if got[q][part] != golden[(kind, q, part)]:
                    fail(f"{label}: index {idx} share {part} differs from the host golden")
            rec = np.frombuffer(got[q][0], np.uint8) ^ np.frombuffer(got[q][1], np.uint8)
            if not np.array_equal(rec, data[idx]):
                fail(f"{label}: index {idx} does not recover")

    def first_slot(res):
        return bytes(res.shares[0].data)

    single_s = {}  # path -> seconds per query per server
    for path, style, server, answer, needs, forbid in (
            ("fast single, stacked", "fast", srv, None, ("stacked_tail", "masked_xor_scan"),
             ("packed_scan",)),
            ("fast single, per-query tail", "fast", srv_pt, None,
             ("fast_tail", "masked_xor_scan"), ("packed_scan",)),
            ("compat single", "compat", srv, None, ("masked_xor_scan",), ()),
            ("fast expand + scan", "fast", srv, "expand", ("masked_xor_scan",), ()),
            ("compat expand + scan", "compat", srv, "expand", ("masked_xor_scan",), ()),
            (f"fast batch of {SMALL_BATCH}", "fast", srv, "batch",
             ("stacked_tail", "masked_xor_scan"), ("packed_scan",)),
            (f"compat batch of {SMALL_BATCH}", "compat", srv, "batch", ("masked_xor_scan",), ())):
        reset_counts()
        t = time.perf_counter()
        if answer == "batch":  # the three indices' shares as one batch a share
            rows = [[first_slot(r) for r in server.private_secret_shared_query_batch(
                [pair[part] for pair in singles[style]])] for part in (0, 1)]
            got = [[rows[0][q], rows[1][q]] for q in range(SMALL_BATCH)]
        elif answer == "expand":
            got = [[first_slot(server.private_secret_shared_query_with_expanded_bits(
                s, server.expand_shared_query(s))) for s in pair] for pair in singles[style]]
        else:
            got = [[first_slot(server.private_secret_shared_query(s)) for s in pair]
                   for pair in singles[style]]
        single_s[path] = (time.perf_counter() - t) / (2 * len(single_idx))
        read_counts(path, needs, forbid)
        check_answers(style, path, got)
        log(f"phase 3: {path}: {single_s[path]:.4f} s per query per server (mean of "
            f"{2 * len(single_idx)}, first use included); indices {single_idx}, both shares, "
            f"equal to the host golden, all recovered")

    # one single of each kind again, stage by stage, each stage synchronised
    single_split = {}

    def split_single(label, fn):
        marks = {}
        t0 = [time.perf_counter()]

        def mark_s(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            marks[stage] = now - t0[0]
            t0[0] = now

        fn(mark_s)
        single_split[label] = marks
        log(f"phase 3: split of one {label} (s): " +
            ", ".join(f"{name} {sec:.4f}" for name, sec in marks.items()) +
            f"; sum {sum(marks.values()):.4f}")

    f_share = singles["fast"][2][0]
    c_share = singles["compat"][2][0]

    def fast_stacked_single(mark_s):
        pay, layout = make_fast_payload_batch(pad_tile([f_share], MIN_BATCH), shared_rk=True)
        mark_s("payload build")
        pay_t = u32_tensor(pay, dev)
        mark_s("upload")
        pay_k = torch.cat([pay_t, pay_t[:1].expand(k - MIN_BATCH, -1)])  # the step of k
        s_ops = stacked_head(pay_k, layout)
        mark_s("head walk")
        s_packed = fast_tail_expand_stacked(*s_ops, tail=tail, n_blk=n_blk)
        mark_s("tail kernel")
        s_words = stacked_words_t(s_packed, k, table.shape[0])[:, :MIN_BATCH]
        mark_s("words regroup")
        s_out = small_batch_scan(table, s_words)
        mark_s("scan kernel")
        s_out[:1].cpu()
        mark_s("download")

    def fast_pertail_single(mark_s):
        pay, layout = make_fast_payload_batch(pad_tile([f_share], MIN_BATCH), shared_rk=True)
        mark_s("payload build")
        pay_t = u32_tensor(pay, dev)
        mark_s("upload")
        p_ops, p_tail = pertail_head(pay_t, layout, srv_pt.tail_levels)
        mark_s("head walk")
        p_packed = fast_tail_expand(*p_ops, levels=p_tail)
        mark_s("tail kernel")
        p_words = pertail_words_t(p_packed, table_pt.shape[0])
        mark_s("words")
        p_out = small_batch_scan(table_pt, p_words)
        mark_s("scan kernel")
        p_out[:1].cpu()
        mark_s("download")

    def compat_single(mark_s):
        pay, layout, dkey = srv._index_payload(c_share, HEIGHT)
        mark_s("key build (host levels) and payload")
        pay_t = u32_tensor(pay, dev)
        mark_s("upload")
        k_ops = unpack_key_payload(pay_t, layout)
        bits = expand_bits_planes(*k_ops[:5], k_ops[6], k_ops[5],
                                  srv._perm(dkey.plan.num_bits, HEIGHT),
                                  d_levels=layout.d_levels)
        mark_s(f"expansion ({layout.d_levels} device levels)")
        c_out = masked_xor_scan(table_w, bits)
        mark_s("scan kernel")
        c_out.cpu()
        mark_s("download")

    split_single("fast single, stacked", fast_stacked_single)
    split_single("fast single, per-query tail", fast_pertail_single)
    split_single("compat single", compat_single)

    # the tiny tables: fast keys of depth < 5 run per query (the masked-XOR
    # scan); a compat batch on 5 device levels takes the preplane route,
    # its whole walk in plain torch and one bit-plane scan launch a share
    for path, style, rows, n, needs in (
            (f"fast batch of {TINY_BATCH}, depth < 5", "fast", TINY_FAST_ROWS, TINY_BATCH,
             ("masked_xor_scan",)),
            (f"compat batch of {PREPLANE_BATCH}, 5 device levels (preplane route)", "compat",
             PREPLANE_ROWS, PREPLANE_BATCH, ("planes_scan",))):
        tiny = database_from_numpy(data[:rows], SLOT_BYTES)
        tiny_srv = TorchPirServer(tiny)
        idx = [0, rows - 1] + [int(i) for i in rng.integers(0, rows, n - 2)]
        pairs = new_index_query_shares_batch(tiny.metadata(), idx, 1, fast=style == "fast",
                                             leaf_bits=128 if style == "fast" else None,
                                             rand_bytes=keygen_rng.bytes)
        if style == "fast" and pairs[0][0].key_fast.depth >= 5:
            fail(f"the tiny fast table has depth {pairs[0][0].key_fast.depth}")
        if style == "compat" and tiny_srv._compat_device_bits(1) != 5:
            fail("the tiny compat table does not have 5 device levels")
        reset_counts()
        ans = [rows_of(tiny_srv.private_secret_shared_query_batch([p[part] for p in pairs]))
               for part in (0, 1)]
        got = read_counts(path, needs, tuple(set(counted) - set(needs)))
        if style == "compat" and got != {"planes_scan": 2}:
            fail(f"{path}: {got} launches, not one bit-plane scan a share")
        for i, pair in enumerate(pairs):
            for part in (0, 1):
                want = bytes(server_mod.private_secret_shared_query(tiny, pair[part])
                             .shares[0].data)
                if ans[part][i].tobytes() != want:
                    fail(f"{path}: query {i} share {part} differs from the host golden")
        check_recovered(idx, ans, path)
        log(f"phase 3: {path} ({rows} rows): equal to the host golden, all recovered")

    # keyword and multi-party queries on the 1 GiB table: one distinct
    # uint32 keyword a row, from --seed
    t = time.perf_counter()
    kw_rng = np.random.default_rng(args.seed + 2)
    keywords = kw_rng.choice(1 << 32, size=HEIGHT, replace=False).astype(np.uint64)
    db.set_keywords(keywords)
    kw_rows = [int(i) for i in kw_rng.integers(0, HEIGHT, KW_BATCH)]
    kw_pairs = new_keyword_query_shares_batch(md, [int(keywords[r]) for r in kw_rows], 1,
                                              rand_bytes=keygen_rng.bytes)
    log(f"phase 3: {HEIGHT} keywords and a keyword batch of {KW_BATCH} (client keygen) in "
        f"{time.perf_counter() - t:.2f} s")
    reset_counts()
    kw_answers = []
    kw_times = serve_and_check(kw_rows, kw_pairs, "keyword batch", answers=kw_answers)
    read_counts("keyword batch", ("planes_scan",), ("packed_scan", "masked_xor_scan"))
    log(f"phase 3: keyword batch of {KW_BATCH}: server answers {kw_times[0]:.4f} s + "
        f"{kw_times[1]:.4f} s for the two shares = {kw_times[0] / KW_BATCH:.4f} / "
        f"{kw_times[1] / KW_BATCH:.4f} s per query per server; all {KW_BATCH} recovered")

    # one keyword share batch again, stage by stage, each stage synchronised
    split_kw = {}
    t = time.perf_counter()

    def mark_k(stage):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split_kw[stage] = now - t
        t = now

    dkeys = [make_device_point_key(dpf_host.server_initialize(p[0].prf_keys, 32),
                                   p[0].key_two_party) for p in kw_pairs]
    mark_k("key build")
    kw_planes = srv._kw_plane_table(1)
    kw_ops = point_eval_operands(dkeys, kw_planes)
    mark_k("upload")
    kw_bits = eval_point_operands_bits(kw_ops, kw_planes, HEIGHT)
    mark_k(f"point walk (32 levels, {-(-KW_BATCH // POINT_EVAL_CHUNK)} chunks)")
    kw_out = planes_scan(srv._table(1).view(torch.uint8), kw_bits)
    mark_k("kernel 6")
    kw_host = kw_out.view(torch.int32).cpu()
    mark_k("download")
    kw_res = [srv._result_from_words(w, 1) for w in kw_host]
    mark_k("result objects")
    if not np.array_equal(rows_of(kw_res), kw_answers[0][0]):
        fail("the keyword batch split differs from the batch API")
    del kw_ops, kw_bits, kw_out
    log(f"phase 3: split of one {KW_BATCH}-query keyword share batch (s): " +
        ", ".join(f"{name} {sec:.4f}" for name, sec in split_kw.items()) +
        f"; sum {sum(split_kw.values()):.4f}")

    # keyword and multi-party singles through private_secret_shared_query
    # (counted), then each share's device bits against the host golden on
    # GOLDEN_POINTS random rows and the target, all rows of the shares'
    # bits XORed (one-hot at the target, or zero for an absent keyword),
    # and expand + scan against the single's answer
    cands = kw_rng.integers(0, 1 << 32, 64, dtype=np.uint64)
    absent = int(cands[~np.isin(cands, keywords)][0])
    kw_single_rows = [0, HEIGHT - 1, int(kw_rng.integers(HEIGHT)), None]
    mp_kw_row = int(kw_rng.integers(HEIGHT))
    single_kinds = (
        ("keyword single", kw_single_rows,
         lambda r: new_keyword_query_shares(md, absent if r is None else int(keywords[r]), 1,
                                            rand_bytes=keygen_rng.bytes)),
        (f"{MP_PARTIES}-party index single", single_idx,
         lambda r: new_index_query_shares(md, r, 1, num_shares=MP_PARTIES,
                                          rand_bytes=keygen_rng.bytes)),
        (f"{MP_PARTIES}-party keyword single", [mp_kw_row],
         lambda r: new_keyword_query_shares(md, int(keywords[r]), 1, num_shares=MP_PARTIES,
                                            rand_bytes=keygen_rng.bytes)))
    for path, rows, make in single_kinds:
        t = time.perf_counter()
        shares = [make(r) for r in rows]
        keygen_s = time.perf_counter() - t
        reset_counts()
        t = time.perf_counter()
        answers = [[first_slot(srv.private_secret_shared_query(s)) for s in sh] for sh in shares]
        n_ans = sum(len(sh) for sh in shares)
        single_s[path] = (time.perf_counter() - t) / n_ans
        read_counts(path, ("masked_xor_scan",), ("planes_scan", "packed_scan"))
        t = time.perf_counter()
        for r, sh, ans in zip(rows, shares, answers):
            rec = np.bitwise_xor.reduce(np.stack([np.frombuffer(a, np.uint8) for a in ans]))
            want = np.zeros(SLOT_BYTES, np.uint8) if r is None else data[r]
            if not np.array_equal(rec, want):
                fail(f"{path}: row {r} does not recover")
            pts = kw_rng.integers(0, HEIGHT, GOLDEN_POINTS)
            if r is not None:
                pts = np.append(pts, r)
            onehot = torch.zeros(HEIGHT, dtype=torch.uint8, device=dev)
            for s, a in zip(sh, ans):
                bits = srv.expand_shared_query(s)
                onehot ^= bits
                if first_slot(srv.private_secret_shared_query_with_expanded_bits(s, bits)) != a:
                    fail(f"{path}: expand + scan differs from the single's answer")
                nb = 32 if s.is_keyword_based else num_bits_for_height(HEIGHT)
                pf = dpf_host.server_initialize(s.prf_keys, nb)
                xs = keywords[pts] if s.is_keyword_based else pts
                if s.is_two_party:
                    gold = (dpf_host.eval_points(pf, s.share_number, s.key_two_party, xs) & 1) == 0
                else:
                    gold = (dpf_host.eval_points_mp(pf, s.key_multi_party, xs) & 1) == 1
                if not np.array_equal(bits.cpu().numpy()[pts].astype(bool), gold):
                    fail(f"{path}: row {r} share {s.share_number}: device bits differ from "
                         f"the host golden")
            hot = torch.nonzero(onehot).flatten().tolist()
            if hot != ([] if r is None else [r]):
                fail(f"{path}: the shares' bits XOR to rows {hot[:4]}, not {r}")
        log(f"phase 3: {path}: {single_s[path]:.4f} s per query per server (mean of {n_ans}, "
            f"first use included; client keygen {keygen_s:.2f} s); rows {rows}, every share; "
            f"device bits equal the host golden on {GOLDEN_POINTS} random rows and the target, "
            f"XOR one-hot, expand + scan equal, all recovered ({time.perf_counter() - t:.2f} s "
            f"of checks)")

    # the keyword search trees, made with no device, so their servers are
    # on the card: three lookups in each, every query through
    # private_secret_shared_query
    t = time.perf_counter()
    tree_keys = [f"key-{i:08d}" for i in range(TREE_KEYS)][::-1]  # descending
    sqst = new_private_sqrt_st()
    sqst.build_for_data(tree_keys)
    bst = new_private_bst()
    bst.build_for_data(tree_keys[:BST_KEYS])
    bst_data_srv = TorchPirServer(bst.data_layer)
    tree_build_s = time.perf_counter() - t

    def bst_level(lvl, index):
        shares = new_index_query_shares(bst.levels[lvl].metadata(), index, 1,
                                        rand_bytes=keygen_rng.bytes)
        return recover([bst.private_level_query(lvl, s) for s in shares])[0]

    def bst_data(index):
        shares = new_index_query_shares(bst.data_layer.metadata(), index, 1,
                                        rand_bytes=keygen_rng.bytes)
        return recover([bst_data_srv.private_secret_shared_query(s) for s in shares])

    reset_counts()
    tree_s = {}
    t = time.perf_counter()
    for i in (0, TREE_KEYS - 1, int(kw_rng.integers(TREE_KEYS))):
        row = sqst.find_bucket(tree_keys[i])
        shares = new_index_query_shares(sqst.get_second_layer_metadata(), row, sqst.height,
                                        rand_bytes=keygen_rng.bytes)
        slots = recover([sqst.private_query(s) for s in shares])
        if row * sqst.width + sqst.find_in_row(slots, tree_keys[i]) != i:
            fail(f"the sqrt tree does not find key {i}")
    tree_s["sqrt tree"] = (time.perf_counter() - t) / 3
    t = time.perf_counter()
    for i in (0, BST_KEYS - 1, int(kw_rng.integers(BST_KEYS))):
        idx, slots = bst.lookup(tree_keys[i], bst_level, bst_data)
        if idx != i or slots[0].to_string() != tree_keys[i]:
            fail(f"the binary search tree does not find key {i}")
    tree_s["binary search tree"] = (time.perf_counter() - t) / 3
    read_counts("keyword trees", ("masked_xor_scan",), ("planes_scan",))
    log(f"phase 3: keyword trees on {sqst.server().device} ({TREE_KEYS}-key sqrt tree, "
        f"{BST_KEYS}-key binary search tree of {bst.depth} levels, built in "
        f"{tree_build_s:.2f} s): s per lookup, both servers and client keygen included, "
        f"{tree_s}; every key found")
    del sqst, bst, bst_data_srv

    # the overlap probe through its entry point, at the TPU probe's 256
    # rounds and at PROBE_LONG_ITERS (each run checks its kernels against
    # the plain versions, then times A, B, C in both placements and the
    # two streams)
    reset_counts()
    t = time.perf_counter()
    probe = {it: ov.run(it, ov.REPS, dev, args.seed) for it in (ov.ITERS, PROBE_LONG_ITERS)}
    probe_s = time.perf_counter() - t
    read_counts("overlap probe", ("overlap_vpu", "overlap_mxu", "overlap_mixed",
                                  "overlap_mixed_split"))
    for it, rec in probe.items():
        log(f"phase 3: overlap probe, {it} rounds: {json.dumps(rec)}; t_B / t_A = "
            f"{rec['mxu_ms'] / rec['vpu_ms']:.3f}")
    log(f"phase 3: overlap probe runs in {probe_s:.2f} s")

    # ---- phase 4: distinct-key batches -----------------------------------
    idx, dpairs = batch_shares(DISTINCT_BATCH, distinct=True)
    for path, server, needs in (("stacked fast distinct", srv, ("stacked_tail", "packed_scan")),
                                ("per-query tail distinct", srv_pt, ("fast_tail", "packed_scan"))):
        reset_counts()
        times = serve_and_check(idx, dpairs, f"{path}-key batch", server=server)
        log(f"phase 4: {path}-key batch of {DISTINCT_BATCH}: {times[0]:.4f} s + "
            f"{times[1]:.4f} s; all recovered")
        read_counts(path, needs)

    # ---- phase 4b: live updates and persistence ----------------------------
    # srv holds the stacked, compat and natural word tables (and keyword
    # planes), srv_pt the classic tables of both key widths; a stream of
    # each mode is open with one batch of both shares submitted
    upd_rng = np.random.default_rng(args.seed + 3)
    upd_rows = upd_rng.choice(HEIGHT, size=UPDATES, replace=False)
    upd_rows[:2] = 0, HEIGHT - 1
    updates = {int(r): upd_rng.bytes(SLOT_BYTES) for r in upd_rows}

    def mixed_idx(n):
        """n indices, the first half of them updated rows."""
        idx = [int(i) for i in rng.integers(0, HEIGHT, n)]
        idx[: n // 2] = [int(r) for r in upd_rng.choice(upd_rows, n // 2)]
        return idx

    def fast_pairs(idx, lb=None):
        return new_index_query_shares_batch(md, idx, 1, fast=True, leaf_bits=lb,
                                            rand_bytes=keygen_rng.bytes)

    open_streams = {}
    for mode, server, lb in (("fused", srv_pt, STREAM_LEAF_BITS), ("stacked", srv, None)):
        idx0 = mixed_idx(BATCH)
        pairs0 = fast_pairs(idx0, lb)
        streams_ = [server.fast_serving_stream() for _ in (0, 1)]
        for part, stream in enumerate(streams_):
            if stream.submit([p[part] for p in pairs0]) is not None:
                fail(f"the {mode} stream's first submit returned a future")
        open_streams[mode] = (streams_, idx0, lb)
    old_data = db.data
    upd_s = {}
    for name, server in (("stacked server", srv), ("per-query tail server", srv_pt)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        server.apply_updates(updates)
        torch.cuda.synchronize()
        upd_s[name] = time.perf_counter() - t
    for r, b in updates.items():
        if db.data[r].tobytes() != b:
            fail(f"row {r} was not updated")
    log(f"phase 4b: {UPDATES} row updates applied (s, synchronised): {upd_s}")

    # the same updates again (equal bytes), stage by stage as apply_updates
    # runs them, and what recomputing the permutations it keeps would cost
    split_u = {}
    t = time.perf_counter()
    db.update_slots(updates, copy_on_write=True)
    split_u["database rows (copy-on-write)"] = time.perf_counter() - t
    t = time.perf_counter()
    patches = srv._row_patches(updates)
    split_u["host: permutations and packing"] = time.perf_counter() - t
    t = time.perf_counter()
    srv._swap_patched(patches)
    torch.cuda.synchronize()
    split_u["device: upload, clone and scatter"] = time.perf_counter() - t
    t = time.perf_counter()
    _fast_leaf_perm_root_stacked(depth, HEIGHT, n_blk, tail)
    _fast_leaf_perm_root(depth, HEIGHT, n_blk)
    _fast_leaf_perm_root(depth_s, HEIGHT, 1)
    _compat_perm(nbd, HEIGHT, cw_w, tails)
    perms_s = time.perf_counter() - t
    log(f"phase 4b: split of the stacked server's updates (s): " +
        ", ".join(f"{name} {sec:.4f}" for name, sec in split_u.items()) +
        f"; {len(patches)} tables, {sum(len(p[1]) for p in patches)} rows patched; the 4 "
        f"storage permutations, kept on the host, would take {perms_s:.4f} s to recompute")
    del patches

    # every path after the updates, both shares, half or more of the queries
    # on updated rows; the open streams take one more batch and flush
    reset_counts()
    upd_serve = {}
    idx = mixed_idx(BATCH)
    pairs = fast_pairs(idx)
    for path, server in (("stacked fast", srv), ("per-query tail fast", srv_pt)):
        upd_serve[path] = serve_and_check(idx, pairs, f"{path} batch after updates",
                                          server=server)
    cidx = mixed_idx(COMPAT_BATCH)
    cpairs = new_index_query_shares_batch(md, cidx, 1, rand_bytes=keygen_rng.bytes)
    upd_serve["compat"] = serve_and_check(cidx, cpairs, "compat batch after updates")
    for fast in (True, False):
        r = int(upd_rows[2 + fast])
        pair = new_index_query_shares(md, r, 1, fast=fast, rand_bytes=keygen_rng.bytes)
        check_recovered([r], [rows_of([srv.private_secret_shared_query(s)]) for s in pair],
                        f"{'fast' if fast else 'compat'} single after updates")
    for mode, (streams_, idx0, lb) in open_streams.items():
        idx1 = mixed_idx(BATCH)
        pairs1 = fast_pairs(idx1, lb)
        first = [stream.submit([p[part] for p in pairs1])() for part, stream in enumerate(streams_)]
        last = [stream.flush()() for stream in streams_]
        # the stacked stream dispatched its first batch before the updates
        check_recovered(idx0, [rows_of(x) for x in first], f"{mode} stream, first batch",
                        rows=(old_data if mode == "stacked" else db.data)[np.asarray(idx0)])
        check_recovered(idx1, [rows_of(x) for x in last], f"{mode} stream, second batch")
    read_counts("after updates", ("stacked_tail", "fast_tail", "compat_head", "compat_stage",
                                  "packed_scan", "masked_xor_scan", "fused_scan_expand"))
    log(f"phase 4b: after the updates, per share (s): {upd_serve}; fast batches of {BATCH} "
        f"on both fast paths, a compat batch of {COMPAT_BATCH}, a fast and a compat single "
        f"and one step of each stream all recover the new rows (the stacked stream's first "
        f"batch, dispatched before, the old ones)")
    del old_data, open_streams

    # persistence: the 1 GiB database through save(mmap_capable=True) and
    # load(mmap=True); a server on the map uploads its stacked table and
    # serves a fast batch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "db")
        t = time.perf_counter()
        db.save(path, mmap_capable=True)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back = Database.load(path, mmap=True)
        load_s = time.perf_counter() - t
        if not isinstance(back.data, np.memmap) or back.data.flags.writeable:
            fail("load(mmap=True) did not map the rows read-only")
        srv_m = TorchPirServer(back)
        t = time.perf_counter()
        srv_m._root_table_u8(1, depth, n_blk)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t
        idx = mixed_idx(BATCH)
        ckpt_s = serve_and_check(idx, fast_pairs(idx), "batch from the loaded checkpoint",
                                 server=srv_m)
        if not np.array_equal(back.keywords, db.keywords):
            fail("the checkpoint's keywords differ")
        del srv_m, back
    persist = {"save_s": save_s, "load_s": load_s, "upload_s": upload_s, "batch_s": ckpt_s}
    log(f"phase 4b: persistence (s): save {save_s:.4f} (mmap_capable), load {load_s:.4f} "
        f"(mmap), stacked table upload from the map {upload_s:.4f}, a fast batch of {BATCH} "
        f"{ckpt_s[0]:.4f} + {ckpt_s[1]:.4f}; all recovered")

    # ---- phase 4c: the serving shell -----------------------------------------
    t = time.perf_counter()
    svc = service_phase(db, keywords, args.seed, PirConfig(), (counted, reset_counts, read_counts),
                        rows_of, torch.cuda.synchronize)
    svc["phase_s"] = time.perf_counter() - t
    cpir_tables = svc.pop("cpir_tables")
    gc.collect()  # the services' tables
    torch.cuda.empty_cache()
    log(f"phase 4c: done in {svc['phase_s']:.2f} s; max_memory_allocated "
        f"{svc.get('max_memory_allocated', 0) / 2**30:.2f} GiB")

    # ---- phase 4d: cPIR on the card (kernels 9 and 10) -------------------------
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cpir = cpir_phase(*cpir_tables, args.seed, (counted, reset_counts, read_counts), None)
    cpir["phase_s"] = time.perf_counter() - t
    log(f"phase 4d: done in {cpir['phase_s']:.2f} s; max_memory_allocated "
        f"{cpir['max_memory_allocated'] / 2**30:.3f} GiB")
    gc.collect()  # phase 4d's services and references
    torch.cuda.empty_cache()

    # ---- phase 4e: the mesh engine over one card -------------------------------
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh_start = torch.cuda.memory_allocated()
    mesh = mesh_phase(db, args.seed, (counted, reset_counts, read_counts), rows_of, srv,
                      torch.cuda.synchronize, depth, n_blk)
    mesh["phase_s"] = time.perf_counter() - t
    mesh["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 4e: done in {mesh['phase_s']:.2f} s; memory_allocated at its start "
        f"{mesh_start / 2**30:.2f} GiB, max_memory_allocated "
        f"{mesh['max_memory_allocated'] / 2**30:.2f} GiB")
    gc.collect()  # phase 4e's engines
    torch.cuda.empty_cache()

    # ---- phase 4f: the all-torch fast expansion, the per-query fast answers,
    # ---- the native C++ engine ------------------------------------------------
    t = time.perf_counter()
    rest = rest_phase(db, args.seed, (counted, reset_counts, read_counts), rows_of, srv,
                      depth, n_blk, {k: cpir.pop(k) for k in ("key", "encrypt_rs",
                                                             "encrypt_kernel9")} | cpir,
                      cpir_tables[0])
    rest["phase_s"] = time.perf_counter() - t
    log(f"phase 4f: done in {rest['phase_s']:.2f} s")
    gc.collect()  # phase 4f's engines: no collection inside phase 5's timings
    torch.cuda.empty_cache()

    # ---- phase 5: kernel times ----------------------------------------------
    def cuda_ms(fn, reps, warm=True):
        if warm:
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    tail_ms, tail_out = cuda_ms(
        lambda: fast_tail_expand_stacked(*ops, tail=tail, n_blk=n_blk), 5)
    tail_plain_ms, tail_plain = cuda_ms(
        lambda: fast_tail_expand_stacked_plain(*ops, tail=tail, n_blk=n_blk), 1, warm=False)
    e_tail = err(tail_out, tail_plain)
    del tail_plain
    s_n, tail_w = ops[0].shape[0], ops[0].shape[-1]
    head_levels = depth - tail
    blocks = s_n * k * (3 * (1 << head_levels) * ((1 << tail) - 1) + (1 << depth) * n_blk)
    tail_bytes = sum(x.numel() * x.element_size() for x in ops) + \
        tail_out.numel() * tail_out.element_size()
    tail_bound = {"bytes": tail_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": aes_ms(blocks)}
    log(f"phase 5: stacked tail ({s_n} steps, {blocks} AES blocks): kernel {tail_ms:.4f} ms, "
        f"plain {tail_plain_ms:.4f} ms, bounds {tail_bound}, max_abs_err {e_tail}")

    def time_scan(tbl, wt, label):
        q = wt.shape[1]
        ms, out = cuda_ms(lambda: packed_scan(tbl, wt), 3)
        plain_ms, plain = cuda_ms(lambda: packed_scan_plain(tbl, wt), 1, warm=False)
        e = err(out, plain)
        del plain
        rows, width = tbl.shape
        nbytes = tbl.numel() + wt.numel() * 4 + q * width
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": 8 * 2 * q * rows * width / INT8_TENSOR_OPS_PER_S * 1e3}
        # yardstick: the same function as 8 bit-plane int8 products
        bits = unpack_words_t(wt).to(torch.int8)
        planes = [((tbl >> p) & 1).to(torch.int8) for p in range(8)]
        lib_ms, acc = cuda_ms(lambda: [torch._int_mm(bits, pl) for pl in planes], 1)
        lib_out = sum(((a & 1) << p) for p, a in enumerate(acc)).to(torch.uint8)
        e_lib = err(lib_out, out)
        del bits, planes, acc, lib_out
        log(f"phase 5: packed scan, {label} ({q} queries x {rows} rows x {width} B): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm x8 {lib_ms:.4f} ms, "
            f"bounds {bound}, max_abs_err {e} (library {e_lib})")
        if e or e_lib:
            fail(f"the packed scan disagrees at the {label} shape")
        return ms, plain_ms, bound, lib_ms, e

    scan_ms, scan_plain_ms, scan_bound, library_ms, e_scan = time_scan(table, words_t, "fast path")
    if e_tail:
        fail("the stacked tail disagrees at the main path's shapes")
    del ops, packed, words_t, tail_out
    cscan = time_scan(table_c, cwords_t, "compat path")

    # compat head: the walk of one 1024-query share batch (the compat cell's
    # shape: w 128, skip 1), kernel and plain walk; the bound is its AES
    # blocks (2 a prefix level, 3 a node of the split root-start levels)
    hops = head_operands(cpay_t, clayout)
    head_ms, head_out = cuda_ms(lambda: head_op.compat_head(*hops, skip=clayout.skip, w=cw_w),
                                20)
    head_plain_ms, head_plain = cuda_ms(
        lambda: head_op.compat_head_plain(*hops, skip=clayout.skip, w=cw_w), 1, warm=False)
    e_head.append(max(err(head_out[0], head_plain[0]), err(head_out[1], head_plain[1])))
    head_blocks = COMPAT_BATCH * (2 * clayout.skip + 3 * ((1 << c_split) - 1))
    head_bytes = sum(x.numel() * 4 for x in hops + head_out)
    head_bound = {"bytes": head_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": aes_ms(head_blocks)}
    del hops, head_out, head_plain
    log(f"phase 5: compat head per {COMPAT_BATCH}-query share batch ({head_blocks} AES blocks, "
        f"1 launch): kernel {head_ms:.4f} ms, plain walk {head_plain_ms:.4f} ms, bounds "
        f"{head_bound}, max_abs_err {e_head[-1]}")
    if e_head[-1]:
        fail("the compat head kernel disagrees at the timing shape")

    # compat stage: each stage over one 1024-query share batch in slices of
    # q_chunk, as the server runs it; kernel and plain version on one such
    # slice (the shape of every stage launch of the main path)
    cops = compat_head(cpay_t, clayout, cw_w)
    slices = [tuple(x[q0:q0 + c_qc] for x in cops) for q0 in range(0, COMPAT_BATCH, c_qc)]
    state = [(sl[0], sl[1]) for sl in slices]
    check = compat_ops([p[0] for p in cpairs[:c_qc]])
    check_state = (check[0], check[1])
    stage_ms, stage_plain_ms, stage_slice_ms = [], [], []
    work = {"batch": [0, 0], "slice": [0, 0]}  # AES blocks, bytes

    def count(key, q, ins, out):
        nc_in, w_in = ins[0].shape[2], ins[0].shape[4]
        work[key][0] += q * nc_in * w_in * 32 * ((1 << tl) - 1) * 3
        work[key][1] += sum(x.numel() * 4 for x in ins)
        work[key][1] += sum(x.numel() * 4 for x in (out if isinstance(out, tuple) else (out,)))

    off, stage_blocks = 0, []
    for si, tl in enumerate(tails):
        last = si == len(tails) - 1
        blocks_before = work["batch"][0]

        def run(sl_list, st_list):
            return [compat_stage(*stage_args(sl, s_, t_, off, tl), tail=tl, emit_bits=last)
                    for sl, (s_, t_) in zip(sl_list, st_list)]

        ms, outs = cuda_ms(lambda: run(slices, state), 3)
        stage_ms.append(ms)
        c_args = stage_args(check, *check_state, off, tl)
        ms, (got,) = cuda_ms(lambda: run([check], [check_state]), 3)
        stage_slice_ms.append(ms)
        ms, plain = cuda_ms(lambda: compat_stage_plain(*c_args, tail=tl, emit_bits=last), 1,
                            warm=False)
        stage_plain_ms.append(ms)
        e_compat.append(err(got, plain) if last else
                        max(err(got[0], plain[0]), err(got[1], plain[1])))
        for sl, (s_, t_), o in zip(slices, state, outs):
            count("batch", sl[0].shape[0], stage_args(sl, s_, t_, off, tl), o)
        count("slice", c_qc, c_args, got)
        stage_blocks.append(work["batch"][0] - blocks_before)
        if not last:
            state, check_state = outs, got
        off += tl
        del outs, plain, got

    def bound_of(key):
        blocks, nbytes = work[key]
        return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                "operations": aes_ms(blocks)}

    compat_ms, compat_slice_ms = sum(stage_ms), sum(stage_slice_ms)
    compat_plain_ms = sum(stage_plain_ms)
    compat_bound, compat_slice_bound = bound_of("batch"), bound_of("slice")
    compat_launches_per_batch = len(tails) * -(-COMPAT_BATCH // c_qc)
    log(f"phase 5: compat stage per {COMPAT_BATCH}-query share batch ({work['batch'][0]} AES "
        f"blocks, {compat_launches_per_batch} launches): kernel {compat_ms:.4f} ms "
        f"(stages {[round(x, 4) for x in stage_ms]}), bounds {compat_bound}")
    stage_bound_ms = [aes_ms(b) for b in stage_blocks]
    log(f"phase 5: compat stages' AES bounds per share batch {stage_bound_ms} ms, kernel / "
        f"bound {[round(m / b, 4) for m, b in zip(stage_ms, stage_bound_ms)]}")
    log(f"phase 5: compat stage per {c_qc}-query slice ({work['slice'][0]} AES blocks, "
        f"{len(tails)} launches): kernel {compat_slice_ms:.4f} ms "
        f"(stages {[round(x, 4) for x in stage_slice_ms]}), plain {compat_plain_ms:.4f} ms "
        f"(stages {[round(x, 4) for x in stage_plain_ms]}), bounds {compat_slice_bound}; "
        f"max_abs_err {max(e_compat)}")
    if any(e_compat):
        fail("the compat stage kernel disagrees at the timing shapes")

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    def tail_blocks(q, nw0, levels, blocks_per_leaf):
        """AES blocks of a per-query tail: each of a query's 32 * NW0 head
        nodes expands 2^levels - 1 nodes (3 blocks each), and each leaf
        runs blocks_per_leaf CTR blocks."""
        nodes = 32 * nw0
        return q * (nodes * ((1 << levels) - 1) * 3 + (nodes << levels) * blocks_per_leaf)

    # per-query tail: one 4096-query share batch of the per-query tail path
    pt_ms, pt_out = cuda_ms(lambda: fast_tail_expand(*pt_ops, levels=pt_tail), 5)
    pt_plain_ms, pt_plain = cuda_ms(lambda: fast_tail_expand_plain(*pt_ops, levels=pt_tail), 1,
                                    warm=False)
    e_pt = err(pt_out, pt_plain)
    del pt_plain
    pt_blocks = tail_blocks(BATCH, pt_ops[0].shape[-1], pt_tail, n_blk)
    pt_bound = {"bytes": nbytes(*pt_ops, pt_out) / HBM_BYTES_PER_S * 1e3,
                "operations": aes_ms(pt_blocks)}
    log(f"phase 5: per-query tail ({BATCH} queries, {pt_tail} levels, {pt_blocks} AES blocks): "
        f"kernel {pt_ms:.4f} ms, plain {pt_plain_ms:.4f} ms, bounds {pt_bound}, "
        f"max_abs_err {e_pt}")
    if e_pt:
        fail("the per-query tail disagrees at the main path's shapes")
    del pt_ops, pt_packed, pt_out

    # fused scan + tail: one 4096-query step of the fused stream (words of
    # one 128-bit batch, tail operands of the next); then the scan and
    # the tail kernels one after the other on the same inputs
    f_ops = [pertail_ops([p[0] for p in batch_shares(BATCH, leaf_bits=STREAM_LEAF_BITS)[1]])[0]
             for _ in range(2)]
    f_words = pertail_words_t(fast_tail_expand(*f_ops[0], levels=s_tail), table_s.shape[0])
    f_ops = f_ops[1]
    fz_ms, fz_out = cuda_ms(lambda: fused_scan_expand(table_s, f_words, *f_ops, levels=s_tail),
                            3)
    fz_plain_ms, fz_plain = cuda_ms(
        lambda: fused_scan_expand_plain(table_s, f_words, *f_ops, levels=s_tail), 1, warm=False)
    e_fz = max(err(fz_out[0], fz_plain[0]), err(fz_out[1], fz_plain[1]))
    del fz_plain
    seq_ms, _ = cuda_ms(lambda: (packed_scan(table_s, f_words),
                                 fast_tail_expand(*f_ops, levels=s_tail)), 3)
    # each half of the fused kernel alone: no tail queries, then no scan queries
    no_tail = [x if i in (5, 7) else x[:0] for i, x in enumerate(f_ops)]  # keys stay
    half_ms = {"scan half": cuda_ms(lambda: fused_scan_expand(
                   table_s, f_words, *no_tail, levels=s_tail), 3)[0],
               "tail half": cuda_ms(lambda: fused_scan_expand(
                   table_s, f_words[:, :0].contiguous(), *f_ops, levels=s_tail), 3)[0]}
    # co-issue: the step near the larger half means the AES tail issues beside
    # the tensor-core scan; near their sum, the halves take turns
    small, large = sorted(half_ms.values())
    co_issue = {"step_ms": fz_ms, "max_halves_ms": large, "sum_halves_ms": small + large,
                "hidden_of_smaller_half": (small + large - fz_ms) / small}
    log(f"phase 5: co-issue: fused step {fz_ms:.4f} ms against its halves alone, max "
        f"{large:.4f} ms, sum {small + large:.4f} ms: "
        f"{co_issue['hidden_of_smaller_half']:.3f} of the smaller half hidden")
    fz_blocks = tail_blocks(BATCH, f_ops[0].shape[-1], s_tail, 1)
    fz_parts = {"scan operations": 8 * 2 * BATCH * table_s.numel() / INT8_TENSOR_OPS_PER_S * 1e3,
                "tail operations": aes_ms(fz_blocks)}
    fz_bound = {"bytes": nbytes(table_s, f_words, *f_ops, *fz_out) / HBM_BYTES_PER_S * 1e3,
                "operations": max(fz_parts.values())}
    log(f"phase 5: fused scan + tail ({BATCH} + {BATCH} queries, tail {s_tail} levels, "
        f"{fz_blocks} AES blocks): kernel {fz_ms:.4f} ms, plain {fz_plain_ms:.4f} ms, packed "
        f"scan then per-query tail {seq_ms:.4f} ms, fused halves alone {half_ms}, "
        f"bounds {fz_bound} (parts {fz_parts}, sum "
        f"{sum(fz_parts.values()):.4f}), max_abs_err {e_fz}")
    if e_fz:
        fail("the fused kernel disagrees at the stream's shapes")
    del f_ops, f_words, fz_out

    # masked-XOR scan: Q = 1 on the natural table (a single query's scan)
    # and Q = MIN_BATCH on the stacked table's word view (a small fast batch)
    def time_xor_scan(tbl, bits, label):
        q = 1 if bits.dim() == 1 else bits.shape[0]
        ms, out = cuda_ms(lambda: masked_xor_scan(tbl, bits), 10)
        plain_ms, plain = cuda_ms(lambda: masked_xor_scan_plain(tbl, bits), 1, warm=False)
        e = err(out, plain)
        del plain
        bound = {"bytes": nbytes(tbl, bits, out) / HBM_BYTES_PER_S * 1e3,
                 "operations": 2 * q * tbl.numel() / INT32_OPS_PER_S * 1e3}
        log(f"phase 5: masked-XOR scan, {label} ({q} queries x {tbl.shape[0]} rows x "
            f"{tbl.shape[1]} words): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bounds {bound}, max_abs_err {e}")
        if e:
            fail(f"the masked-XOR scan disagrees at the {label} shape")
        return ms, plain_ms, bound, e

    xs1 = time_xor_scan(table_w, xs_bits1, "single query, natural table")
    xs8 = time_xor_scan(table_sw, xs_bits8, "small fast batch, stacked table")

    # bit-plane scan: Q = 64 (the keyword batch) and Q = 1024 on the
    # natural table's bytes, random bits; the yardstick is 8 int8 products
    # (torch._int_mm) with the table's bit planes, made once
    lib_planes = [((table_b >> p) & 1).to(torch.int8) for p in range(8)]
    ps_time = {}
    for q in KW_TIMING_Q:
        bits = torch.randint(0, 2, (q, HEIGHT), dtype=torch.uint8, device=dev)
        ms, out = cuda_ms(lambda: planes_scan(table_b, bits), 5)
        plain_ms, plain = cuda_ms(lambda: mxu_batched_scan(table_b, bits), 1, warm=False)
        e = err(out, plain)
        bits_i8 = bits.view(torch.int8)
        lib_ms, acc = cuda_ms(lambda: [torch._int_mm(bits_i8, pl) for pl in lib_planes], 1)
        e_lib = err(sum((a & 1) << p for p, a in enumerate(acc)).to(torch.uint8), out)
        bound = {"bytes": nbytes(table_b, bits, out) / HBM_BYTES_PER_S * 1e3,
                 "operations": 8 * 2 * q * table_b.numel() / INT8_TENSOR_OPS_PER_S * 1e3}
        ps_time[q] = (ms, plain_ms, bound, lib_ms, e)
        del bits, out, plain, acc, bits_i8
        log(f"phase 5: bit-plane scan ({q} queries x {HEIGHT} rows x {table_b.shape[1]} B): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm x8 {lib_ms:.4f} ms, "
            f"bounds {bound}, max_abs_err {e} (library {e_lib})")
        if e or e_lib:
            fail(f"the bit-plane scan disagrees at Q = {q}")
    del lib_planes

    # overlap probe: the kernel times of the phase-3 runs (run() raised on
    # any kernel that disagreed), each chain's plain version and, for B,
    # the same chain of torch._int_mm products; bounds for the whole card,
    # and beside them each chain's floor from phase 1's latencies
    def int_mm_chain(iters):
        acc = torch.zeros((ov.M, ov.N), dtype=torch.int32, device=dev)
        for _ in range(iters):
            acc = torch._int_mm(pa + (acc[:, :1] & 1).to(torch.int8), pb)
        return acc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    probe_time = {}
    for iters in (ov.ITERS, PROBE_LONG_ITERS):
        plain_ms = {}
        plain_ms["vpu"], want_v = cuda_ms(lambda: ov.vpu_chain(pv, iters), 1, warm=False)
        plain_ms["mxu"], want_m = cuda_ms(lambda: ov.mxu_chain(pa, pb, iters), 1, warm=False)
        plain_ms["mixed"], want_c = cuda_ms(lambda: ov.mixed(pv, pa, pb, iters), 1, warm=False)
        plain_ms["mixed_split"] = plain_ms["mixed"]  # both placements' plain version is mixed
        lib_ms, lib_out = cuda_ms(lambda: int_mm_chain(iters), 1)
        e = {"mixed": max(err(want_c[0], want_v), err(want_c[1], want_m)),
             "library": err(lib_out, want_m)}
        ops_ms = {"vpu": pv.numel() * ov.ROUND_INSTRS * iters / INT_ISSUE_PER_S * 1e3,
                  "mxu": 2 * ov.M * ov.N * ov.K * iters / INT8_TENSOR_OPS_PER_S * 1e3}
        bytes_ms = {"vpu": 2 * nbytes(pv) / HBM_BYTES_PER_S * 1e3,
                    "mxu": nbytes(pa, pb, want_m) / HBM_BYTES_PER_S * 1e3}
        bound = {"vpu": {"bytes": bytes_ms["vpu"], "operations": ops_ms["vpu"]},
                 "mxu": {"bytes": bytes_ms["mxu"], "operations": ops_ms["mxu"]},
                 # the larger chain's time: the least if the units overlap fully
                 "mixed": {"bytes": sum(bytes_ms.values()), "operations": max(ops_ms.values())}}
        bound["mixed_split"] = bound["mixed"]
        floor = ov.chain_floor_ms(chain_lat, iters)
        binds = {k: "chain" if floor[k] > max(bound[k].values())
                 else max(bound[k], key=bound[k].get) for k in floor}
        rec = probe[iters]
        probe_time[iters] = {"ms": {k: rec[f"{k}_ms"] for k in ("vpu", "mxu", "mixed",
                                                                "mixed_split")},
                             "streams_ms": rec["streams_ms"], "overlap": rec["overlap"],
                             "overlap_split": rec["overlap_split"],
                             "streams_overlap": rec["streams_overlap"],
                             "max_active_clusters": rec["max_active_clusters"],
                             "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
                             "chain_floor_ms": floor, "binds": binds,
                             "plain_max_abs_err": e}
        del want_v, want_m, want_c, lib_out
        log(f"phase 5: overlap probe, {iters} rounds: kernels {probe_time[iters]['ms']} ms, "
            f"two streams {rec['streams_ms']:.4f} ms, overlap {rec['overlap']:.4f} (split "
            f"{rec['overlap_split']:.4f}), streams overlap {rec['streams_overlap']:.4f}, "
            f"t_B / t_A {rec['mxu_ms'] / rec['vpu_ms']:.3f}; plain {plain_ms} ms, torch._int_mm "
            f"chain {lib_ms:.4f} ms, bounds {bound} (whole card; the grid is {ov.PROBE_BLOCKS} "
            f"blocks on {sms} SMs), chain floor {floor} ms, binds {binds}; residency "
            f"{rec['max_active_clusters']} (clusters of {ov.CLUSTER}: a launch needs "
            f"{ov.PROBE_BLOCKS // ov.CLUSTER}; pair: B + A blocks an SM, two streams need 1), "
            f"plain and library against plain max_abs_err {e}")
        if any(e.values()):
            fail(f"the overlap probe's plain versions or library chain disagree at {iters} rounds")

    # Nsight Compute on one stacked tail launch and one last-stage compat
    # launch at the main paths' shapes (a child process, random operands)
    nc_last = cops[0].shape[2] << sum(tails[:-1])
    ncu = ncu_reading(f"{s_n},{tail_w},{tail},{n_blk},"
                      f"{c_qc},{nc_last},{cw_w},{tails[-1]}")
    log(f"phase 5: ncu: {json.dumps(ncu)}")

    # kernels 9 and 10 (crypto/mont.py) at phase 4d's shapes: kernel 9 on (b)'s
    # r^N mod N^2 of an encryption batch (and, in the log and --out, on its
    # CRT decryption halves and its level-2 modexps), kernel 10 on (d)'s grid
    # (and a level-2 scan); each kernel and its plain version also at (a)'s
    # shapes. products and sass_floor_ms follow the plan each launch ran
    n = cpir.pop("n")
    n2, n3 = n * n, n ** 3
    prng = np.random.default_rng(args.seed + 8)

    def big(m, count):  # random ints below m
        return [int.from_bytes(prng.bytes(m.bit_length() // 8 + 8), "little") % m
                for _ in range(count)]

    def u32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    L2, L3 = mont.words_for_modulus(n2), mont.words_for_modulus(n3)
    mont_time = {}
    e_enc = max(256, 1 << (n.bit_length() - 1).bit_length())  # paillier's device route
    p2, q2 = cpir.pop("crt_moduli")
    cases = {  # name: (bases, exponents, moduli, e_max, L)
        "encrypt": ([x % n2 for x in big(n, CPIR_BATCH)], [n] * CPIR_BATCH, n2, e_enc, L2),
        "decrypt_crt": (big(p2, CPIR_BATCH) + big(q2, CPIR_BATCH),
                        big(p2, 2 * CPIR_BATCH),
                        [p2] * CPIR_BATCH + [q2] * CPIR_BATCH, None,
                        mont.words_for_modulus(max(p2, q2))),
        "level2": (big(n3, CPIR_L2_MODEXPS), big(n2, CPIR_L2_MODEXPS), n3,
                   n2.bit_length(), L3),
        "check": (big(n2, CPIR_CHECK_MODEXPS), [x % (1 << CPIR_CHECK_BITS)
                                               for x in big(n2, CPIR_CHECK_MODEXPS)],
                  n2, CPIR_CHECK_BITS, L2),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    optin = mont._smem_optin(0)
    for name, (bs, es, mods, e_max, L) in cases.items():
        if e_max is None:  # the CRT route's bound: 256-bit steps
            e_max = -(-max(e.bit_length() for e in es) // 256) * 256
        bt, et = u32(mont.ints_to_words(bs, L)), u32(mont.pack_exponents(es, e_max))
        ms9, got = cuda_ms(lambda: mont.mont_powmod(bt, et, mods, e_max), 3)
        rows = len(bs)
        plan = mont.powmod_plan(rows, L, e_max, sms, optin)
        # bound: the fewest products over every fixed window, not the
        # kernel's own plan
        rec = {"ms": ms9, "rows": rows, "e_max": e_max, "words": L, "plan": plan,
               "products": plan["products"],
               "least_products": mont.least_powmod_products(e_max, rows),
               "bound_ms": {"operations": mont_ms(mont.least_powmod_products(e_max, rows), L),
                            "bytes": nbytes(bt, et, got) / HBM_BYTES_PER_S * 1e3},
               "sass_floor_ms": mont_floor_ms(plan, mont_sass)}
        if name == "check":  # phase 4d (a) timed the plain version on its operands
            rec["plain_ms"] = cpir["s"]["check_powmod_plain"] * 1e3
            rec["max_abs_err"] = cpir["max_abs_err"]["mont_powmod"]
        mods_l = mods if isinstance(mods, list) else [mods] * rows
        sample = sorted(set(range(0, rows, max(1, rows // 16))) | {rows - 1})
        if [mont.words_to_ints(got[i:i + 1].cpu().numpy())[0] for i in sample] != [
                pow(bs[i], es[i], mods_l[i]) for i in sample]:
            fail(f"phase 5: kernel 9 differs from CPython on the {name} batch")
        mont_time[f"powmod_{name}"] = rec
        log(f"phase 5: Montgomery modexps, {name} ({rows} x {e_max}-bit exponents, {L} "
            f"words; {len(sample)} rows equal CPython): {json.dumps(rec)}")
    # kernel 10 at (d)'s grid, (a)'s chunk and the recursive query's level-2
    # scan (32 blocks, one column, exponents of bits(N^2) mod N^3)
    e_l2 = n2.bit_length()
    for name, (h, w, mod, e_max, L) in (
            ("grid", (cpir["grid"]["rows"], cpir["grid"]["width"], n2, 24, L2)),
            ("check", (CPIR_CHECK_ROWS, CPIR_CHECK_COLS, n2, 24, L2)),
            ("level2", (CPIR_L2_SCAN_ROWS, 1, n3, e_l2, L3))):
        bs = big(mod, h)
        bt = u32(mont.ints_to_words(bs, L))
        if e_max == 24:
            ev = prng.integers(0, 1 << 24, size=(h, w, 1), dtype=np.uint32)
        else:
            ev = mont.pack_exponents(big(n2, h * w), e_max).reshape(h, w, -1)
        et = u32(ev)
        ms10, got = cuda_ms(lambda: mont.mont_scan(bt, et, mod, e_max), 3)
        plan = mont.scan_plan(h, w, L, e_max, sms, optin)
        # bound: Straus's method in one chunk at the best fixed window, each
        # row's table shared by the columns (8 bits at 1024 x 1024), not the
        # kernel's own plan
        least = mont.least_scan_products(h, w, e_max)
        rec = {"ms": ms10, "rows": h, "cols": w, "e_max": e_max, "words": L, "plan": plan,
               "products": plan["products"], "least_products": least,
               "bound_ms": {"operations": mont_ms(least, L),
                            "bytes": nbytes(bt, et, got) / HBM_BYTES_PER_S * 1e3},
               "sass_floor_ms": mont_floor_ms(plan, mont_sass)}
        if name == "check":
            rec["plain_ms"] = cpir["s"]["check_scan_plain"] * 1e3
            rec["max_abs_err"] = cpir["max_abs_err"]["mont_scan"]
        cols = sorted({0, w - 1, w // 2, w // 3}) if w > 4 else range(w)
        prods = mont.words_to_ints(got.cpu().numpy())
        for c in cols:
            acc = 1
            for r in range(h):
                acc = acc * pow(bs[r], int.from_bytes(ev[r, c].tobytes(), "little"), mod) % mod
            if acc != prods[c]:
                fail(f"phase 5: kernel 10 differs from CPython on the {name} scan, column {c}")
        mont_time[f"scan_{name}"] = rec
        log(f"phase 5: Montgomery scan, {name} ({h} x {w} {e_max}-bit exponents mod a "
            f"{mod.bit_length()}-bit modulus; {len(cols)} columns equal CPython): "
            f"{json.dumps(rec)}")
        del bt, et, got
    if mont_time["powmod_check"]["max_abs_err"] or mont_time["scan_check"]["max_abs_err"]:
        fail("phase 5: a Montgomery kernel disagrees with its plain version")

    launches = {name: sum(run.get(name, 0) for run in path_launches.values())
                for name in counted}

    def entry(name, source, replaces, ms, plain_ms, bound, library_ms, e):
        by = max(bound, key=bound.get)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[by], "bound_by": by, "library_ms": library_ms}

    kernels = {"kernels": [
        entry("stacked_tail", "pir_tpu_torch/csrc/stacked_tail.cu",
              "pir_tpu/ops/pallas_expand.py:264", tail_ms, tail_plain_ms, tail_bound, None,
              max(e_tail, e_tail_shared, e_tail_distinct)),
        entry("packed_scan", "pir_tpu_torch/csrc/packed_scan.cu",
              "pir_tpu/ops/pallas_scan.py:127", scan_ms, scan_plain_ms, scan_bound, library_ms,
              max(e_scan, e_scan_slice, cscan[4])),
        # all stages of one stage launch's q_chunk-query slice (the batch's
        # time is in the log and in --out)
        entry("compat_stage", "pir_tpu_torch/csrc/compat_stage.cu",
              "pir_tpu/ops/pallas_expand.py:361", compat_slice_ms, compat_plain_ms,
              compat_slice_bound, None, max(e_compat)),
        # no Pallas counterpart: it replaces the jnp walk XLA fuses on the TPU
        entry("compat_head", "pir_tpu_torch/csrc/compat_stage.cu",
              "pir_tpu/models/pipeline.py:583", head_ms, head_plain_ms, head_bound, None,
              max(e_head)),
        entry("fast_tail", "pir_tpu_torch/csrc/fast_tail.cu",
              "pir_tpu/ops/pallas_expand.py:425", pt_ms, pt_plain_ms, pt_bound, None,
              max(e_pt, e_pt_shared, e_pt_distinct)),
        # bound: the larger of its scan's int8 tensor-core time and its
        # tail's AES time, the least if the two overlap fully
        entry("fused_scan_expand", "pir_tpu_torch/csrc/fused_scan_expand.cu",
              "pir_tpu/ops/pallas_fused.py:118", fz_ms, fz_plain_ms, fz_bound, None,
              max(e_fz, e_fused)),
        # at Q = 1 on the natural table (Q = 8 on the stacked table: log, --out);
        # no one PyTorch call XOR-reduces, hence no library time
        entry("masked_xor_scan", "pir_tpu_torch/csrc/masked_xor_scan.cu",
              "pir_tpu/ops/pallas_scan.py:182", xs1[0], xs1[1], xs1[2], None,
              max(xs1[3], xs8[3], e_xs1, e_xs8)),
        # at Q = 64, the keyword batch's shape (Q = 1024: log, --out)
        entry("planes_scan", "pir_tpu_torch/csrc/planes_scan.cu",
              "pir_tpu/ops/pallas_scan.py:53", *ps_time[KW_BATCH][:4],
              max([v[4] for v in ps_time.values()] + list(e_ps.values()))),
    ]}
    # kernels 9 and 10 have no Pallas counterpart (mont_tpu.py is jitted jnp):
    # at (b)'s encryption batch and (d)'s grid, the plain versions at (a)'s
    # shapes (the kernels' times there: log, --out); no PyTorch call does a
    # big-integer modexp, hence no library time
    for name, key, line in (("mont_powmod", "powmod_encrypt", 459),
                            ("mont_scan", "scan_grid", 267)):
        rec, chk = mont_time[key], mont_time[key.split("_")[0] + "_check"]
        kernels["kernels"].append(entry(
            name, "pir_tpu_torch/csrc/mont_exp.cu", f"pir_tpu/crypto/mont_tpu.py:{line}",
            rec["ms"], chk["plain_ms"], rec["bound_ms"], None,
            max(chk["max_abs_err"], cpir["max_abs_err"][name])))
    # the probe at the TPU probe's 256 rounds (PROBE_LONG_ITERS: log, --out);
    # only chain B has a PyTorch yardstick; max_abs_err from phase 2 (0, 1,
    # 7 and 256 rounds; run() raised on any difference at PROBE_LONG_ITERS);
    # beside the bound, the chain floor from phase 1's latencies and which
    # of the two binds ("chain", or the bound's "bytes" or "operations")
    pt = probe_time[ov.ITERS]
    for chain, label, line in (("vpu", "A", 110), ("mxu", "B", 113), ("mixed", "C", 116),
                               ("mixed_split", "C_split", 116)):
        kernels["kernels"].append(dict(entry(
            f"overlap_{chain}", "pir_tpu_torch/csrc/overlap_probe.cu",
            f"benchmarks_overlap.py:{line}", pt["ms"][chain], pt["plain_ms"][chain],
            pt["bound_ms"][chain], pt["library_ms"] if chain == "mxu" else None,
            max(e_[label] for e_ in e_probe.values())),
            chain_floor_ms=pt["chain_floor_ms"][chain], binds=pt["binds"][chain]))
    if args.out:
        summary = dict(kernels, card=smi, per_share_batch_s=per_batch,
                       split_s=split, path_launches=path_launches,
                       compat_per_share_batch_s=per_compat_batch, compat_split_s=split_c,
                       compat_head={"ms": head_ms, "plain_ms": head_plain_ms,
                                    "bound_ms": head_bound, "blocks": head_blocks},
                       compat_stage_ms=stage_ms, compat_stage_batch_bound_ms=compat_bound,
                       compat_stage_bound_ms=stage_bound_ms,
                       compat_stage_slice_ms=stage_slice_ms,
                       compat_stage_plain_ms=stage_plain_ms,
                       compat_scan={"ms": cscan[0], "plain_ms": cscan[1], "bound_ms": cscan[2],
                                    "library_ms": cscan[3]},
                       pertail_per_share_batch_s=per_pt_batch, pertail_split_s=split_pt,
                       stream_s=stream_s, fused_parts_ms=fz_parts, scan_then_tail_ms=seq_ms,
                       fused_halves_ms=half_ms, fused_co_issue=co_issue, ptxas=ptxas,
                       ptxas_summary=ptxas_summary, aes_sass=aes_sass, ncu=ncu,
                       fused_smem=fused_smem,
                       single_s_per_query=single_s, single_split_s=single_split,
                       masked_xor_scan_q8={"ms": xs8[0], "plain_ms": xs8[1],
                                           "bound_ms": xs8[2]},
                       keyword_per_share_batch_s=kw_times, keyword_split_s=split_kw,
                       planes_scan={str(q): {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
                                             "library_ms": v[3]} for q, v in ps_time.items()},
                       overlap_probe={str(k): v for k, v in probe_time.items()},
                       updates_s=upd_s, updates_split_s=split_u, permutations_s=perms_s,
                       after_updates_s=upd_serve, persistence_s=persist, service=svc,
                       cpir=cpir, mesh=mesh, rest=rest, mont_time=mont_time,
                       mont_sass=mont_sass, chain_latencies=chain_lat,
                       elapsed_s=time.perf_counter() - T0)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def service_phase(db, keywords, seed, config, counting, rows_of, sync) -> dict:
    """Phase 4c: the port's serving shell on the card. Two PirServices
    (service 0 the audit leader) over the rows and keywords of `db`, each
    with its own Database over the same rows and an auth-key table of
    SVC_KEY_BYTES a row, a third for 3-party shares; a port PirClient
    sends every request kind over 127.0.0.1. For every kind (the fast,
    compat and keyword batches, the singles, the stream, and the shared
    ASPIR batch and wrong-key single) the same shares then go through
    each service's TorchPirServer directly (both shares at once, as the
    two services answer them; for ASPIR the expansion, the answer on its
    bits and the key table's audit): the answers must be equal bytes,
    the ASPIR verdicts those of the direct audits, and the launches of
    the same kernels as many (counts set to 0 before each and read
    after). Then 4096 row updates through PirService.apply_updates
    on both services and a fast batch that recovers the new rows, and
    OP_METRICS. A second pair of services serves the cPIR yardstick
    table (CPIR_ROWS x CPIR_SLOT_BYTES) with a config.PAILLIER_BITS
    key: an encrypted query, a recursive one, and an AHE ASPIR round with
    the right key and one with a wrong key (only the null side proves).
    counting = (counted wrappers, reset_counts, read_counts); sync waits
    for the card. Returns what it measured."""
    import struct

    import numpy as np
    import torch

    from pir_tpu_torch import wire
    from pir_tpu_torch.aspir_shared import (
        check_audit,
        generate_audit_for_shared_query_with_expanded_bits,
        new_authenticated_index_query_shares,
    )
    from pir_tpu_torch.config import PAILLIER_BITS
    from pir_tpu_torch.crypto.paillier import keygen
    from pir_tpu_torch.database import DBMetadata
    from pir_tpu_torch.query import (
        new_index_query_shares,
        new_index_query_shares_batch,
        new_keyword_query_shares,
        new_keyword_query_shares_batch,
    )
    from pir_tpu_torch.service import (
        OP_ASPIR_SHARED_QUERY,
        OP_ASPIR_SHARED_QUERY_BATCH,
        OP_DENIED,
        OP_QUERY,
        OP_QUERY_BATCH,
        OP_STREAM_FLUSH,
        OP_STREAM_SUBMIT,
        PirClient,
        PirService,
        _decode_result_batch,
        _pack_blobs,
        _recv_frame,
        _send_frame,
        _unpack_blobs,
    )
    from pir_tpu_torch.slot import Slot
    from pir_tpu_torch.state import database_from_numpy

    counted, reset_counts, read_counts = counting
    rng = np.random.default_rng(seed + 4)
    keygen_rng = np.random.default_rng(seed + 5)
    height, slot = db.db_size, db.slot_bytes
    md = DBMetadata(slot, height)
    out = {"rtt_s": {}, "direct_s": {}, "split_s": {}, "launches": {}}
    t = time.perf_counter()
    key_db = database_from_numpy(np.frombuffer(rng.bytes(height * SVC_KEY_BYTES), np.uint8)
                                 .reshape(height, SVC_KEY_BYTES), SVC_KEY_BYTES)
    dbs = [database_from_numpy(db.data, slot, keywords=keywords) for _ in range(3)]
    s0 = PirService(dbs[0], config=config, key_db=key_db).start()
    s1 = PirService(dbs[1], config=config, key_db=key_db, audit_leader=s0.address).start()
    s2 = PirService(dbs[2], config=config).start()
    client = PirClient([s0.address, s1.address])
    client3 = PirClient([s0.address, s1.address, s2.address])
    if (client.metadata.slot_bytes, client.metadata.db_size) != (slot, height):
        fail(f"OP_METADATA says {client.metadata}, the table is {height} x {slot}")
    log(f"phase 4c: services on {s0.address} and {s1.address} (engine {s0.engine_name}, "
        f"device {s0._engine.device}), {height}-row auth-key table, metadata, in "
        f"{time.perf_counter() - t:.2f} s")

    def exchange(cl, frames):
        """frames[k] to server k of client cl, all sent before any answer
        is read (as PirClient fans out); the answer frames."""
        with cl._lock:
            for sock, (op, payload) in zip(cl._socks, frames):
                _send_frame(sock, op, payload)
            return [_recv_frame(sock) for sock in cl._socks]

    def both(fns):
        """fns[k]() for every server k at once (the services answer their
        shares on their own handler threads)."""
        with ThreadPoolExecutor(len(fns)) as pool:
            return list(pool.map(lambda f: f(), fns))

    def check_rows(idx, answers, label, table=None):
        table = dbs[0].data if table is None else table
        rec = np.bitwise_xor.reduce(np.stack([rows_of(a) for a in answers]), axis=0)
        want = (np.stack([table[i] if i is not None else np.zeros(slot, np.uint8)
                          for i in idx]))
        bad = np.flatnonzero((rec != want).any(axis=1))
        if bad.size:
            fail(f"service {label}: {bad.size} of {len(idx)} answers do not recover "
                 f"(first {bad[0]})")

    def launched():
        return {name: fn.launches for name, fn in counted.items() if fn.launches}

    def served(label, idx, share_lists, needs, forbid=(), cl=None, single=False,
               table=None):
        """share_lists (one list of shares a query) through the service
        (OP_QUERY_BATCH, or OP_QUERY a query when single), then through
        the engines directly; checks bytes, launches and recovery."""
        cl = cl or client
        n = len(cl._socks)
        engines = [s0._engine, s1._engine, s2._engine][:n]
        t0 = time.perf_counter()
        if single:
            payloads = [[wire.serialize_query_share(sl[k]) for k in range(n)]
                        for sl in share_lists]
        else:
            payloads = [_pack_blobs([wire.serialize_query_share(sl[k]) for sl in share_lists])
                        for k in range(n)]
        t1 = time.perf_counter()
        reset_counts()
        if single:
            frames = [exchange(cl, [(OP_QUERY, p) for p in per_q]) for per_q in payloads]
        else:
            frames = [exchange(cl, [(OP_QUERY_BATCH, p) for p in payloads])]
        t2 = time.perf_counter()
        if single:
            answers = [[wire.deserialize_shared_result(f[k][1]) if f[k][0] == OP_QUERY
                        else fail(f"service {label}: opcode {f[k][0]}: {f[k][1][:200]!r}")
                        for f in frames] for k in range(n)]
        else:
            answers = [_decode_result_batch(*frames[0][k]) for k in range(n)]
        t3 = time.perf_counter()
        svc_counts = read_counts(f"service: {label} {len(out['rtt_s'].get(label, []))}",
                                 needs, forbid)
        reset_counts()
        td = time.perf_counter()
        if single:
            direct = both([lambda e=e, k=k: [e.private_secret_shared_query(sl[k])
                                               for sl in share_lists]
                           for k, e in enumerate(engines)])
        else:
            direct = both([lambda e=e, k=k: e.private_secret_shared_query_batch(
                [sl[k] for sl in share_lists]) for k, e in enumerate(engines)])
        direct_s = time.perf_counter() - td
        direct_counts = launched()
        if direct_counts != svc_counts:
            fail(f"service {label}: launches {svc_counts}, the direct API's {direct_counts}")
        for k in range(n):
            if [wire.serialize_shared_result(r) for r in answers[k]] != \
                    [wire.serialize_shared_result(r) for r in direct[k]]:
                fail(f"service {label}: server {k}'s answers differ from the direct API's")
        check_rows(idx, answers, label, table)
        out["rtt_s"].setdefault(label, []).append(t3 - t0)
        out["direct_s"].setdefault(label, []).append(direct_s)
        out["split_s"].setdefault(label, []).append(
            {"encode": t1 - t0, "exchange": t2 - t1, "decode": t3 - t2})
        out["launches"][label] = svc_counts
        return t3 - t0, direct_s

    # fast batches (stacked path), compat batches, fast and compat singles
    for label, n, fast, needs in (
            ("fast batch", SVC_FAST_BATCH, True, ("stacked_tail", "packed_scan")),
            ("compat batch", SVC_COMPAT_BATCH, False,
             ("compat_head", "compat_stage", "packed_scan"))):
        for b in range(SVC_BATCHES):
            idx = [int(i) for i in rng.integers(0, height, n)]
            t = time.perf_counter()
            pairs = new_index_query_shares_batch(md, idx, 1, fast=fast, num_shares=2,
                                                 rand_bytes=keygen_rng.bytes)
            keygen_s = time.perf_counter() - t
            rtt, direct = served(label, idx, pairs, needs)
            log(f"phase 4c: {label} {b} of {n}: keygen {keygen_s:.3f} s (client); round trip "
                f"{rtt:.4f} s, direct API {direct:.4f} s (both shares at once); equal bytes, "
                f"equal launches, all recovered")
    # the natural word tables of the per-query paths, built here so that
    # no single's round trip holds a 1 GiB build (the batches' first
    # round trips above hold theirs)
    sync()
    t = time.perf_counter()
    both([lambda s=s: s._engine._table(1) for s in (s0, s1, s2)])
    sync()
    out["natural_tables_s"] = time.perf_counter() - t
    log(f"phase 4c: the three services' natural word tables built in "
        f"{out['natural_tables_s']:.2f} s (at once)")
    single_idx = [0, height - 1, int(rng.integers(height))]
    for label, fast in (("fast single", True), ("compat single", False)):
        pairs = [new_index_query_shares(md, i, 1, fast=fast, num_shares=2,
                                        rand_bytes=keygen_rng.bytes) for i in single_idx]
        rtt, direct = served(label, single_idx, pairs, ("masked_xor_scan",),
                             ("packed_scan",), single=True)
        log(f"phase 4c: {label}s at rows {single_idx}: round trips {rtt:.4f} s, direct API "
            f"{direct:.4f} s; equal bytes, equal launches, all recovered")

    # wire encode and decode of a fast batch, each half alone
    pairs = new_index_query_shares_batch(md, list(range(SVC_FAST_BATCH)), 1, fast=True,
                                         num_shares=2, rand_bytes=keygen_rng.bytes)
    t = time.perf_counter()
    blob = _pack_blobs([wire.serialize_query_share(p[0]) for p in pairs])
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    parsed = PirService._parse_share_batch(blob)
    t_dec = time.perf_counter() - t
    results = s0._engine.private_secret_shared_query_batch(parsed)
    t = time.perf_counter()
    res_blob = PirService._pack_results(results)
    t_renc = time.perf_counter() - t
    t = time.perf_counter()
    _decode_result_batch(OP_QUERY_BATCH, res_blob)
    t_rdec = time.perf_counter() - t
    out["wire_s"] = {"shares_encode": t_enc, "shares_decode": t_dec, "results_encode": t_renc,
                     "results_decode": t_rdec, "shares_bytes": len(blob),
                     "results_bytes": len(res_blob)}
    log(f"phase 4c: wire, one share of a {SVC_FAST_BATCH}-query fast batch: shares encode "
        f"{t_enc:.4f} s and decode {t_dec:.4f} s ({len(blob)} B), results encode "
        f"{t_renc:.4f} s and decode {t_rdec:.4f} s ({len(res_blob)} B)")
    del pairs, parsed, results

    # the stacked stream: three fast batches and a flush, then the same
    # shares through each engine's own stream
    s_idx = [[int(i) for i in rng.integers(0, height, SVC_FAST_BATCH)] for _ in range(3)]
    s_pairs = [new_index_query_shares_batch(md, b, 1, fast=True, num_shares=2,
                                            rand_bytes=keygen_rng.bytes) for b in s_idx]
    reset_counts()
    t = time.perf_counter()
    steps = [exchange(client, [(OP_STREAM_SUBMIT, _pack_blobs(
        [wire.serialize_query_share(p[k]) for p in pairs])) for k in (0, 1)])
        for pairs in s_pairs]
    steps.append(exchange(client, [(OP_STREAM_FLUSH, b"")] * 2))
    answers = [[_decode_result_batch(*f[k]) for k in (0, 1)] for f in steps]
    rtt = time.perf_counter() - t
    svc_counts = read_counts("service: stream", ("stacked_tail", "packed_scan"))
    if any(answers[0]):
        fail("the stream's first submit answered something")

    def engine_stream(eng, k):
        st = eng.fast_serving_stream()
        futs = [st.submit([p[k] for p in pairs]) for pairs in s_pairs][1:] + [st.flush()]
        return [f() for f in futs]

    reset_counts()
    t = time.perf_counter()
    direct = both([lambda: engine_stream(s0._engine, 0), lambda: engine_stream(s1._engine, 1)])
    direct_s = time.perf_counter() - t
    if launched() != svc_counts:
        fail(f"service stream: launches {svc_counts}, the direct streams' {launched()}")
    for step in range(3):
        for k in (0, 1):
            if [wire.serialize_shared_result(r) for r in answers[step + 1][k]] != \
                    [wire.serialize_shared_result(r) for r in direct[k][step]]:
                fail(f"service stream: batch {step} server {k} differs from the direct stream")
        check_rows(s_idx[step], answers[step + 1], f"stream batch {step}")
    out["rtt_s"]["stream"], out["direct_s"]["stream"] = [rtt], [direct_s]
    out["launches"]["stream"] = svc_counts
    log(f"phase 4c: stream of 3 x {SVC_FAST_BATCH} and a flush: {rtt:.4f} s, the engines' "
        f"own streams {direct_s:.4f} s; equal bytes, equal launches, all recovered")

    # keywords: a batch (kernel 6) and a single (kernel 7)
    kw_rows = [int(i) for i in rng.integers(0, height, SVC_KW_BATCH)]
    kw_pairs = new_keyword_query_shares_batch(md, [int(keywords[r]) for r in kw_rows], 1,
                                              num_shares=2, rand_bytes=keygen_rng.bytes)
    rtt, direct = served("keyword batch", kw_rows, kw_pairs, ("planes_scan",),
                         ("packed_scan", "masked_xor_scan"))
    log(f"phase 4c: keyword batch of {SVC_KW_BATCH}: round trip {rtt:.4f} s, direct API "
        f"{direct:.4f} s; equal bytes, equal launches, all recovered")
    r = kw_rows[0]
    rtt, direct = served("keyword single", [r], [new_keyword_query_shares(
        md, int(keywords[r]), 1, num_shares=2, rand_bytes=keygen_rng.bytes)],
        ("masked_xor_scan",), ("planes_scan", "packed_scan"), single=True)
    log(f"phase 4c: keyword single: round trip {rtt:.4f} s, direct API {direct:.4f} s")
    # a 3-party index single on three services
    r = int(rng.integers(height))
    rtt, direct = served("3-party single", [r], [new_index_query_shares(
        md, r, 1, num_shares=3, rand_bytes=keygen_rng.bytes)], ("masked_xor_scan",),
        ("planes_scan", "packed_scan"), cl=client3, single=True)
    log(f"phase 4c: 3-party index single: round trip {rtt:.4f} s, direct API {direct:.4f} s")
    client3.close()
    s2.close()

    # shared ASPIR: a batch with one wrong key (its item refused), then a
    # single with a wrong key (OP_DENIED); the same shares then go through
    # each engine directly: the expansion, the answer on its bits and the
    # key table's audit on the same bits, as each service answers a share
    def aspir_direct(eng, share):
        bits = eng.expand_shared_query(share.query_share)
        res = eng.private_secret_shared_query_with_expanded_bits(share.query_share, bits)
        return res, generate_audit_for_shared_query_with_expanded_bits(
            key_db, share, bits.cpu().numpy().astype(bool))

    def aspir_served(label, share_lists, opcode, payloads, needs, forbid):
        """Frames to both services, then the shares through both engines;
        the launches must be equal. Returns the answer frames, the direct
        (result, audit) pairs a server, and the two times."""
        reset_counts()
        t = time.perf_counter()
        frames = exchange(client, [(opcode, p) for p in payloads])
        rtt = time.perf_counter() - t
        svc_counts = read_counts(f"service: {label}", needs, forbid)
        reset_counts()
        t = time.perf_counter()
        direct = both([lambda e=e, k=k: [aspir_direct(e, sl[k]) for sl in share_lists]
                       for k, e in enumerate((s0._engine, s1._engine))])
        direct_s = time.perf_counter() - t
        if launched() != svc_counts:
            fail(f"service {label}: launches {svc_counts}, the direct API's {launched()}")
        out["rtt_s"][label], out["direct_s"][label] = [rtt], [direct_s]
        out["launches"][label] = svc_counts
        return frames, direct, rtt, direct_s

    a_idx = [int(i) for i in rng.integers(0, height, SVC_ASPIR_BATCH)]
    a_keys = [key_db.slot(i) for i in a_idx]
    wrong = SVC_ASPIR_BATCH // 2
    a_keys[wrong] = key_db.slot((a_idx[wrong] + 1) % height)
    a_shares = [new_authenticated_index_query_shares(md, i, key, 1, 2, fast=True)
                for i, key in zip(a_idx, a_keys)]
    head = struct.pack("<QB", int(rng.integers(1 << 63)), 2)
    frames, direct, rtt, direct_s = aspir_served(
        "shared ASPIR batch", a_shares, OP_ASPIR_SHARED_QUERY_BATCH,
        [head + _pack_blobs([wire.serialize_auth_share(sl[k]) for sl in a_shares])
         for k in (0, 1)], ("masked_xor_scan",), ("packed_scan",))
    if any(op != OP_ASPIR_SHARED_QUERY_BATCH for op, _ in frames):
        fail(f"service shared ASPIR batch: opcodes {[op for op, _ in frames]}: "
             f"{frames[0][1][:200]!r}")
    items = [_unpack_blobs(p) for _, p in frames]
    verdicts = [check_audit(direct[0][q][1], direct[1][q][1]) for q in range(SVC_ASPIR_BATCH)]
    if [q for q, v in enumerate(verdicts) if not v] != [wrong]:
        fail(f"shared ASPIR batch: the direct audits fail at {verdicts.count(False)} items, "
             f"not at item {wrong} alone")
    for k in (0, 1):
        if [it[:1] == b"\x01" for it in items[k]] != verdicts:
            fail(f"service shared ASPIR batch: server {k}'s verdicts differ from the direct "
                 f"audits'")
        if any(it[1:] != wire.serialize_shared_result(direct[k][q][0])
               for q, it in enumerate(items[k]) if verdicts[q]):
            fail(f"service shared ASPIR batch: server {k}'s released answers differ from the "
                 f"direct API's")
    released = [q for q in range(SVC_ASPIR_BATCH) if q != wrong]
    check_rows([a_idx[q] for q in released],
               [[wire.deserialize_shared_result(items[k][q][1:]) for q in released]
                for k in (0, 1)], "shared ASPIR batch")
    log(f"phase 4c: shared ASPIR batch of {SVC_ASPIR_BATCH} (item {wrong} with a wrong key): "
        f"round trip {rtt:.4f} s, direct API {direct_s:.4f} s; {SVC_ASPIR_BATCH - 1} released, "
        f"equal bytes to the direct API's and recovered, item {wrong} refused as the direct "
        f"audits say; equal launches")
    w_shares = [new_authenticated_index_query_shares(
        md, a_idx[0], key_db.slot((a_idx[0] + 1) % height), 1, 2, fast=True)]
    head = struct.pack("<QB", int(rng.integers(1 << 63)), 2)
    frames, direct, rtt, direct_s = aspir_served(
        "shared ASPIR single, wrong key", w_shares, OP_ASPIR_SHARED_QUERY,
        [head + wire.serialize_auth_share(w_shares[0][k]) for k in (0, 1)],
        ("masked_xor_scan",), ("packed_scan",))
    if any(op != OP_DENIED for op, _ in frames):
        fail(f"service shared ASPIR single: a wrong key was not refused: "
             f"{[(op, p[:200]) for op, p in frames]}")
    if check_audit(direct[0][0][1], direct[1][0][1]):
        fail("shared ASPIR single: the direct audit passes a wrong key")
    log(f"phase 4c: shared ASPIR single with a wrong key: OP_DENIED "
        f"({frames[0][1].decode()!r}) in {rtt:.4f} s, direct API {direct_s:.4f} s (its audit "
        f"fails too); equal launches")

    # live updates through both services, then a fast batch on new rows
    upd_rows = rng.choice(height, size=SVC_UPDATES, replace=False)
    updates = {int(r): rng.bytes(slot) for r in upd_rows}
    sync()
    t = time.perf_counter()
    s0.apply_updates(updates)
    s1.apply_updates(updates)
    sync()
    out["updates_s"] = time.perf_counter() - t
    for k, d in enumerate(dbs[:2]):
        if any(d.data[r].tobytes() != b for r, b in list(updates.items())[:64]):
            fail(f"service {k}'s database did not take the updates")
    idx = [int(i) for i in rng.choice(upd_rows, SVC_FAST_BATCH // 2)] + \
        [int(i) for i in rng.integers(0, height, SVC_FAST_BATCH // 2)]
    pairs = new_index_query_shares_batch(md, idx, 1, fast=True, num_shares=2,
                                         rand_bytes=keygen_rng.bytes)
    rtt, direct = served("fast batch after updates", idx, pairs,
                         ("stacked_tail", "packed_scan"))
    log(f"phase 4c: {SVC_UPDATES} row updates through PirService.apply_updates on both "
        f"services in {out['updates_s']:.4f} s (synchronised); a fast batch of "
        f"{SVC_FAST_BATCH}, half on updated rows: round trip {rtt:.4f} s, all recover the new "
        f"rows")
    metrics = [client.get_metrics(k) for k in (0, 1)]
    if any(m["engine"] != "torch" or m["queries"] <= 0 for m in metrics):
        fail(f"OP_METRICS: {metrics}")
    out["metrics"] = metrics
    log(f"phase 4c: OP_METRICS: {json.dumps(metrics)}")
    client.close()
    s0.close()
    s1.close()

    # the cPIR yardstick table: cPIR and AHE ASPIR with a 1024-bit key
    cdata = np.frombuffer(rng.bytes(CPIR_ROWS * CPIR_SLOT_BYTES), np.uint8).reshape(
        CPIR_ROWS, CPIR_SLOT_BYTES)
    cdb = database_from_numpy(cdata, CPIR_SLOT_BYTES)
    ckeys = database_from_numpy(np.frombuffer(rng.bytes(CPIR_ROWS * CPIR_KEY_BYTES), np.uint8)
                                .reshape(CPIR_ROWS, CPIR_KEY_BYTES), CPIR_KEY_BYTES)
    c0 = PirService(cdb, config=config, key_db=ckeys).start()
    c1 = PirService(cdb, config=config, key_db=ckeys, audit_leader=c0.address).start()
    cclient = PirClient([c0.address, c1.address])
    bits = PAILLIER_BITS
    t = time.perf_counter()
    sk, pk = keygen(bits)
    cpir = {"keygen_s": time.perf_counter() - t, "key_bits": pk.n.bit_length()}
    if pk.n.bit_length() < bits - 1:
        fail(f"a {bits}-bit Paillier key has {pk.n.bit_length()} bits")
    cmd = cdb.metadata()
    width, _ = cmd.get_dimensions_for_database(int(np.ceil(np.sqrt(CPIR_ROWS))), 1)
    row = int(rng.integers(CPIR_ROWS // width))
    t = time.perf_counter()
    got = cclient.query_encrypted(row, sk, pk)
    cpir["encrypted_s"] = time.perf_counter() - t
    if [bytes(x.data) for x in got] != [cdata[row * width + j].tobytes() for j in range(width)]:
        fail("cPIR: the encrypted query does not recover its grid row")
    target = int(rng.integers(CPIR_ROWS))
    t = time.perf_counter()
    got = cclient.query_encrypted_recursive(target, sk, pk, server=1)
    cpir["recursive_s"] = time.perf_counter() - t
    if bytes(got[0].data) != cdata[target].tobytes():
        fail("cPIR: the recursive query does not recover its row")
    t = time.perf_counter()
    got = cclient.query_authenticated(target, sk, ckeys.slot(target))
    cpir["aspir_right_key_s"] = time.perf_counter() - t
    if bytes(got[0].data) != cdata[target].tobytes():
        fail("AHE ASPIR: the right key does not recover its row")
    t = time.perf_counter()
    try:
        cclient.query_authenticated(target, sk, ckeys.slot((target + 1) % CPIR_ROWS))
        fail("AHE ASPIR: a wrong key was not refused")
    except PermissionError as e:
        if "decoy" not in str(e):
            fail(f"AHE ASPIR: a wrong key was refused for another reason: {e}")
    cpir["aspir_wrong_key_s"] = time.perf_counter() - t
    cpir["server_scan_s"] = list(c0.metrics.latencies_s) + list(c1.metrics.latencies_s)
    out["cpir"] = cpir
    out["cpir_tables"] = (cdb, ckeys)  # phase 4d serves them again (not in --out)
    log(f"phase 4c: cPIR on {CPIR_ROWS} x {CPIR_SLOT_BYTES} B with a {pk.n.bit_length()}-bit "
        f"key (keygen {cpir['keygen_s']:.2f} s): encrypted query {cpir['encrypted_s']:.3f} s, "
        f"recursive {cpir['recursive_s']:.3f} s, AHE ASPIR right key "
        f"{cpir['aspir_right_key_s']:.3f} s (recovered), wrong key "
        f"{cpir['aspir_wrong_key_s']:.3f} s (only the null side proved, refused); server scans "
        f"(s) {[round(x, 4) for x in cpir['server_scan_s']]}")
    cclient.close()
    c0.close()
    c1.close()
    if torch.cuda.is_available():
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def mesh_phase(db, seed, counting, rows_of, single, sync, depth, n_blk) -> dict:
    """Phase 4e: the mesh engine (parallel/mesh.py) on the card, every
    shard on the one card: MeshPirServer over ["cuda:0"] * 8, a grid of
    MESH_TP row shards by MESH_DP batch slices, on the 1 GiB table (its
    keywords set). Both (or all three) shares of: fast batches of 4096
    shared-key queries on the stacked and on the per-query tail root step,
    a compat batch of 1024 (compat root step), 64 distinct-key fast
    queries (host-prefix step), 64 compat queries on a tp-3 grid
    (host-prefix step), a keyword batch of 8 and a 3-party index batch of
    4 (point steps); then 4096 row updates through apply_updates (and the
    single-card server's) and a fast batch; then two PirServices with
    PirConfig(engine="mesh") (1 x 1) serve a client's fast and compat
    batches. Each answer equals the single-card server's bytes (`single`,
    TorchPirServer) and recovers its row (depth, n_blk: the fast keys'
    tree); the launch counts of each route
    are set to 0 just before it and read just after; seconds per batch
    beside the single card's on the same shares. Returns the summary."""
    import numpy as np
    import torch

    from pir_tpu_torch.config import PirConfig
    from pir_tpu_torch.database import DBMetadata
    from pir_tpu_torch.parallel.mesh import MeshPirServer, make_mesh
    from pir_tpu_torch.query import (
        new_fast_index_query_shares,
        new_index_query_shares,
        new_index_query_shares_batch,
        new_keyword_query_shares_batch,
    )
    from pir_tpu_torch.service import PirClient, PirService
    from pir_tpu_torch.state import database_from_numpy

    counted, reset_counts, read_counts = counting
    rng = np.random.default_rng(seed + 9)
    keygen_rng = np.random.default_rng(seed + 10)
    height, slot = db.db_size, db.slot_bytes
    md = DBMetadata(slot, height)
    every = set(counted)
    out = {"grid": {"tp": MESH_TP, "dp": MESH_DP}, "tables_s": {}, "s": {}, "single_s": {},
           "launches": {}}
    t = time.perf_counter()
    grid = make_mesh(devices=["cuda:0"] * (MESH_TP * MESH_DP), dp=MESH_DP)
    engines = {"stacked": MeshPirServer(db, mesh=grid),
               "per-query tail": MeshPirServer(db, mesh=grid, fast_stacked=False),
               "tp 3": MeshPirServer(db, mesh=make_mesh(devices=["cuda:0"] * MESH_TP_ODD))}
    nbd = single._compat_device_bits(1)
    # the tables of the root steps, built here (1 GiB each, a quarter a
    # shard), so that no batch below holds a build
    for label, build in (
            ("stacked root", lambda: engines["stacked"]._root_table(1, depth, n_blk)),
            ("classic root", lambda: engines["per-query tail"]._root_table(1, depth, n_blk)),
            ("compat root", lambda: engines["stacked"]._compat_root_table(1, nbd))):
        t0 = time.perf_counter()
        build()
        sync()
        out["tables_s"][label] = time.perf_counter() - t0
    log(f"phase 4e: grid {MESH_DP} x {MESH_TP} over cuda:0, tables (s) {out['tables_s']}; "
        f"each shard {depth - 2} fast levels and {nbd - 2} compat device levels "
        f"(stacked tail {engines['stacked']._stacked_tail_for(depth, n_blk)}, compat stages "
        f"{engines['stacked']._compat_root_table(1, nbd)[1]})")

    def one_card(shares):
        if shares[0].is_two_party:
            return single.private_secret_shared_query_batch(shares)
        return [single.private_secret_shared_query(s) for s in shares]

    def route(label, eng, idx, pairs, needs):
        """Every share of `pairs` through eng, counted and timed; then the
        single card on the same shares, timed; equal bytes, recovered."""
        n_sh = len(pairs[0])
        reset_counts()
        answers, secs = [], []
        for part in range(n_sh):
            sync()
            t0 = time.perf_counter()
            answers.append(rows_of(eng.private_secret_shared_query_batch(
                [p[part] for p in pairs])))
            secs.append(time.perf_counter() - t0)
        out["launches"][label] = read_counts(f"mesh {label}", needs,
                                             tuple(every - set(needs)))
        one_s = []
        for part in range(n_sh):
            sync()
            t0 = time.perf_counter()
            want = rows_of(one_card([p[part] for p in pairs]))
            one_s.append(time.perf_counter() - t0)
            if not np.array_equal(answers[part], want):
                fail(f"mesh {label}: share {part} differs from the single card's bytes")
        rec = np.bitwise_xor.reduce(np.stack(answers), axis=0)
        bad = np.flatnonzero((rec != db.data[np.asarray(idx)]).any(axis=1))
        if bad.size:
            fail(f"mesh {label}: {bad.size} of {len(idx)} answers do not recover")
        out["s"][label], out["single_s"][label] = secs, one_s
        log(f"phase 4e: {label} ({len(idx)} queries): mesh {[round(x, 4) for x in secs]} s "
            f"a share, single card {[round(x, 4) for x in one_s]} s; equal bytes, all "
            f"recovered")
        return answers

    def rows(n):
        idx = [int(i) for i in rng.integers(0, height, n)]
        idx[0], idx[-1] = 0, height - 1
        return idx

    idx = rows(MESH_FAST_BATCH)
    pairs = new_index_query_shares_batch(md, idx, 1, fast=True, rand_bytes=keygen_rng.bytes)
    stacked = route("fast root, stacked", engines["stacked"], idx, pairs,
                    ("stacked_tail", "packed_scan"))
    out["split_s"] = stacked_split(engines["stacked"], [p[0] for p in pairs], stacked[0],
                                   depth, n_blk, sync)
    log("phase 4e: split of one stacked root share batch, summed over the 8 shards (s): " +
        ", ".join(f"{name} {sec:.4f}" for name, sec in out["split_s"].items()) +
        f"; sum {sum(out['split_s'].values()):.4f}; equal to the batch API's bytes")
    route("fast root, per-query tail", engines["per-query tail"], idx, pairs,
          ("fast_tail", "packed_scan"))
    idx = rows(MESH_COMPAT_BATCH)
    route("compat root", engines["stacked"], idx,
          new_index_query_shares_batch(md, idx, 1, rand_bytes=keygen_rng.bytes),
          ("compat_head", "compat_stage", "packed_scan"))
    idx = rows(MESH_PREFIX_BATCH)
    route("fast distinct-key (host prefix)", engines["stacked"], idx,
          [new_fast_index_query_shares(md, i, 1, rand_bytes=keygen_rng.bytes) for i in idx],
          ("masked_xor_scan",))
    idx = rows(MESH_PREFIX_BATCH)
    route(f"compat on tp {MESH_TP_ODD} (host prefix)", engines["tp 3"], idx,
          new_index_query_shares_batch(md, idx, 1, rand_bytes=keygen_rng.bytes),
          ("masked_xor_scan",))
    idx = rows(MESH_KW_BATCH)
    route("keyword", engines["stacked"], idx, new_keyword_query_shares_batch(
        md, [int(db.keywords[i]) for i in idx], 1, rand_bytes=keygen_rng.bytes),
          ("planes_scan",))
    idx = rows(MESH_MP_BATCH)
    route(f"{MP_PARTIES}-party index", engines["stacked"], idx,
          [new_index_query_shares(md, i, 1, num_shares=MP_PARTIES, rand_bytes=keygen_rng.bytes)
           for i in idx], ("planes_scan",))

    # live updates: every engine's shard tables and the single card's
    upd_rows = rng.choice(height, size=MESH_UPDATES, replace=False)
    upd_rows[:2] = 0, height - 1
    updates = {int(r): rng.bytes(slot) for r in upd_rows}
    sync()
    t0 = time.perf_counter()
    for eng in engines.values():
        eng.apply_updates(updates)
    sync()
    out["updates_s"] = time.perf_counter() - t0
    single.apply_updates(updates)
    idx = rows(MESH_FAST_BATCH)
    idx[1: MESH_FAST_BATCH // 2] = [int(r) for r in rng.choice(upd_rows, MESH_FAST_BATCH // 2 - 1)]
    route("fast root after updates", engines["stacked"], idx,
          new_index_query_shares_batch(md, idx, 1, fast=True, rand_bytes=keygen_rng.bytes),
          ("stacked_tail", "packed_scan"))
    log(f"phase 4e: {MESH_UPDATES} row updates on the three engines in "
        f"{out['updates_s']:.4f} s; a fast batch after them (half on updated rows) recovers "
        f"the new rows")
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    # the service shell on the mesh engine: PirConfig(engine="mesh"), 1 x 1
    cfg = PirConfig(engine="mesh")
    t0 = time.perf_counter()
    svcs = [PirService(database_from_numpy(db.data, slot, keywords=db.keywords),
                       config=cfg).start() for _ in range(2)]
    client = PirClient([s.address for s in svcs])
    try:
        for s in svcs:
            if s.engine_name != "mesh" or s._engine.mesh.shape != {"dp": 1, "tp": 1}:
                fail(f"PirConfig(engine='mesh') gave engine {s.engine_name}")
        svc_s = {}
        for label, n, fast, needs in (
                ("fast batch", MESH_FAST_BATCH, True, ("stacked_tail", "packed_scan")),
                ("compat batch", MESH_COMPAT_BATCH, False,
                 ("compat_head", "compat_stage", "packed_scan"))):
            idx = rows(n)
            reset_counts()
            t1 = time.perf_counter()
            got = client.query_index_batch(idx, fast=fast)
            svc_s[label] = time.perf_counter() - t1
            out["launches"][f"service {label}"] = read_counts(
                f"mesh service {label}", needs, tuple(every - set(needs)))
            rec = np.stack([np.frombuffer(bytes(r[0].data), np.uint8) for r in got])
            if not np.array_equal(rec, db.data[np.asarray(idx)]):
                fail(f"mesh service {label}: answers do not recover their rows")
        out["service_s"] = dict(svc_s, total=time.perf_counter() - t0)
        log(f"phase 4e: two PirServices with PirConfig(engine='mesh') (grid 1 x 1 on "
            f"{svcs[0]._engine.mesh.devices[0, 0]}): round trips (s, first use and table "
            f"builds included) {svc_s}; all recovered")
    finally:
        client.close()
        for s in svcs:
            s.close()
    return out


def rest_phase(db, seed, counting, rows_of, srv, depth, n_blk, cpir, cdb) -> dict:
    """Phase 4f: the last modules of the port, on the 1 GiB table (its
    keywords set). (a) The per-query tail route with all_xla_expand (the
    whole fast walk in plain torch with Q in lanes) on both shares of one
    batch of REST_XLA_BATCH batch-shared fast queries at the serving
    geometry, on a fresh classic table: equal bytes to the tail-kernel
    route on the same shares, every row recovered, the packed scan once a
    share and no tail kernel, seconds a share beside the tail-kernel
    route's and max_memory_allocated before and at peak; a distinct-key
    batch raises ValueError. (b) REST_ANSWER_Q fast queries with per-query
    payloads at the default min_device_nodes through each of the six
    fused_fast_answer* functions, on the table it takes (the natural word
    table, its bytes, or the storage-order word table scattered once and
    its bytes): every answer equal to the host golden model, rows
    recovered, the masked-XOR scan or the bit-plane scan launched as the
    function says, seconds a call. (c) The native C++ engine: the host's
    CPU and flags, the libraries' build time; NativePirServer on the same
    database answers the shares TorchPirServer (srv) answers on the card
    (a fast and a compat batch of REST_NATIVE_BATCH, a fast and a compat
    single, a keyword single, a 3-party index single) with equal bytes,
    every row recovered, no kernel launched, seconds beside the card's; a
    PirService pair with PirConfig(engine="native",
    paillier_engine="native") on the cPIR yardstick table (cdb) answers
    the frames of a fast batch, a compat single and an encrypted query
    with the bytes of a pair on the default config; the encrypted query's
    ints through encrypted's engines "native", "torch" and "python" are
    equal; native.powmod_batch on phase 4d's encryption batch equals
    kernel 9's ints (cpir: its stash). Returns what it measured."""
    import platform
    import socket

    import numpy as np
    import torch

    from pir_tpu_torch import _build, native
    from pir_tpu_torch import encrypted as enc
    from pir_tpu_torch import server as server_mod
    from pir_tpu_torch import wire
    from pir_tpu_torch.config import PirConfig
    from pir_tpu_torch.database import DBMetadata
    from pir_tpu_torch.dpf import host as dpf_host
    from pir_tpu_torch.dpf.device import (
        make_device_fast_key,
        make_fast_payload_batch,
        pack_fast_payload,
        u32_tensor,
    )
    from pir_tpu_torch.models import pipeline
    from pir_tpu_torch.query import (
        new_fast_index_query_shares,
        new_index_query_shares,
        new_index_query_shares_batch,
        new_keyword_query_shares,
    )
    from pir_tpu_torch.server import NativePirServer, TorchPirServer
    from pir_tpu_torch.service import (
        OP_ENCRYPTED_QUERY,
        OP_QUERY,
        OP_QUERY_BATCH,
        PirClient,
        PirService,
        _pack_blobs,
        _recv_frame,
        _send_frame,
    )
    from pir_tpu_torch.state import database_from_numpy

    counted, reset_counts, read_counts = counting
    every = set(counted)
    rng = np.random.default_rng(seed + 11)
    keygen_rng = np.random.default_rng(seed + 12)
    height, slot = db.db_size, db.slot_bytes
    md = DBMetadata(slot, height)
    sync = torch.cuda.synchronize
    out = {"s": {}, "launches": {}}

    def rows(n):
        return [int(i) for i in rng.integers(0, height, n)]

    def check_rows(label, idx, answers):
        rec = np.bitwise_xor.reduce(np.stack(answers), axis=0)
        if not np.array_equal(rec[:, :slot], db.data[np.asarray(idx)]):
            fail(f"phase 4f: {label}: answers do not recover their rows")

    # (a) the [19] route: all_xla_expand against the tail-kernel route
    t = time.perf_counter()
    srv_x = TorchPirServer(db, fast_stacked=False)
    table = srv_x._root_table_u8(1, depth, n_blk, stacked=False)
    sync()
    out["s"]["classic_table"] = time.perf_counter() - t
    idx = rows(REST_XLA_BATCH)
    pairs = new_index_query_shares_batch(md, idx, 1, fast=True, rand_bytes=keygen_rng.bytes)
    xla = {"xla_s": [], "tail_s": [], "memory": []}
    answers = []
    for part in (0, 1):
        pay, layout = make_fast_payload_batch([p[part] for p in pairs])
        if not layout.shared_rk or (layout.depth, layout.leaf_blocks) != (depth, n_blk):
            fail(f"phase 4f: the batch's layout is {layout}")
        pay = u32_tensor(pay, "cuda")
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        t = time.perf_counter()
        got = pipeline.fused_fast_root_batch_pertail(table, pay, layout, srv_x.tail_levels,
                                                     all_xla_expand=True)
        sync()
        xla["xla_s"].append(time.perf_counter() - t)
        xla["memory"].append((before, torch.cuda.max_memory_allocated()))
        out["launches"][f"all_xla_expand {part}"] = read_counts(
            f"all_xla_expand route, share {part}", ("packed_scan",),
            tuple(every - {"packed_scan"}))
        if out["launches"][f"all_xla_expand {part}"]["packed_scan"] != 1:
            fail("phase 4f: the all_xla_expand route launched the packed scan more than once")
        t = time.perf_counter()
        want = pipeline.fused_fast_root_batch_pertail(table, pay, layout, srv_x.tail_levels)
        sync()
        xla["tail_s"].append(time.perf_counter() - t)
        if not torch.equal(got, want):
            fail("phase 4f: the all_xla_expand route differs from the tail-kernel route")
        answers.append(got.cpu().numpy())
        del got, want
    check_rows("all_xla_expand route", idx, answers)
    dshares = [new_fast_index_query_shares(md, i, 1, rand_bytes=keygen_rng.bytes)[0]
               for i in rows(4)]
    dpay, dlayout = make_fast_payload_batch(dshares)
    try:
        pipeline.fused_fast_root_batch_pertail(table, u32_tensor(dpay, "cuda"), dlayout,
                                               srv_x.tail_levels, all_xla_expand=True)
        fail("phase 4f: the all_xla_expand route took a distinct-key batch")
    except ValueError:
        pass
    out["all_xla_expand"] = xla
    log(f"phase 4f: (a) all_xla_expand route, {REST_XLA_BATCH} shared-key queries (depth "
        f"{depth}, {n_blk} leaf blocks): {[round(x, 4) for x in xla['xla_s']]} s a share "
        f"against the tail-kernel route's {[round(x, 4) for x in xla['tail_s']]}; equal bytes, "
        f"all recovered; memory_allocated before / max (GiB) "
        f"{[(round(a / 2**30, 3), round(b / 2**30, 3)) for a, b in xla['memory']]}; the packed "
        f"scan once a share, no tail kernel; a distinct-key batch raises ValueError; the "
        f"classic table {out['s']['classic_table']:.2f} s")
    del srv_x, table, pay, answers
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the [20] functions: per-query payloads, each on the table it takes
    idx = rows(REST_ANSWER_Q)
    pairs = new_index_query_shares_batch(md, idx, 1, fast=True, rand_bytes=keygen_rng.bytes)
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(2 * REST_ANSWER_Q, os.cpu_count() or 1)) as pool:
        golden = list(pool.map(
            lambda s: np.frombuffer(bytes(server_mod.private_secret_shared_query(db, s)
                                          .shares[0].data), np.uint8),
            [p[part] for part in (0, 1) for p in pairs]))
    out["s"]["host_golden"] = time.perf_counter() - t
    golden = [np.stack(golden[:REST_ANSWER_Q]), np.stack(golden[REST_ANSWER_Q:])]
    check_rows("host golden", idx, golden)
    keyed = []
    for part in (0, 1):
        dkeys = [make_device_fast_key(dpf_host.server_initialize(p[part].prf_keys, depth),
                                      p[part].key_fast) for p in pairs]
        packed = [pack_fast_payload(k) for k in dkeys]
        keyed.append((u32_tensor(np.stack([x for x, _ in packed]), "cuda"), packed[0][1],
                      dkeys[0]))
    dkey = keyed[0][2]
    t = time.perf_counter()
    words = srv._table(1)
    swords = srv._fast_storage_words(1, dkey)
    sync()
    out["s"]["storage_words_table"] = time.perf_counter() - t
    tables = {"words": words, "u8": words.view(torch.uint8), "swords": swords,
              "su8": swords.view(torch.uint8)}
    perm = srv._fast_perm(dkey)
    funcs = (  # name, table, natural order, batch, its kernel
        ("fused_fast_answer", "words", True, False, "masked_xor_scan"),
        ("fused_fast_answer_batch", "words", True, True, "masked_xor_scan"),
        ("fused_fast_answer_batch_mxu", "u8", True, True, "planes_scan"),
        ("fused_fast_answer_batch_preplane", "u8", True, True, "planes_scan"),
        ("fused_fast_answer_batch_storage", "su8", False, True, "planes_scan"),
        ("fused_fast_answer_storage", "swords", False, False, "masked_xor_scan"))
    per_call = {}
    for name, tab, natural, batch, kernel in funcs:
        fn = getattr(pipeline, name)
        tbl = tables[tab]
        got = []
        reset_counts()
        t = time.perf_counter()
        for pays, layout, _ in keyed:
            if batch:
                res = fn(tbl, pays, perm, layout) if natural else fn(tbl, pays, layout)
            else:
                res = torch.stack([fn(tbl, p, perm, layout) if natural else fn(tbl, p, layout)
                                   for p in pays])
            got.append(res)
        sync()
        calls = 2 if batch else 2 * REST_ANSWER_Q
        per_call[name] = (time.perf_counter() - t) / calls
        launched = read_counts(name, (kernel,), tuple(every - {kernel}))
        out["launches"][name] = launched
        if launched[kernel] != calls:
            fail(f"phase 4f: {name} launched {kernel} {launched[kernel]} times, not {calls}")
        for part in (0, 1):
            ans = got[part].cpu().numpy().view(np.uint8).reshape(REST_ANSWER_Q, -1)[:, :slot]
            if not np.array_equal(ans, golden[part]):
                fail(f"phase 4f: {name} share {part} differs from the host golden")
    out["answers_s_per_call"] = per_call
    log(f"phase 4f: (b) {REST_ANSWER_Q} fast queries, per-query payloads ({dkey.plan.host_levels}"
        f" host levels, {dkey.plan.device_levels} device levels): the six fused_fast_answer* "
        f"equal the host golden (built in {out['s']['host_golden']:.2f} s), all recovered; "
        f"the storage word table {out['s']['storage_words_table']:.2f} s; s a call "
        f"{json.dumps({k: round(v, 5) for k, v in per_call.items()})}")
    with srv._lock:  # the storage word table served only this check
        srv._tables.pop(("storage words", 1, dkey.plan.device_levels, dkey.plan.m_padded,
                         n_blk), None)
    del tables, swords, keyed
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the native C++ engine
    cpuinfo = open("/proc/cpuinfo").read()
    fields = dict(ln.split(":", 1) for ln in cpuinfo.splitlines() if ":" in ln)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    flags = set(fields.get("flags", "").split())
    host = {"machine": platform.machine(), "model": fields.get("model name", "?"),
            "vendor": fields.get("vendor_id", "?"), "family": fields.get("cpu family", "?"),
            "model_number": fields.get("model", "?"), "cores": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "aes": "aes" in flags,
            "avx2": "avx2" in flags}
    out["host"] = host
    if not (host["aes"] and host["avx2"]):
        fail(f"phase 4f: the host CPU lacks AES-NI or AVX2: {host}")
    t = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build_host, _build.HOST_SOURCES))
    out["s"]["native_build"] = time.perf_counter() - t
    log(f"phase 4f: (c) host {json.dumps(host)}; native libraries built in "
        f"{out['s']['native_build']:.2f} s")
    nat = NativePirServer(db)
    fidx, cidx = rows(REST_NATIVE_BATCH), rows(REST_NATIVE_BATCH)
    one = rows(2)
    kw_row = int(rng.integers(height))
    cases = (
        ("fast batch", fidx, new_index_query_shares_batch(md, fidx, 1, fast=True,
                                                          rand_bytes=keygen_rng.bytes), True),
        ("compat batch", cidx, new_index_query_shares_batch(md, cidx, 1,
                                                            rand_bytes=keygen_rng.bytes), True),
        ("fast single", one[:1], [new_index_query_shares(md, one[0], 1, fast=True,
                                                         rand_bytes=keygen_rng.bytes)], False),
        ("compat single", one[1:], [new_index_query_shares(md, one[1], 1,
                                                           rand_bytes=keygen_rng.bytes)], False),
        ("keyword single", [kw_row], [new_keyword_query_shares(
            md, int(db.keywords[kw_row]), 1, rand_bytes=keygen_rng.bytes)], False),
        (f"{MP_PARTIES}-party index single", one[:1], [new_index_query_shares(
            md, one[0], 1, num_shares=MP_PARTIES, rand_bytes=keygen_rng.bytes)], False))
    native_s = {}
    for label, idx, pairs, batch in cases:
        n_parts = len(pairs[0])
        secs = {"native": [], "card": []}
        answers = []
        for part in range(n_parts):
            shares = [p[part] for p in pairs]
            res = {}
            for eng, engine in (("native", nat), ("card", srv)):
                if eng == "native":
                    reset_counts()
                t = time.perf_counter()
                if batch:
                    r = engine.private_secret_shared_query_batch(shares)
                else:
                    r = [engine.private_secret_shared_query(shares[0])]
                res[eng] = rows_of(r)
                secs[eng].append(time.perf_counter() - t)
                if eng == "native":
                    read_counts(f"native {label}", (), tuple(every))
            if not np.array_equal(res["native"], res["card"]):
                fail(f"phase 4f: NativePirServer's {label} share {part} differs from the card's")
            answers.append(res["native"])
        check_rows(f"native {label}", idx, answers)
        native_s[label] = secs
    out["native_s"] = native_s
    log(f"phase 4f: (c) NativePirServer on the {height} x {slot} B table equals the card's "
        f"bytes, all recovered, no kernel launched; seconds a share, native / card: " +
        "; ".join(f"{k} {[round(x, 4) for x in v['native']]} / "
                  f"{[round(x, 4) for x in v['card']]}" for k, v in native_s.items()))

    # the services on the cPIR yardstick table: native engines against the default
    cmd = cdb.metadata()
    sk, pk = cpir["key"]
    cfgs = {"native": PirConfig(engine="native", paillier_engine="native"),
            "default": PirConfig()}
    svcs = {k: [PirService(database_from_numpy(cdb.data, cdb.slot_bytes), config=c).start()
                for _ in range(2)] for k, c in cfgs.items()}
    try:
        if any(s.engine_name != "native" for s in svcs["native"]):
            fail("phase 4f: PirConfig(engine='native') did not give the native engine")
        cpairs = new_index_query_shares_batch(
            cmd, [int(i) for i in rng.integers(0, cdb.db_size, REST_NATIVE_BATCH)], 1,
            fast=True, rand_bytes=keygen_rng.bytes)
        csingle = new_index_query_shares(cmd, 5, 1, rand_bytes=keygen_rng.bytes)
        q = enc.new_encrypted_query(cmd, pk, 1, 7)
        svc_s, got = {}, {}
        for k, pair in svcs.items():
            got[k] = []
            t = time.perf_counter()
            for part, s in enumerate(pair):
                frames = [(OP_QUERY_BATCH, _pack_blobs([wire.serialize_query_share(p[part])
                                                        for p in cpairs])),
                          (OP_QUERY, wire.serialize_query_share(csingle[part]))]
                if part == 0:
                    frames.append((OP_ENCRYPTED_QUERY, wire.serialize_encrypted_query(q)))
                with socket.create_connection(s.address) as sock:
                    for op, payload in frames:
                        _send_frame(sock, op, payload)
                        got[k].append(_recv_frame(sock))
            svc_s[k] = time.perf_counter() - t
        if got["native"] != got["default"]:
            fail("phase 4f: the native services' answers differ from the default services'")
        client = PirClient([s.address for s in svcs["native"]])
        try:
            res = client.query_index_batch([0, cdb.db_size - 1, 300])
        finally:
            client.close()
        if [bytes(r[0].data) for r in res] != [cdb.data[i].tobytes()
                                               for i in (0, cdb.db_size - 1, 300)]:
            fail("phase 4f: a client of the native services does not recover its rows")
    finally:
        for pair in svcs.values():
            for s in pair:
                s.close()
    ints, scan_s = {}, {}
    for engine in ("native", "torch", "python"):
        t = time.perf_counter()
        r = enc.private_encrypted_query(cdb, q, engine=engine)
        scan_s[engine] = time.perf_counter() - t
        ints[engine] = [[c.c for c in sl.cts] for sl in r.slots]
    if not ints["native"] == ints["torch"] == ints["python"]:
        fail("phase 4f: the encrypted query's ints differ between engines")
    rs, k9 = cpir["encrypt_rs"], cpir["encrypt_kernel9"]
    t = time.perf_counter()
    nat_ints = native.powmod_batch(rs, [pk.n] * len(rs), pk.n2)
    out["s"]["native_powmod_batch"] = time.perf_counter() - t
    if nat_ints != k9:
        fail("phase 4f: native.powmod_batch differs from kernel 9 on phase 4d's encryptions")
    out["services_s"], out["encrypted_scan_s"] = svc_s, scan_s
    log(f"phase 4f: (c) services on the {cdb.db_size} x {cdb.slot_bytes} B yardstick: "
        f"PirConfig(engine='native', paillier_engine='native') equals the default config's "
        f"bytes (a fast batch of {REST_NATIVE_BATCH}, a compat single, an encrypted query), "
        f"s {json.dumps({k: round(v, 4) for k, v in svc_s.items()})}; the encrypted query's "
        f"scan, engines native / torch / python: {json.dumps({k: round(v, 4) for k, v in scan_s.items()})}"
        f" s, equal ints; native.powmod_batch of phase 4d's {len(rs)} r^N mod N^2 "
        f"{out['s']['native_powmod_batch']:.4f} s (kernel 9's route in phase 4d "
        f"{cpir['s']['encrypt_modexps']:.4f} s), equal ints")
    return out


def stacked_split(eng, shares, want, depth, n_blk, sync) -> dict:
    """One share batch through eng's stacked root step, stage by stage,
    each stage synchronised and summed over the grid's shards; fails
    unless the folded answers equal `want` (the batch API's)."""
    import numpy as np
    import torch

    from pir_tpu_torch.dpf.device import make_fast_payload_batch, u32_tensor
    from pir_tpu_torch.models.pipeline import stacked_fast_geometry, stacked_head, stacked_words_t
    from pir_tpu_torch.ops.expand import fast_tail_expand_stacked
    from pir_tpu_torch.ops.packed_scan import packed_scan

    split = {}
    t = [time.perf_counter()]

    def mark(stage):
        sync()
        now = time.perf_counter()
        split[stage] = split.get(stage, 0.0) + now - t[0]
        t[0] = now

    levels = eng._shard_levels()
    k, tail = stacked_fast_geometry(depth - levels, n_blk)
    tables = eng._root_table(1, depth, n_blk)
    pay, layout = make_fast_payload_batch(shares, shared_rk=True)
    mark("payload build")
    per = len(shares) // eng.dp
    rows = []
    for r in range(eng.dp):
        p = u32_tensor(pay[r * per:(r + 1) * per], eng.mesh.devices[r, 0])
        mark("upload")
        acc = None
        for s, dev in enumerate(eng.mesh.devices[r]):
            table = tables[(s, dev)]
            ops = stacked_head(p, layout, (s, levels))
            mark("head walks")
            packed = fast_tail_expand_stacked(*ops, tail=tail, n_blk=n_blk)
            mark("tail kernels")
            words = stacked_words_t(packed, k, table.shape[0])
            mark("words regroup")
            part = packed_scan(table, words)
            mark("scan kernels")
            acc = part if acc is None else acc ^ part
            mark("XOR fold")
        rows.append(acc.cpu().numpy())
        mark("download")
    got = np.concatenate(rows)[:, :want.shape[1]]
    if not np.array_equal(got, want):
        fail("phase 4e: the stacked root split differs from the batch API's bytes")
    return split


def cpir_phase(cdb, ckeys, seed, counting, device) -> dict:
    """Phase 4d: single-server cPIR with its modexps on the card, a
    config.PAILLIER_BITS key (db_test.go:330); every comparison is exact
    integer equality. (a) The kernels against their plain versions on the
    card: a CPIR_CHECK_ROWS x CPIR_CHECK_COLS level-1 scan chunk and
    CPIR_CHECK_MODEXPS modexps mod N^2 of CPIR_CHECK_BITS-bit exponents
    (outside the counted run). Then, every launch count set to 0: (b) the
    kernels against CPython pow at full size: the r^N mod N^2 of
    encrypt_batch of CPIR_BATCH, decrypt_batch of those ciphertexts through
    the CRT halves (a modulus a row), CPIR_L2_MODEXPS modexps mod N^3 with
    exponents of bits(N^2); (c) the yardstick table (cdb) through engine
    "torch": an encrypted and a recursive query equal to engine "python"'s
    ciphertexts and recovering their rows; (d) the sqrt grid of
    CPIR_GRID_ROWS slots, one encrypted query through engine "torch", its
    split (host packing, upload, kernels, download and merge),
    CPIR_GRID_SAMPLES columns against CPython and the row recovered; (e) an
    AHE ASPIR round under device_modexp on the direct API (the right key
    recovers, a wrong key proves only the decoy side); (f) a PirService
    with PirConfig(paillier_engine="torch") beside one with
    paillier_engine="python" (CPython): equal response bytes to the same encrypted, recursive and AHE
    ASPIR frames, and a client's encrypted, recursive and AHE rounds
    through it (a wrong key refused). Then each kernel's launches over
    (b)-(f). device: None is the card ("cpu" rehearses on the plain
    versions). Returns what it measured."""
    import random
    import socket
    import struct

    import numpy as np
    import torch

    from pir_tpu_torch import encrypted as enc
    from pir_tpu_torch import wire
    from pir_tpu_torch.aspir import (
        auth_check,
        auth_prove,
        generate_auth_chal_for_query,
        new_authenticated_query,
    )
    from pir_tpu_torch.config import PAILLIER_BITS, PirConfig
    from pir_tpu_torch.crypto import mont, paillier
    from pir_tpu_torch.service import (
        OP_ASPIR_CHAL,
        OP_ASPIR_PROOF,
        OP_ENCRYPTED_QUERY,
        OP_ENCRYPTED_QUERY_REC,
        PirClient,
        PirService,
        _recv_frame,
        _send_frame,
    )
    from pir_tpu_torch.state import database_from_numpy

    counted, reset_counts, read_counts = counting
    dev = mont.resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rnd = random.Random(seed + 7)
    nrng = np.random.default_rng(seed + 7)
    out = {"s": {}}
    t = time.perf_counter()
    sk, pk = paillier.keygen(PAILLIER_BITS)
    out["keygen_s"], out["key_bits"] = time.perf_counter() - t, pk.n.bit_length()
    n, n2, n3 = pk.n, pk.n2, pk.n3

    def u32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    def timed(label, fn):
        t = time.perf_counter()
        res = fn()
        sync()
        out["s"][label] = time.perf_counter() - t
        return res

    # (a) kernels against plain versions, on the card
    L2 = mont.words_for_modulus(n2)
    cb = u32(mont.ints_to_words([rnd.randrange(1, n2) for _ in range(CPIR_CHECK_ROWS)], L2))
    ce = u32(nrng.integers(0, 1 << 24, size=(CPIR_CHECK_ROWS, CPIR_CHECK_COLS, 1),
                           dtype=np.uint32))
    pb = u32(mont.ints_to_words([rnd.randrange(n2) for _ in range(CPIR_CHECK_MODEXPS)], L2))
    pe = u32(mont.pack_exponents([rnd.getrandbits(CPIR_CHECK_BITS)
                                  for _ in range(CPIR_CHECK_MODEXPS)], CPIR_CHECK_BITS))
    mont.mont_scan(cb, ce, n2, 24)  # warm-ups
    mont.mont_powmod(pb, pe, n2, CPIR_CHECK_BITS)
    got = timed("check_scan_kernel", lambda: mont.mont_scan(cb, ce, n2, 24))
    want = timed("check_scan_plain", lambda: mont.mont_scan_plain(cb, ce, n2, 24))
    got_p = timed("check_powmod_kernel", lambda: mont.mont_powmod(pb, pe, n2, CPIR_CHECK_BITS))
    want_p = timed("check_powmod_plain",
                   lambda: mont.mont_powmod_plain(pb, pe, n2, CPIR_CHECK_BITS))
    out["max_abs_err"] = {
        "mont_scan": int((got.long() - want.long()).abs().max()),
        "mont_powmod": int((got_p.long() - want_p.long()).abs().max())}
    log(f"phase 4d: {pk.n.bit_length()}-bit key; (a) kernels vs plain on {dev}: a "
        f"{CPIR_CHECK_ROWS} x {CPIR_CHECK_COLS} scan chunk and {CPIR_CHECK_MODEXPS} modexps "
        f"of {CPIR_CHECK_BITS}-bit exponents mod N^2, max_abs_err {out['max_abs_err']}")
    if any(out["max_abs_err"].values()):
        fail("phase 4d: a Montgomery kernel disagrees with its plain version")

    reset_counts()
    # (b) against CPython pow at full size
    rs = [pk.random_r() for _ in range(CPIR_BATCH)]
    with paillier.device_modexp(True, device):
        got = timed("encrypt_modexps", lambda: paillier._powmod_batch(rs, [n] * CPIR_BATCH, n2))
    t = time.perf_counter()
    want = [pow(r, n, n2) for r in rs]
    out["s"]["encrypt_modexps_cpython"] = time.perf_counter() - t
    if got != want:
        fail("phase 4d: r^N mod N^2 of the encryption batch differs from CPython")
    out["encrypt_rs"], out["encrypt_kernel9"] = rs, got  # phase 4f's native check
    ms = [rnd.randrange(n) for _ in range(CPIR_BATCH)]
    with paillier.device_modexp(True, device):
        cts = timed("encrypt_batch", lambda: pk.encrypt_batch(ms))
        dec = timed("decrypt_batch", lambda: sk.decrypt_batch(cts))
        crt = sk._powmod_batch_sk([c.c for c in cts[:64]], [sk.lam] * len(cts[:64]), 2)
    t = time.perf_counter()
    dec_py = sk.decrypt_batch(cts)
    out["s"]["decrypt_batch_cpython"] = time.perf_counter() - t
    if dec != ms or dec_py != ms or crt != [pow(c.c, sk.lam, n2) for c in cts[:64]]:
        fail("phase 4d: the decryption batch (CRT, a modulus a row) differs from CPython")
    b3 = [rnd.randrange(n3) for _ in range(CPIR_L2_MODEXPS)]
    e3 = [rnd.getrandbits(n2.bit_length()) for _ in range(CPIR_L2_MODEXPS)]
    got = timed("level2_modexps", lambda: mont.device_powmod_batch(
        b3, e3, n3, e_max=n2.bit_length(), device=device))
    t = time.perf_counter()
    want = [pow(b, e, n3) for b, e in zip(b3, e3)]
    out["s"]["level2_modexps_cpython"] = time.perf_counter() - t
    if got != want:
        fail("phase 4d: the level-2 modexps differ from CPython")
    log(f"phase 4d: (b) equal to CPython pow: {CPIR_BATCH} r^N mod N^2, encrypt_batch and "
        f"decrypt_batch (CRT halves, a modulus a row) of {CPIR_BATCH}, {CPIR_L2_MODEXPS} "
        f"modexps mod N^3 of {n2.bit_length()}-bit exponents; s {out['s']}")

    # (c) the yardstick table through engine "torch"
    cmd = cdb.metadata()
    width, _ = cmd.get_dimensions_for_database(int(np.ceil(np.sqrt(cdb.db_size))), 1)
    row, target = rnd.randrange(cdb.db_size // width), rnd.randrange(cdb.db_size)
    with paillier.device_modexp(True, device):
        q = timed("yardstick_query_gen", lambda: enc.new_encrypted_query(cmd, pk, 1, row))
        dq = timed("yardstick_recursive_gen",
                   lambda: enc.new_doubly_encrypted_query(cmd, pk, 1, target))
    res = {}
    for engine in ("python", "torch"):
        res[engine] = (
            timed(f"yardstick_scan_{engine}", lambda: enc.private_encrypted_query(
                cdb, q, engine=engine, device=device)),
            timed(f"yardstick_recursive_{engine}", lambda: enc.private_doubly_encrypted_query(
                cdb, dq, engine=engine, device=device)))
    ints = {e: [[[c.c for c in sl.cts] for sl in r.slots] for r in v] for e, v in res.items()}
    if ints["torch"] != ints["python"]:
        fail("phase 4d: engine 'torch' differs from engine 'python' on the yardstick table")
    with paillier.device_modexp(True, device):
        got = timed("yardstick_recover", lambda: enc.recover_encrypted(res["torch"][0], sk))
        got2 = enc.recover_doubly_encrypted(res["torch"][1], sk)
    if [bytes(x.data) for x in got] != [cdb.data[row * width + j].tobytes()
                                        for j in range(width)] or \
            bytes(got2[0].data) != cdb.data[target].tobytes():
        fail("phase 4d: the yardstick queries through engine 'torch' do not recover their rows")
    log(f"phase 4d: (c) {cdb.db_size} x {cdb.slot_bytes} B: engine 'torch' equal to 'python' "
        f"(encrypted and recursive), rows recovered")

    # (d) the sqrt grid: CPIR_GRID_ROWS slots
    gdata = np.frombuffer(nrng.bytes(CPIR_GRID_ROWS * CPIR_SLOT_BYTES), np.uint8).reshape(
        CPIR_GRID_ROWS, CPIR_SLOT_BYTES)
    gdb = database_from_numpy(gdata, CPIR_SLOT_BYTES)
    gmd = gdb.metadata()
    gw, gh = gmd.get_dimensions_for_database(int(np.ceil(np.sqrt(CPIR_GRID_ROWS))), 1)
    grow = rnd.randrange(gh)
    with paillier.device_modexp(True, device):
        gq = timed("grid_query_gen", lambda: enc.new_encrypted_query(gmd, pk, 1, grow))
    num_cts = max(1, -(-CPIR_SLOT_BYTES // paillier.msg_space_bytes(pk)))
    split = {}
    t = time.perf_counter()
    emat, e_max, _ = enc._level1_exponents(gdb, gw, gh, num_cts)
    bases = mont.ints_to_words([c.c % n2 for c in gq.ebits], L2)
    split["host_packing"] = time.perf_counter() - t
    t = time.perf_counter()
    bt, et = u32(bases), u32(emat)
    sync()
    split["upload"] = time.perf_counter() - t
    t = time.perf_counter()
    words = mont.mont_scan(bt, et, n2, e_max)
    sync()
    split["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    prods = mont.words_to_ints(words.cpu().numpy())
    slots = [enc.EncryptedSlot([enc.Ciphertext(prods[c * num_cts + j], 1)
                                for j in range(num_cts)]) for c in range(gw)]
    split["download_merge"] = time.perf_counter() - t
    gres = timed("grid_scan_entry_point", lambda: enc.private_encrypted_query(
        gdb, gq, engine="torch", device=device))
    if [[c.c for c in sl.cts] for sl in gres.slots] != [[c.c for c in sl.cts] for sl in slots]:
        fail("phase 4d: the grid query's entry point differs from its split run")
    t = time.perf_counter()
    for col in rnd.sample(range(gw * num_cts), CPIR_GRID_SAMPLES):
        acc = 1
        for r in range(gh):
            acc = acc * pow(gq.ebits[r].c, int.from_bytes(emat[r, col].tobytes(), "little"),
                            n2) % n2
        if acc != prods[col]:
            fail(f"phase 4d: grid column {col} differs from CPython")
    out["s"]["grid_samples_cpython"] = time.perf_counter() - t
    with paillier.device_modexp(True, device):
        got = timed("grid_recover", lambda: enc.recover_encrypted(gres, sk))
    if [bytes(x.data) for x in got] != [gdata[grow * gw + j].tobytes() for j in range(gw)]:
        fail("phase 4d: the grid query does not recover its row")
    out["grid"] = {"rows": gh, "width": gw, "num_cts": num_cts, "e_max": e_max,
                   "split_s": split}
    log(f"phase 4d: (d) {CPIR_GRID_ROWS} slots x {CPIR_SLOT_BYTES} B as {gh} x {gw}: "
        f"{gh * gw * num_cts} modexps of {e_max}-bit exponents mod a {n2.bit_length()}-bit "
        f"N^2; split (s) {split}; entry point {out['s']['grid_scan_entry_point']:.4f} s; "
        f"{CPIR_GRID_SAMPLES} columns equal CPython, row {grow} recovered")
    del gdata, gdb, emat, bt, et, words

    # (e) AHE ASPIR on the direct API under device_modexp
    aspir = {}
    for key_row, label in ((target, "right"), ((target + 1) % cdb.db_size, "wrong")):
        t0 = time.perf_counter()
        with paillier.device_modexp(True, device):
            aq, ast = timed(f"aspir_{label}_query_gen", lambda: new_authenticated_query(
                cmd, sk, 1, target, ckeys.slot(key_row)))
            chal = timed(f"aspir_{label}_challenge", lambda: generate_auth_chal_for_query(
                8, ckeys, aq, engine="torch", device=device))
            proof = timed(f"aspir_{label}_prove", lambda: auth_prove(ast, chal))
            ok = timed(f"aspir_{label}_check", lambda: auth_check(pk, aq, chal, proof))
            side = aq.query0 if proof.q_bit == 0 else aq.query1
            ans = timed(f"aspir_{label}_answer", lambda: enc.private_doubly_encrypted_query(
                cdb, side, engine="torch", device=device))
            got = enc.recover_doubly_encrypted(ans, sk)
        aspir[label] = time.perf_counter() - t0
        real = proof.q_bit == ast.bit  # else only the decoy (null) side was provable
        recovered = bytes(got[0].data) == cdb.data[target].tobytes()
        if not ok or real != (label == "right") or recovered != (label == "right"):
            fail(f"phase 4d: AHE ASPIR with the {label} key: proof {ok}, real side {real}, "
                 f"recovered {recovered}")
    out["aspir_round_s"] = aspir
    log(f"phase 4d: (e) AHE ASPIR under device_modexp: right key recovers in "
        f"{aspir['right']:.3f} s (DDLEQ prove {out['s']['aspir_right_prove']:.3f} s, "
        f"check {out['s']['aspir_right_check']:.3f} s), wrong key proves only the decoy side "
        f"({aspir['wrong']:.3f} s)")

    # (f) a PirService with paillier_engine="torch" beside a CPython one
    svcs = {"python": PirService(cdb, config=PirConfig(paillier_engine="python", device=device),
                                 key_db=ckeys).start(),
            "torch": PirService(cdb, config=PirConfig(paillier_engine="torch", device=device),
                                key_db=ckeys).start()}
    try:
        aq, ast = new_authenticated_query(cmd, sk, 1, target, ckeys.slot(target))
        frames = [(OP_ENCRYPTED_QUERY, wire.serialize_encrypted_query(q)),
                  (OP_ENCRYPTED_QUERY_REC, wire.serialize_doubly_encrypted_query(dq)),
                  (OP_ASPIR_CHAL, struct.pack("<I", 8) + wire.serialize_auth_query(aq))]
        answers, socks, proof_frame = {}, {}, None
        for engine, svc in svcs.items():
            socks[engine] = sock = socket.create_connection(svc.address)
            answers[engine] = []
            t = time.perf_counter()
            for op, payload in frames:
                _send_frame(sock, op, payload)
                answers[engine].append(_recv_frame(sock))
            out["s"][f"service_frames_{engine}"] = time.perf_counter() - t
        for engine, sock in socks.items():  # the same challenge: one proof for both
            if proof_frame is None:
                chal_resp = answers[engine][-1][1]
                with paillier.device_modexp(True, device):
                    proof = auth_prove(ast, wire.deserialize_chal_token(chal_resp[8:]))
                proof_frame = chal_resp[:8] + wire.serialize_proof_token(proof)
            t = time.perf_counter()
            _send_frame(sock, OP_ASPIR_PROOF, proof_frame)
            answers[engine].append(_recv_frame(sock))
            out["s"][f"service_proof_{engine}"] = time.perf_counter() - t
            sock.close()
        if answers["torch"] != answers["python"] or answers["torch"][-1][1][:1] != b"\x01":
            fail("phase 4d: the 'torch' service's cPIR and AHE ASPIR answers differ from the "
                 "CPython service's")
        client = PirClient([svcs["torch"].address])
        with paillier.device_modexp(True, device):
            got = timed("service_encrypted", lambda: client.query_encrypted(row, sk, pk))
            got2 = timed("service_recursive",
                         lambda: client.query_encrypted_recursive(target, sk, pk))
            got3 = timed("service_aspir_right", lambda: client.query_authenticated(
                target, sk, ckeys.slot(target)))
            t = time.perf_counter()
            try:
                client.query_authenticated(target, sk, ckeys.slot((target + 1) % cdb.db_size))
                fail("phase 4d: the 'torch' service let a wrong AHE ASPIR key through")
            except PermissionError:
                out["s"]["service_aspir_wrong"] = time.perf_counter() - t
        client.close()
        if [bytes(x.data) for x in got] != [cdb.data[row * width + j].tobytes()
                                            for j in range(width)] or \
                bytes(got2[0].data) != cdb.data[target].tobytes() or \
                bytes(got3[0].data) != cdb.data[target].tobytes():
            fail("phase 4d: the 'torch' service's rounds do not recover their rows")
    finally:
        for svc in svcs.values():
            svc.close()
    log(f"phase 4d: (f) the 'torch' service's encrypted, recursive, AHE challenge and proof "
        f"answers equal the CPython service's bytes; its client rounds recover, a wrong key "
        f"is refused")
    out["launches"] = read_counts("cpir", ("mont_powmod", "mont_scan"))
    out["n"], out["crt_moduli"] = n, (sk.p ** 2, sk.q ** 2)  # phase 5's operands
    out["key"] = (sk, pk)  # phase 4f's encrypted query
    out["max_memory_allocated"] = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                                   else 0)
    log(f"phase 4d: seconds {json.dumps({k: round(v, 4) for k, v in out['s'].items()})}")
    return out


def ncu_launches(spec, dev, np, torch, compat_stage, fast_tail_expand_stacked) -> int:
    """The child that ncu_reading profiles: one stacked tail launch and one
    emitting compat stage launch on random operands (0 / ~0 masks where
    the kernels read bit 0), then exit."""
    s_n, w, tail, n_blk, q, nc, wc, ctail = (int(x) for x in spec.split(","))
    rng = np.random.default_rng(0)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    def masks(*shape):
        return -torch.from_numpy(rng.integers(0, 2, size=shape, dtype=np.int32)).to(dev)

    fast_tail_expand_stacked(words(s_n, 8, 1, 16, w), words(s_n, 1, 1, w),
                             masks(s_n, tail, 8, 16, w), masks(s_n, tail, 1, w),
                             masks(s_n, tail, 1, w), masks(11, 8, 3, 16, 1),
                             words(s_n, 8, n_blk, 16, w), masks(11, 8, 16, 1),
                             tail=tail, n_blk=n_blk)
    compat_stage(words(q, 8, nc, 16, wc), words(q, nc, 1, wc), masks(q, ctail, 8, 16, 1),
                 masks(q, ctail), masks(q, ctail), masks(q, 11, 8, 3, 16, 1), masks(q),
                 tail=ctail, emit_bits=True)
    torch.cuda.synchronize()
    return 0


def ncu_reading(spec: str) -> dict:
    """NCU_METRICS on the two launches of `chip_smoke.py --ncu-launches
    spec` under Nsight Compute: {kernel: {metric: value}}, or why not."""
    exe = shutil.which("ncu") or next(
        (p for p in ("/usr/local/cuda/bin/ncu",) if os.path.exists(p)), None)
    if exe is None:
        return {"ran": False, "why": "ncu not installed"}

    def errors(proc):
        return [ln for ln in (proc.stdout + proc.stderr).splitlines() if "ERR" in ln]

    # a card whose counters ncu cannot read fails this query in ~2 s; skip the child then
    query = subprocess.run([exe, "--query-metrics"], capture_output=True, text=True,
                           timeout=NCU_TIMEOUT_S)
    if query.returncode != 0 or errors(query):
        return {"ran": False, "why": f"ncu --query-metrics exit {query.returncode}: "
                + " | ".join(errors(query)[-3:])}
    cmd = [exe, "--metrics", ",".join(NCU_METRICS), "-k",
           "regex:stacked_tail_kernel|compat_stage_kernel", "-c", "2",
           sys.executable, os.path.abspath(__file__), "--ncu-launches", spec]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NCU_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"ran": False, "why": f"ncu timed out after {NCU_TIMEOUT_S} s"}
    found, kernel = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"(stacked_tail_kernel|compat_stage_kernel)", line)
        if m and not line.startswith(" " * 4):
            kernel = m.group(1)
        parts = line.split()
        if kernel and parts and parts[0] in NCU_METRICS:
            found.setdefault(kernel, {})[parts[0]] = parts[-1]
    if proc.returncode != 0 or not found:
        return {"ran": False, "why": f"ncu exit {proc.returncode}: "
                + " | ".join(errors(proc)[-3:])}
    return {"ran": True, "metrics": found}


if __name__ == "__main__":
    sys.exit(main())
