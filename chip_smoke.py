#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (pir_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--out FILE]

From the repository root, on a machine with one NVIDIA H100 and nvcc:

0. prints the card (nvidia-smi name and power limit) and the versions;
1. builds both CUDA kernels from pir_tpu_torch/csrc with nvcc;
2. builds a 2^20-row x 1024-byte table (1 GiB) from --seed and holds each
   kernel against its plain torch version on the card, with equal bytes:
   the stacked tail at the serving geometry (depth 10, 8 leaf blocks,
   k = 32, tail 3) for shared and for distinct keys, and the packed
   scan on the whole table with a 64-query slice;
3. serves 3 batches of 4096 shared-key queries, both shares, through
   TorchPirServer, recovers every answer by XOR and compares it with the
   table rows; prints per-batch seconds, queries per second, the
   head / tail / scan split and the kernels' launch counts;
4. serves one distinct-key batch of 64 queries the same way;
5. times each kernel, its plain version and its PyTorch yardstick at the
   main path's shapes, and prints one JSON line of kernels.

Every failed check raises, so the exit code is not 0. The last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing any result; it imports nothing of JAX or of pir_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HEIGHT = 1 << 20
SLOT_BYTES = 1024
BATCH = 4096
BATCHES = 3
DISTINCT_BATCH = 64
SCAN_CHECK_Q = 64
TAIL_CHECK_STEPS = 4
# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer rate: 64 INT32 lanes per SM per clock against the 128
# float32 lanes behind the 67 TFLOP/s float32 figure (which counts an
# FMA as two operations), so a quarter of it
INT32_OPS_PER_S = 67e12 / 4
# T-table AES-128 per round: 16 table lookups, 12 rotations, 16 XORs
AES_BLOCK_OPS = 10 * 44

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the kernels summary JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from pir_tpu_torch import _build
    from pir_tpu_torch.database import DBMetadata
    from pir_tpu_torch.dpf import host as dpf_host
    from pir_tpu_torch.dpf.device import make_fast_payload_batch
    from pir_tpu_torch.models.pipeline import (
        payload_tensor,
        stacked_fast_geometry,
        stacked_head,
        stacked_words_t,
    )
    from pir_tpu_torch.ops.expand import (
        fast_tail_expand_stacked,
        fast_tail_expand_stacked_plain,
    )
    from pir_tpu_torch.ops.packed_scan import packed_scan, packed_scan_plain, unpack_words_t
    from pir_tpu_torch.query import new_fast_index_query_shares, new_index_query_shares_batch
    from pir_tpu_torch.server import TorchPirServer
    from pir_tpu_torch.state import database_from_numpy

    dev = torch.device("cuda", 0)

    # ---- phase 0: the card --------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: card {smi!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")

    # ---- phase 1: build -----------------------------------------------
    t = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t:.2f} s")

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

    def batch_shares(n, distinct):
        idx = [int(i) for i in rng.integers(0, HEIGHT, n)]
        if distinct:
            pairs = [new_fast_index_query_shares(md, i, 1, rand_bytes=keygen_rng.bytes)
                     for i in idx]
        else:
            pairs = new_index_query_shares_batch(md, idx, 1, rand_bytes=keygen_rng.bytes)
        return idx, pairs

    def tail_ops(shares):
        pay, layout = make_fast_payload_batch(shares)
        return stacked_head(payload_tensor(pay, dev), layout), layout

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

    def serve_and_check(idx, pairs, label):
        times = []
        answers = []
        for part in (0, 1):
            t = time.perf_counter()
            res = srv.private_secret_shared_query_batch([p[part] for p in pairs])
            times.append(time.perf_counter() - t)
            answers.append(np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8)
                                     for r in res]))
        rec = answers[0] ^ answers[1]
        bad = np.flatnonzero((rec != data[np.asarray(idx)]).any(axis=1))
        if bad.size:
            fail(f"{label}: {bad.size} of {len(idx)} answers do not recover (first {bad[0]})")
        return times

    # ---- phase 3: the main path ------------------------------------------
    fast_tail_expand_stacked.launches = 0
    packed_scan.launches = 0
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
    launches = {"stacked_tail": fast_tail_expand_stacked.launches,
                "packed_scan": packed_scan.launches}
    log(f"phase 3: launches on the main path: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")

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
    pay_t = payload_tensor(pay, dev)
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

    # ---- phase 4: a distinct-key batch -------------------------------------
    fast_tail_expand_stacked.launches = 0
    packed_scan.launches = 0
    idx, dpairs = batch_shares(DISTINCT_BATCH, distinct=True)
    times = serve_and_check(idx, dpairs, "distinct-key batch")
    log(f"phase 4: distinct-key batch of {DISTINCT_BATCH}: {times[0]:.4f} s + {times[1]:.4f} s; "
        f"all recovered; launches stacked_tail {fast_tail_expand_stacked.launches}, "
        f"packed_scan {packed_scan.launches}")
    if not (fast_tail_expand_stacked.launches and packed_scan.launches):
        fail("the distinct-key batch did not go through both kernels")

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
    s_n = ops[0].shape[0]
    head_levels = depth - tail
    blocks = s_n * k * (3 * (1 << head_levels) * ((1 << tail) - 1) + (1 << depth) * n_blk)
    tail_bytes = sum(x.numel() * x.element_size() for x in ops) + \
        tail_out.numel() * tail_out.element_size()
    tail_bound = {"bytes": tail_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": blocks * AES_BLOCK_OPS / INT32_OPS_PER_S * 1e3}
    log(f"phase 5: stacked tail ({s_n} steps, {blocks} AES blocks): kernel {tail_ms:.4f} ms, "
        f"plain {tail_plain_ms:.4f} ms, bounds {tail_bound}, max_abs_err {e_tail}")

    q = words_t.shape[1]
    scan_ms, scan_out = cuda_ms(lambda: packed_scan(table, words_t), 3)
    scan_plain_ms, scan_plain = cuda_ms(lambda: packed_scan_plain(table, words_t), 1, warm=False)
    e_scan = err(scan_out, scan_plain)
    del scan_plain
    rows, width = table.shape
    scan_bytes = table.numel() + words_t.numel() * 4 + q * width
    scan_bound = {"bytes": scan_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": 8 * 2 * q * rows * width / INT8_TENSOR_OPS_PER_S * 1e3}
    # yardstick: the same function as 8 bit-plane int8 products
    bits = unpack_words_t(words_t).to(torch.int8)
    planes = [((table >> p) & 1).to(torch.int8) for p in range(8)]
    library_ms, acc = cuda_ms(lambda: [torch._int_mm(bits, pl) for pl in planes], 1)
    lib_out = sum(((a & 1) << p) for p, a in enumerate(acc)).to(torch.uint8)
    e_lib = err(lib_out, scan_out)
    del bits, planes, acc, lib_out
    log(f"phase 5: packed scan ({q} queries x {rows} rows x {width} B): kernel {scan_ms:.4f} ms, "
        f"plain {scan_plain_ms:.4f} ms, torch._int_mm x8 {library_ms:.4f} ms, "
        f"bounds {scan_bound}, max_abs_err {e_scan} (library {e_lib})")
    if e_tail or e_scan or e_lib:
        fail("a kernel disagrees at the main path's shapes")

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
              max(e_scan, e_scan_slice)),
    ]}
    if args.out:
        summary = dict(kernels, card=smi, per_share_batch_s=per_batch,
                       split_s=split,
                       elapsed_s=time.perf_counter() - T0)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
