"""cPIR engine comparison: CPython against the card's Montgomery engine
(counterpart of ``benchmarks_paillier_tpu.py``).

Stage 1 (correctness, timed): the reference's cPIR bench shape, 2^10
slots x 3 B with a PAILLIER_BITS-bit key (db_test.go:330,
test_constants.go), answered by engines "python" and "torch"; the
ciphertexts must be equal and decrypt to the queried grid row.

Stage 2 (throughput): the isolated multi-exponentiation at a serving
shape, PAILLIER_H rows x PAILLIER_W chunks of 24-bit exponents over random
bases mod N^2 (the scan's cost does not depend on the data, as the
reference's fakeDoublyEncryptedQuery, db_test.go:427-477), through
``device_paillier_scan``; two columns are held against CPython. Reports
modexps/s.

Stage 3: a DDLEQ proof and its check (64 repetitions, aspir.go:156-158),
CPython against ``device_modexp()``. Stage 4: cPIR query generation on a
128 x 128 grid (query.go:118-221), the same two routes.

    python -m pir_tpu_torch.benchmarks_paillier [--device cpu] [--seed N]

Env: PAILLIER_H (1024), PAILLIER_W (32), PAILLIER_BITS (1024). Details go
to stderr, one JSON line to stdout. With no --device it runs on the card
and raises where there is none; the first "torch" call builds the
kernels (timed apart).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import numpy as np
import torch

from . import encrypted as enc
from .crypto import paillier
from .crypto.mont import device_paillier_scan, resolve_device
from .database import DBMetadata
from .state import database_from_numpy


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return time.perf_counter() - t, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bits = int(os.environ.get("PAILLIER_BITS", "1024"))
    H = int(os.environ.get("PAILLIER_H", "1024"))
    W = int(os.environ.get("PAILLIER_W", "32"))
    rng = random.Random(args.seed)
    nrng = np.random.default_rng(args.seed)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device {name}; keygen({bits}) ...")
    t, (sk, pk) = _timed(lambda: paillier.keygen(bits))
    log(f"  {t:.1f}s")
    rec = {"device": name, "bits": bits, "h": H, "w": W}

    # ---- stage 1: the reference's bench shape, both engines, equal ints ----
    db = database_from_numpy(nrng.integers(0, 256, size=(1 << 10, 3), dtype=np.uint8), 3)
    q_row = 7
    q = enc.new_encrypted_query(db.metadata(), pk, 1, q_row)
    results = {}
    for engine in ("python", "torch", "torch"):
        t, res = _timed(lambda: enc.private_encrypted_query(db, q, engine=engine, device=dev))
        warm = engine in results
        results[engine] = [[c.c for c in s.cts] for s in res.slots]
        rec[f"stage1_{engine}{'_warm' if warm else ''}_s"] = t
        log(f"stage1 {engine:6s}{' warm' if warm else ''}: {t:.3f}s (2^10 x 3B, {bits}-bit key)"
            + (" [incl. kernel build]" if engine == "torch" and not warm else ""))
        rows = enc.recover_encrypted(res, sk)
        for j, got in enumerate(rows):
            idx = q_row * len(rows) + j
            if idx < db.db_size and bytes(got.data) != db.data[idx].tobytes():
                raise RuntimeError(f"stage1: engine {engine} does not recover slot {idx}")
    if results["python"] != results["torch"]:
        raise RuntimeError("stage1: the engines' ciphertexts differ")
    log("stage1: ciphertexts equal across engines, recovery OK")

    # ---- stage 2: the isolated multi-exponentiation ----
    mod = pk.n2
    bases = [rng.randrange(1, mod) for _ in range(H)]
    exps = [rng.getrandbits(24) for _ in range(H * W)]
    device_paillier_scan(bases[:2], exps[:2 * W], W, mod, e_max=24, device=dev)  # warm
    t, out = _timed(lambda: device_paillier_scan(bases, exps, W, mod, e_max=24, device=dev))
    for col in (0, W - 1):
        want = 1
        for r in range(H):
            want = want * pow(bases[r], exps[r * W + col], mod) % mod
        if out[col] != want:
            raise RuntimeError(f"stage2: column {col} differs from CPython")
    rec["stage2_s"] = t
    rec["modexp_per_s"] = H * W / t
    log(f"stage2 torch: {t:.3f}s = {H * W / t:,.0f} modexp(24b, {mod.bit_length()}b)/s; "
        "two columns equal CPython")

    # ---- stage 3: DDLEQ prove / verify, 64 repetitions ----
    ct1 = pk.encrypt_zero(2)
    ct2, a, b = sk.nested_randomize(ct1)
    for label, on in (("python", False), ("torch", True)):
        with paillier.device_modexp(on, dev):
            t_p, proof = _timed(lambda: sk.prove_ddleq(8, ct1, ct2, a, b))
            t_v, ok = _timed(lambda: pk.verify_ddleq(ct1, ct2, proof))
        if not ok:
            raise RuntimeError(f"stage3: the {label} route's proof does not verify")
        rec[f"stage3_{label}_prove_s"], rec[f"stage3_{label}_verify_s"] = t_p, t_v
        log(f"stage3 {label:6s}: DDLEQ prove {t_p:.2f}s verify {t_v:.2f}s")

    # ---- stage 4: cPIR query generation on a 128 x 128 grid ----
    md = DBMetadata(3, 1 << 14)
    for label, on in (("python", False), ("torch", True)):
        with paillier.device_modexp(on, dev):
            t_q, q1 = _timed(lambda: enc.new_encrypted_query(md, pk, 1, 5))
            t_d, q2 = _timed(lambda: enc.new_doubly_encrypted_query(md, pk, 1, 77))
        if sk.decrypt_batch(q1.ebits) != [int(i == 5) for i in range(len(q1.ebits))]:
            raise RuntimeError(f"stage4: the {label} route's query does not decrypt")
        rec[f"stage4_{label}_query_s"], rec[f"stage4_{label}_recursive_s"] = t_q, t_d
        log(f"stage4 {label:6s}: query gen {t_q:.2f}s ({len(q1.ebits)} cts), recursive "
            f"{t_d:.2f}s ({len(q2.row.ebits)}+{len(q2.col.ebits)} cts)")

    print(json.dumps({"metric": "paillier_scan_modexp_per_s", "value": rec["modexp_per_s"],
                      "unit": "modexp/s", **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
