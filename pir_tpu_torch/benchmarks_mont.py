"""Kernels 9 and 10 (crypto/mont.py) at chip_smoke.py phase 5's shapes, for
this tree or another checkout of the port, so that two versions of the
kernels can be timed in turns on one card.

    python3 pir_tpu_torch/benchmarks_mont.py [--tree DIR] [--reps N] [--seed N] [--sweep]

DIR (default: this file's checkout) is a checkout holding pir_tpu_torch/;
its kernels are built there at first use. The moduli are random odd
numbers of a 1024-bit key's sizes (timing does not depend on their
structure): N^2 of 2048 bits (64 words), its CRT halves p^2 and q^2 of
1024 bits (32 words), N^3 of 3072 bits (96 words). Shapes:

* powmod_encrypt: 1024 modexps of 1024-bit exponents mod N^2 (r^N);
* powmod_decrypt_crt: 2048, a modulus a row, p^2 or q^2, 1024-bit;
* powmod_level2: 64 of 2048-bit exponents mod N^3;
* powmod_check: 16 of 256-bit exponents mod N^2;
* scan_grid: 1024 x 1024 24-bit exponents mod N^2 (the 2^20-slot grid);
* scan_check: 64 x 4 24-bit exponents mod N^2;
* scan_level2: 32 x 1 2048-bit exponents mod N^3 (a recursive query's
  level-2 scan).

Each is timed with CUDA events over --reps launches after a warm-up, and
sampled rows (modexps) or columns (scans) are held against CPython pow.
One JSON line to stdout: the card, the tree and ms by shape.

--sweep (this tree's planners only) instead times forced plans, one JSON
line each: kernel 9 on 64 and 1024 modexps of 64- and 1024-bit exponents
mod N^2 at every G with 1- and 5-bit windows, 2048 CRT-shaped modexps (32
words) at G 8, 16 and 32 with one modulus or two and one exponent or
many, and the grid at every G (6-bit windows, Horner chunks): the data the
planners' cost model (crypto/mont.py) is fitted to.
"""

from __future__ import annotations

import os
import sys

# run as a script, its own directory (pir_tpu_torch/, whose keyword.py would
# shadow the standard library's) must not lead the path
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    del sys.path[0]

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    loaded = sys.modules.get("pir_tpu_torch")
    if loaded is not None and not os.path.abspath(loaded.__file__).startswith(tree + os.sep):
        raise SystemExit(f"pir_tpu_torch is already imported from {loaded.__file__}")
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    mont = importlib.import_module("pir_tpu_torch.crypto.mont")
    if not torch.cuda.is_available():
        raise SystemExit("benchmarks_mont: no CUDA device")
    dev = torch.device("cuda", 0)
    rnd = random.Random(args.seed)

    def odd(bits):
        return rnd.getrandbits(bits) | (1 << (bits - 1)) | 1

    n2, p2, q2, n3 = odd(2048), odd(1024), odd(1024), odd(3072)

    def u32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    def timed(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps, out

    if args.sweep:
        return sweep(mont, u32, timed, odd, rnd, n2, p2, q2)
    res = {}
    powmods = {
        "encrypt": ([rnd.randrange(n2) for _ in range(1024)], [odd(1024)] * 1024, [n2] * 1024,
                    1024),
        "decrypt_crt": ([rnd.randrange(p2) for _ in range(1024)]
                        + [rnd.randrange(q2) for _ in range(1024)],
                        [rnd.getrandbits(1024) for _ in range(2048)], [p2] * 1024 + [q2] * 1024,
                        1024),
        "level2": ([rnd.randrange(n3) for _ in range(64)], [rnd.getrandbits(2048)
                                                           for _ in range(64)], [n3] * 64, 2048),
        "check": ([rnd.randrange(n2) for _ in range(16)], [rnd.getrandbits(256)
                                                          for _ in range(16)], [n2] * 16, 256),
    }
    for name, (bs, es, mods, e_max) in powmods.items():
        L = mont.words_for_modulus(max(mods))
        bt, et = u32(mont.ints_to_words(bs, L)), u32(mont.pack_exponents(es, e_max))
        arg = mods if len(set(mods)) > 1 else mods[0]
        ms, got = timed(lambda: mont.mont_powmod(bt, et, arg, e_max))
        rows = sorted(set(range(0, len(bs), max(1, len(bs) // 8))) | {len(bs) - 1})
        ints = mont.words_to_ints(got.cpu().numpy())
        if any(ints[i] != pow(bs[i], es[i], mods[i]) for i in rows):
            raise SystemExit(f"benchmarks_mont: kernel 9 differs from CPython on {name}")
        res[f"powmod_{name}"] = ms
    scans = {"grid": (1024, 1024, n2, 24), "check": (64, 4, n2, 24), "level2": (32, 1, n3, 2048)}
    for name, (h, w, m, e_max) in scans.items():
        L = mont.words_for_modulus(m)
        bs = [rnd.randrange(m) for _ in range(h)]
        vals = [rnd.getrandbits(e_max) for _ in range(h * w)]
        ev = mont.pack_exponents(vals, e_max).reshape(h, w, -1)
        bt, et = u32(mont.ints_to_words(bs, L)), u32(ev)
        ms, got = timed(lambda: mont.mont_scan(bt, et, m, e_max))
        ints = mont.words_to_ints(got.cpu().numpy())
        for c in sorted({0, w // 2, w - 1}):
            acc = 1
            for r in range(h):
                acc = acc * pow(bs[r], vals[r * w + c], m) % m
            if acc != ints[c]:
                raise SystemExit(f"benchmarks_mont: kernel 10 differs from CPython on {name}")
        res[f"scan_{name}"] = ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    print(json.dumps({"card": card[0] if card else None,
                      "device": torch.cuda.get_device_name(0), "tree": tree, "ms": res}))
    return 0


def sweep(mont, u32, timed, odd, rnd, n2, p2, q2) -> int:
    import numpy as np

    def out(rec, ms, words, prods):
        rec.update(ms=round(ms, 3), cycles_per_round=round(
            ms * 1e-3 / prods * 1.98e9 / (rec["G"] * mont.lane_words(words, rec["G"])), 1))
        print(json.dumps(rec), flush=True)

    for b in (64, 1024):
        for e_max in (64, 1024):
            bs = [rnd.randrange(n2) for _ in range(b)]
            bt = u32(mont.ints_to_words(bs, 64))
            et = u32(mont.pack_exponents([rnd.getrandbits(e_max) for _ in range(b)], e_max))
            for G in mont.GROUP_LANES:
                for wb in (1, 5):
                    plan = {"G": G, "K": mont.lane_words(64, G), "wbits": wb,
                            "warps": 4 if wb == 1 else 2}
                    ms, _ = timed(lambda: mont.mont_powmod(bt, et, n2, e_max, plan=plan))
                    nwin = -(-e_max // wb)
                    out({"powmod": b, "e_max": e_max, "G": G, "wbits": wb}, ms, 64,
                        (1 << wb) - 1 + (nwin - 1) * (wb + 1) + 1)
    b = 2048
    bs = [rnd.randrange(p2) for _ in range(b)]
    bt = u32(mont.ints_to_words(bs, 32))
    for mods in ("one", "two"):
        mod = p2 if mods == "one" else [p2, q2] * (b // 2)
        for exps in ("one", "many"):
            es = [rnd.getrandbits(1024)] * b if exps == "one" else [rnd.getrandbits(1024)
                                                                  for _ in range(b)]
            et = u32(mont.pack_exponents(es, 1024))
            for G in (8, 16, 32):
                plan = {"G": G, "K": mont.lane_words(32, G), "wbits": 5, "warps": 4}
                ms, _ = timed(lambda: mont.mont_powmod(bt, et, mod, 1024, plan=plan))
                out({"powmod": b, "words": 32, "moduli": mods, "exponents": exps, "G": G},
                    ms, 32, 31 + 204 * 6 + 1)
    h = w = 1024
    bt = u32(mont.ints_to_words([rnd.randrange(n2) for _ in range(h)], 64))
    et = u32(np.random.default_rng(0).integers(0, 1 << 24, size=(h, w, 1), dtype=np.uint32))
    for G in mont.GROUP_LANES:
        K = mont.lane_words(64, G)
        rc = 232448 // (4 * G * K << 6)
        plan = {"G": G, "K": K, "wbits": 6, "rc": rc, "chunks": -(-h // rc), "horner": 1,
                "cols": max(32 // G, min(mont.scan_threads(K) // G, 128)), "slab_chunks": h}
        ms, _ = timed(lambda: mont.mont_scan(bt, et, n2, 24, plan=plan))
        prods = mont.scan_products(plan, h, w, 24)
        rec = {"grid": True, "G": G, "cols": plan["cols"], "rc": rc, "products": prods}
        rec.update(ms=round(ms, 3))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
