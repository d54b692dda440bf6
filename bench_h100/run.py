"""The benchmark of ``pir_tpu_torch`` on one NVIDIA H100: one run of one cell.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic mix and
metrics are the files ``BENCHMARK.json`` names. The run makes its table and
queries from the seed, warms up, serves for ``--seconds``, checks every
kept answer against the plain reference, and prints the compared numbers
beside their limits as its last lines on standard error and one JSON
object as its last line on standard output: the end-to-end metrics, or
with ``--trace 1`` the per-layer metrics of a traced window. It needs a
CUDA device, and exits non-zero without one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# caches of compilers the program may use stay inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(HERE, ".cache", sub)
    sys.path[:0] = [HERE, ROOT]

    import torch

    print(f"bench_h100: torch imported at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    import check
    import harness

    if not torch.cuda.is_available():
        print("bench_h100: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    cell = harness.find(harness.load_spec(ROOT), "workloads", args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench_h100: {args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench_h100: the process loaded {found}", file=sys.stderr)
        return 3
    for line in check.lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
