"""Shared set-up of the benchmark's CPU tests: the benchmark's modules on
sys.path, and cells shrunk to sizes the CPU runs in a second."""

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

FAST = "dpf2-fast-1mx256b.q4096"
COMPAT = "dpf2-compat-1mx3b.q1024"
# each cell's configuration and mix at CPU sizes: same keys, entry and loop
SIZES = {
    FAST: {"config": {"rows": 1 << 12, "row_bytes": 64, "leaf_bits": 128},
           "mix": {"batch": 32, "pool": 64, "draws": 4, "check_queries": 64,
                   "warmup_batches": 2, "trace_batches": 2}},
    COMPAT: {"config": {"rows": 1 << 10, "row_bytes": 3},
             "mix": {"batch": 16, "pool": 32, "draws": 4, "check_queries": 32,
                     "warmup_batches": 2, "trace_batches": 2}},
}


def run_small(cell: str, seed: int = 2**31 + 7, seconds: float = 0.5, traced: bool = False,
              **kw) -> dict:
    """One run of `cell` on the CPU at SIZES[cell]."""
    import harness

    return harness.run_cell(ROOT, cell, seed, seconds, traced, "cpu", time.perf_counter(),
                            log=lambda msg: None, sizes=SIZES[cell], **kw)
