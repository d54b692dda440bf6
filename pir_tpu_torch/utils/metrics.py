"""Serving metrics and tracing (counterpart of ``pir_tpu/utils/metrics.py``).

``ServerMetrics`` is copied: queries/sec, effective scan GB/s and
latency percentiles of a service. It takes a lock around its updates and
its summary, since a service's handler threads record at once. ``trace(dirname)`` records a
``torch.profiler`` trace of a block, CPU and CUDA activities, and writes
it to `dirname` as a Chrome trace; it adds no spans or counters of its
own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field


@dataclass
class ServerMetrics:
    queries: int = 0
    bytes_scanned: int = 0
    latencies_s: list = field(default_factory=list)
    started_at: float = field(default_factory=time.time)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    @contextlib.contextmanager
    def timed_query(self, scan_bytes: int, n: int = 1):
        """Time a request handling `n` queries scanning `scan_bytes` total."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.queries += n
            self.bytes_scanned += scan_bytes
            self.latencies_s.append(dt)
            if len(self.latencies_s) > 10000:
                del self.latencies_s[: len(self.latencies_s) - 10000]

    def percentile(self, p: float) -> float:
        with self._lock:
            xs = sorted(self.latencies_s)
        if not xs:
            return 0.0
        k = min(len(xs) - 1, int(p / 100 * len(xs)))
        return xs[k]

    def summary(self) -> dict:
        elapsed = max(1e-9, time.time() - self.started_at)
        with self._lock:
            queries, scanned = self.queries, self.bytes_scanned
        return {
            "queries": queries,
            "qps": queries / elapsed,
            "effective_GBps": scanned / elapsed / 1e9,
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
        }


@contextlib.contextmanager
def trace(dirname: str | None):
    """Record a torch.profiler trace around a block (CPU, and CUDA when a
    card is present) and export it to `dirname`/trace.json; a no-op if
    dirname is None."""
    if not dirname:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
