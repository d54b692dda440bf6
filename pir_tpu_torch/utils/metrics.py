"""Serving metrics and the port's span recorder (counterpart of
``pir_tpu/utils/metrics.py``, whose ``trace()`` has no counterpart here:
a ``torch.profiler`` run around any block carries the spans below).

``ServerMetrics`` is copied: queries/sec, effective scan GB/s and
latency percentiles of a service. It takes a lock around its updates and
its summary, since a service's handler threads record at once.

``span(name, arg=None)`` times a stretch of the serving path under a
``pir.*`` name. Always on: each span adds its self time (its duration
less what its child spans on the same thread cover) and one count to a
process-wide total under its name; ``span_totals()`` snapshots them,
``reset_spans()`` clears them. While a ``torch.profiler`` records, a span
adds nothing to the totals (a profiled host runs slower) and enters a
``record_function`` range instead, so it lands in the Chrome trace as a
``user_annotation`` event on the profiler's clock beside the kernels it
launches. The range is named ``<name>#<arg>``: ``arg`` is the batch's
number (``next_batch()``, which a batch's root span takes and its child
spans inherit) or a library's name, so one batch's dispatch and answer
spans share it (torch's trace export drops a range's ``args`` string).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch


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


_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns
_totals: dict[str, list] = {}  # name -> [self ns, count]
_totals_lock = threading.Lock()
_batches = itertools.count(1)


class _Stack(threading.local):
    def __init__(self):
        self.open = []  # this thread's open spans, innermost last


_stack = _Stack()


def next_batch() -> int:
    """A new batch number, unique in the process (the root span's arg)."""
    return next(_batches)


class span:
    """Context manager timing a block under `name` (see the module
    docstring). A class, not a generator: it runs ~10 times a batch."""

    __slots__ = ("name", "arg", "_t0", "_inner", "_range")

    def __init__(self, name: str, arg=None):
        self.name = name
        self.arg = arg
        self._inner = 0
        self._range = None

    def __enter__(self) -> "span":
        open_ = _stack.open
        if self.arg is None and open_:
            self.arg = open_[-1].arg
        if _profiling():
            label = self.name if self.arg is None else f"{self.name}#{self.arg}"
            self._range = torch.profiler.record_function(
                label, None if self.arg is None else str(self.arg))
            self._range.__enter__()
        open_.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        dt = _clock() - self._t0
        open_ = _stack.open
        open_.pop()
        if open_:
            open_[-1]._inner += dt
        if self._range is not None:
            self._range.__exit__(*exc)
            return
        own = dt - self._inner
        with _totals_lock:
            total = _totals.get(self.name)
            if total is None:
                _totals[self.name] = [own, 1]
            else:
                total[0] += own
                total[1] += 1


def span_totals() -> dict[str, dict]:
    """{name: {"seconds": self seconds, "count": spans}} of every span
    closed with no profiler recording since the last reset_spans()."""
    with _totals_lock:
        return {name: {"seconds": ns / 1e9, "count": n} for name, (ns, n) in _totals.items()}


def reset_spans() -> None:
    with _totals_lock:
        _totals.clear()
