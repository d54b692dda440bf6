"""closed: the closed-loop front end. It dispatches the next batch as soon
as fewer than the mix's ``in_flight`` are out, then takes the oldest
batch's answers.

A loop keeps, for the comparison, the answers at the positions ``keep`` of
each draw (``kept``: (draw, position, answer bytes), the bytes by the
``answer_bytes`` of the system that answered), counts the queries
dispatched (``dispatched``) and those never answered (``missing``).
``step(stats, span)`` serves one step of the loop into ``stats``
(harness.Stats), with ``span(name)`` a context around each call into the
system; ``drain()`` takes what is left at the end.
"""

import contextlib
import time
from collections import deque


class Loop:
    def __init__(self, entry, batches: list, keep: list, in_flight: int, answer_bytes):
        self.entry, self.batches, self.keep = entry, batches, keep
        self.in_flight, self.answer_bytes = in_flight, answer_bytes
        self.k = 0
        self.pending = deque()  # (batch number, dispatch time)
        self.kept = []
        self.missing = 0
        self.dispatched = 0

    def step(self, stats, span=None) -> None:
        span = span or (lambda name: contextlib.nullcontext())
        k = self.k
        t0 = time.perf_counter()
        with span("bench.dispatch"):
            self.entry.dispatch(self.batches[k % len(self.batches)])
        stats.dispatch_s += time.perf_counter() - t0
        self.pending.append((k, t0))
        self.k += 1
        self.dispatched += len(self.batches[k % len(self.batches)])
        while len(self.pending) >= self.in_flight:
            kb, td = self.pending.popleft()
            t1 = time.perf_counter()
            with span("bench.wait"):
                res = self.entry.take()
            t2 = time.perf_counter()
            stats.wait_s += t2 - t1
            stats.latencies.append(t2 - td)
            stats.batches += 1
            stats.queries += len(self.batches[kb % len(self.batches)])
            self.record(kb, res)

    def record(self, k: int, res: list) -> None:
        d = k % len(self.batches)
        self.missing += max(0, len(self.batches[d]) - len(res))
        for pos in self.keep[d]:
            if pos < len(res):
                self.kept.append((d, int(pos), self.answer_bytes(res[pos])))

    def drain(self) -> None:
        results = self.entry.drain()
        for i, (k, _) in enumerate(self.pending):
            if i < len(results):
                self.record(k, results[i])
            else:
                self.missing += len(self.batches[k % len(self.batches)])
        self.pending.clear()


def make(entry, batches: list, keep: list, mix: dict, answer_bytes) -> Loop:
    return Loop(entry, batches, keep, mix["in_flight"], answer_bytes)
