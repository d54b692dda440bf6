"""The traced window: ``torch.profiler`` over a few batches, reduced from
its Chrome trace to what the per-layer readers need.

The trace's device activity (kernels, copies, sets) gives the busy time
and the kernels by name; the benchmark's own spans (``bench.*``, made by
``record_function`` around each dispatch and each wait) and the host's
top-level operators say what the host was doing in each idle gap.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.traced"
SPAN_PREFIX = "bench."
NAME_CHARS = 96


@dataclass
class Summary:
    """A traced window: its length, the device's busy seconds, its device
    operations (short name, start, seconds; kernels marked), the idle
    gaps labelled by the host's activity, and the batches dispatched."""

    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)  # (name, start_s, seconds, is_kernel)
    gaps: list = field(default_factory=list)  # (label, seconds)
    batches: int = 0

    def kernels(self, part: str) -> list:
        """(name, start, seconds) of the kernels whose name holds `part`."""
        return [(n, t, d) for n, t, d, k in self.ops if k and part in n]

    def kernel_count(self) -> int:
        return sum(1 for op in self.ops if op[3])

    def breakdown(self, top: int = 10) -> dict:
        by_op, by_gap = defaultdict(float), defaultdict(float)
        for name, _, dur, _ in self.ops:
            by_op[name] += dur
        for label, dur in self.gaps:
            by_gap[label] += dur
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[n, s] for n, s in order(by_op)],
                "idle_gaps": [[n, s] for n, s in order(by_gap)]}


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(")[0].strip() or name or "(no name)")[:NAME_CHARS]


class Profiler:
    """Start and stop ``torch.profiler`` (CPU and CUDA activities) around
    the traced window; stop() returns its Summary."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self, batches: int) -> Summary:
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events, batches)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_level(events: list) -> list:
    """(start, end, name) of the events not nested inside another, sorted."""
    out = []
    for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
        end = e["ts"] + e.get("dur", 0)
        if out and e["ts"] < out[-1][1]:
            continue
        out.append((e["ts"], end, e["name"]))
    return out


def _covering(spans: list, starts: list, t: float):
    i = bisect.bisect_right(starts, t) - 1
    return spans[i][2] if i >= 0 and spans[i][1] > t else None


def summarize(events: list, batches: int) -> Summary:
    """Reduce a Chrome trace's events (times in microseconds) to a Summary
    of the WINDOW_SPAN annotation's interval."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    ops, busy = [], []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
        if b <= a:
            continue
        busy.append((a, b))
        ops.append((short_name(e["name"]), (a - t0) * 1e-6, (b - a) * 1e-6,
                    e["cat"] == "kernel"))
    merged = _merge(busy)
    busy_us = sum(b - a for a, b in merged)
    spans = _top_level([e for e in xs if e.get("cat") == "user_annotation"
                        and e["name"].startswith(SPAN_PREFIX) and e["name"] != WINDOW_SPAN])
    host_ops = _top_level([e for e in xs if e.get("cat") == "cpu_op"])
    span_starts, op_starts = [s[0] for s in spans], [o[0] for o in host_ops]
    gaps, edge = [], t0
    for a, b in merged + [[t1, t1]]:
        if a > edge:
            mid = (edge + a) / 2
            span = _covering(spans, span_starts, mid) or "front end"
            op = _covering(host_ops, op_starts, mid)
            gaps.append((f"{span}: {op}" if op else span, (a - edge) * 1e-6))
        edge = max(edge, b)
    return Summary((t1 - t0) * 1e-6, busy_us * 1e-6, ops, gaps, batches)
