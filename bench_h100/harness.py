"""One run of one cell: set-up, the measured window, the traced window,
the comparison that decides ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by the name ``BENCHMARK.json`` gives it: ``configs/<name>.json``
(the path the configuration names), ``traffic/<name>.json`` and
``metrics/<name>.py`` (a reader: ``read(ctx)`` returns the metric's value,
or None when it finds nothing to read). A configuration names the files of
its protocol (``protocols/`` and ``systems/``), a mix those of its entry
(``entries/``) and its loop (``loops/``); see ``named``.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

import check
import named
import peaks
import traffic

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "pir_tpu")


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(spec: dict, key: str, name: str) -> dict:
    for entry in spec[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json names no {key[:-1]} {name!r}")


def load_cell(spec: dict, root: str, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of the cell `name`."""
    cell = find(spec, "workloads", name)
    with open(os.path.join(root, find(spec, "configs", cell["config"])["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return cell, config, mix


def metrics_of(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def reader(name: str):
    return named.module("metrics", name).read


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among `names` (the loaded modules by default)
    that are one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


@dataclass
class Stats:
    """What the front end saw over a stretch of the loop."""

    batches: int = 0
    queries: int = 0
    seconds: float = 0.0
    dispatch_s: float = 0.0
    wait_s: float = 0.0
    latencies: list = field(default_factory=list)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, wrap_entry=None, log=None, sizes=None, system=None) -> dict:
    """One run of cell `name`; returns the result line's dict. wrap_entry,
    if given, wraps the system's entry (the tests plant faults there);
    sizes, if given, updates the configuration and the mix (the tests
    shrink them to the CPU); system, if given, is a module with ``System``
    and ``answer_bytes`` that stands in for the configuration's
    ``systems/<protocol>.py`` (the control)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_spec(root)
    cell, config, mix = load_cell(spec, root, name)
    if sizes:
        config, mix = {**config, **sizes.get("config", {})}, {**mix, **sizes.get("mix", {})}
    dev = torch.device(device)
    protocol = named.module("protocols", config["protocol"])
    system = system or named.module("systems", config["protocol"])

    torch.zeros(1, device=dev)
    log(f"set-up: device ready at {time.perf_counter() - t_start:.3f} s")
    table = traffic.make_table(config, seed, dev).cpu().numpy()
    log(f"set-up: table at {time.perf_counter() - t_start:.3f} s")
    pool = protocol.make_pool(config, mix, seed, dev)
    draws = traffic.make_draws(mix, seed)
    sample = traffic.make_sample(mix, seed)
    log(f"set-up: query pool at {time.perf_counter() - t_start:.3f} s")
    sut = system.System(config, table, dev, seed, pool, sample)
    del table
    shares = sut.shares(pool, 0)
    batches = [[shares[i] for i in d] for d in draws]
    keep = [np.flatnonzero(np.isin(d, sample)) for d in draws]
    entry = sut.entry(mix["entry"])
    if wrap_entry is not None:
        entry = wrap_entry(entry)
    loop = named.module("loops", mix["loop"]).make(entry, batches, keep, mix,
                                                   system.answer_bytes)
    log(f"set-up: shares at {time.perf_counter() - t_start:.3f} s")
    gc.collect()
    gc.freeze()
    warm = Stats()
    for _ in range(mix["warmup_batches"]):
        loop.step(warm)
        log(f"set-up: warm-up batch at {time.perf_counter() - t_start:.3f} s")

    window = Stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        loop.step(window)
    window.seconds = time.perf_counter() - t0
    lat = sorted(window.latencies)
    log(f"window: {window.batches} batches, {window.queries} queries in {window.seconds:.3f} s; "
        f"dispatch {window.dispatch_s:.3f} s, wait {window.wait_s:.3f} s; batch s min "
        f"{lat[0]:.4f}, median {lat[len(lat) // 2]:.4f}, max {lat[-1]:.4f}" if lat else "")

    summary = None
    if traced:
        from torch.profiler import record_function

        from devtrace import Profiler

        prof = Profiler()
        sync(dev)
        prof.start()
        with record_function("bench.traced"):
            for _ in range(mix["trace_batches"]):
                loop.step(Stats(), record_function)
            sync(dev)
        summary = prof.stop(mix["trace_batches"])
    loop.drain()
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    kept, missing, attempted = loop.kept, loop.missing, loop.dispatched
    del loop, entry, batches, shares, sut
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = protocol.answers(config, seed, pool, sample, dev)
    checks = protocol.compare(kept, draws, sample, ref, missing)
    log(f"reference: {len(sample)} queries, {len(kept)} answers compared in "
        f"{time.perf_counter() - t_ref:.3f} s")

    ctx = SimpleNamespace(config=config, mix=mix, cell=cell, window=window, trace=summary,
                          peak_bytes=peak, setup_s=setup_s, peaks=peaks,
                          kernel_set=named.kernel_set)
    kind = "per_layer" if traced else "end_to_end"
    values = {}
    for m in metrics_of(spec, name, kind):
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": check.correct(checks), "attempted": attempted,
              "failed": checks["mismatched"]["value"] + checks["missing"]["value"],
              "metrics": values, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result
