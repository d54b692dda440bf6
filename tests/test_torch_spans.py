"""pir_tpu_torch.utils.metrics' span recorder, and its spans on the batch
paths of TorchPirServer on the CPU.

The recorder: self time of nested spans (a stepped clock), child spans
inheriting the batch number, exact counts from 8 threads, no
record_function range with no profiler, and while a CPU torch.profiler
records no totals but ``pir.*`` user_annotation ranges named with their
batch number. The server: a fast batch and a compat batch through
``private_secret_shared_query_batch_async`` and two batches through
``fast_serving_stream()`` count each of ``pir.dispatch``, ``pir.payload``,
``pir.head``, ``pir.expand``, ``pir.scan``, ``pir.answers.copy`` and
``pir.answers.slice`` once a batch and ``pir.table`` once across
batches, and both servers' answers still recover every row.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pir_tpu_torch import _build
from pir_tpu_torch import query as tq
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import database_from_numpy
from pir_tpu_torch.utils import metrics
from pir_tpu_torch.utils.metrics import next_batch, reset_spans, span, span_totals
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEIGHT = 1 << 12  # fast keys of 128-bit leaves: depth 5, the root path's least
SLOT = 8
BATCH = 16
BATCH_SPANS = ("pir.dispatch", "pir.payload", "pir.head", "pir.expand", "pir.scan",
               "pir.answers.copy", "pir.answers.slice")


@pytest.fixture(autouse=True)
def clean_totals():
    reset_spans()
    yield
    reset_spans()


def _counts():
    return {name: t["count"] for name, t in span_totals().items()}


def test_self_time_of_nested_spans(monkeypatch):
    """A span's total is its duration less its children's on its thread;
    a grandchild is subtracted from its parent only."""
    ticks = iter(range(0, 10_000, 1000))  # each clock read 1000 ns later
    monkeypatch.setattr(metrics, "_clock", lambda: next(ticks))
    with span("pir.a"):  # t0 = 0
        with span("pir.b"):  # 1000
            with span("pir.c"):  # 2000
                pass  # c ends at 3000: 1000
        # b ends at 4000: 3000 less c's 1000
        with span("pir.b"):  # 5000
            pass  # 6000: 1000
    # a ends at 7000: 7000 less b's 3000 and 1000
    t = span_totals()
    assert t == {"pir.c": {"seconds": 1e-6, "count": 1},
                 "pir.b": {"seconds": 3e-6, "count": 2},
                 "pir.a": {"seconds": 3e-6, "count": 1}}


def test_children_inherit_the_batch_number_and_reset_clears():
    n = next_batch()
    assert next_batch() == n + 1
    with span("pir.a", n) as a:
        with span("pir.b") as b:
            with span("pir.c", "lib") as c:
                pass
    assert (a.arg, b.arg, c.arg) == (n, n, "lib")
    with span("pir.d") as d:
        pass
    assert d.arg is None
    snap = span_totals()
    snap["pir.a"]["count"] = 99  # a snapshot, not the totals
    assert _counts() == {"pir.a": 1, "pir.b": 1, "pir.c": 1, "pir.d": 1}
    reset_spans()
    assert span_totals() == {}


def test_exact_counts_from_eight_threads():
    """8 threads nest spans at once: every count is exact, and no
    thread's children are taken from another thread's spans."""
    go = threading.Barrier(8)

    def work():
        go.wait()
        for _ in range(500):
            with span("pir.outer"):
                with span("pir.inner"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads inside the spans' updates
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    t = span_totals()
    assert (t["pir.outer"]["count"], t["pir.inner"]["count"]) == (4000, 4000)
    assert t["pir.outer"]["seconds"] >= 0 and t["pir.inner"]["seconds"] >= 0


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("pir.a", 3):
        with span("pir.b"):
            pass
    assert _counts() == {"pir.a": 1, "pir.b": 1}


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("pir.")]


def test_profiled_spans_are_ranges_and_add_no_totals(tmp_path):
    with span("pir.before"):
        pass
    before = span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("pir.a", 41):
            with span("pir.b"):
                torch.ones(8).sum()
        with span("pir.c"):
            pass
    assert span_totals() == before
    names = sorted(e["name"] for e in _trace_events(prof, tmp_path))
    assert names == ["pir.a#41", "pir.b#41", "pir.c"]


def _db():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(HEIGHT, SLOT), dtype=np.uint8)
    return data, database_from_numpy(data, SLOT)


def _pairs(db, seed, fast):
    rng = np.random.default_rng(seed)
    idxs = [int(i) for i in rng.integers(0, HEIGHT, size=BATCH)]
    pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=fast,
                                            leaf_bits=128 if fast else None,
                                            rand_bytes=rng.bytes)
    return idxs, pairs


def _check_rows(data, idxs, res0, res1):
    for i, idx in enumerate(idxs):
        rec = tq.recover([res0[i], res1[i]])
        assert bytes(rec[0].data) == data[idx].tobytes()


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "compat"])
def test_batch_async_counts_each_span_once_a_batch(fast):
    data, db = _db()
    servers = [TorchPirServer(db, device="cpu") for _ in range(2)]
    for b in range(2):
        idxs, pairs = _pairs(db, 10 + b, fast)
        futs = [srv.private_secret_shared_query_batch_async([p[part] for p in pairs])
                for part, srv in enumerate(servers)]
        _check_rows(data, idxs, *[f() for f in futs])
    counts = _counts()
    assert {n: counts.get(n) for n in BATCH_SPANS} == {n: 4 for n in BATCH_SPANS}
    assert counts["pir.table"] == 2  # one storage table a server
    assert set(counts) == set(BATCH_SPANS) | {"pir.table"}


def test_stream_counts_each_span_once_a_batch():
    data, db = _db()
    servers = [TorchPirServer(db, device="cpu") for _ in range(2)]
    batches = [_pairs(db, 20 + b, True) for b in range(2)]
    res = []
    for part, srv in enumerate(servers):
        stream = srv.fast_serving_stream()
        futs = [stream.submit([p[part] for p in pairs]) for _, pairs in batches]
        assert futs[0] is None
        res.append([futs[1](), stream.flush()()])
    for b, (idxs, _) in enumerate(batches):
        _check_rows(data, idxs, res[0][b], res[1][b])
    counts = _counts()
    assert {n: counts.get(n) for n in BATCH_SPANS} == {n: 4 for n in BATCH_SPANS}
    assert counts["pir.table"] == 2


def test_one_batch_shares_its_number_in_the_trace(tmp_path):
    """Under a CPU profiler a batch's dispatch spans and answer spans carry
    one batch number, the next batch another; no totals are added."""
    data, db = _db()
    srv = TorchPirServer(db, device="cpu")
    shares = [[p[0] for p in _pairs(db, 30 + b, True)[1]] for b in range(2)]
    srv.private_secret_shared_query_batch(shares[0])  # builds the table unprofiled
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for s in shares:
            srv.private_secret_shared_query_batch(s)
    assert span_totals() == {}
    by_batch = {}
    for e in _trace_events(prof, tmp_path):
        name, batch = e["name"].split("#")
        by_batch.setdefault(int(batch), []).append(name)
    assert len(by_batch) == 2
    for names in by_batch.values():
        assert sorted(names) == sorted(BATCH_SPANS)


def test_kernel_load_spans_a_miss_only(monkeypatch, tmp_path):
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_lib_path", lambda name: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    first = _build.load("fake")
    assert _build.load("fake") is first
    assert _counts() == {"pir.kernel_load": 1}
