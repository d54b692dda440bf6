"""The readers of the program's spans (``program_spans``): each per-layer
metric from a known snapshot of ``span_totals()``, None when its span, or
the batches' root span, never ran, and None from a program without the
recorder; a small traced run on the CPU reports all nine but the kernels'
load (the CPU runs no kernel library)."""

import builtins

import pytest

from benchh100_util import COMPAT, FAST, run_small

import harness  # noqa: E402
import program_spans  # noqa: E402

SNAPSHOT = {
    "pir.dispatch": {"seconds": 0.8, "count": 100},
    "pir.payload": {"seconds": 6.0, "count": 100},
    "pir.head": {"seconds": 10.0, "count": 100},
    "pir.expand": {"seconds": 0.2, "count": 100},
    "pir.scan": {"seconds": 0.3, "count": 100},
    "pir.answers.copy": {"seconds": 2.5, "count": 100},
    "pir.answers.slice": {"seconds": 0.4, "count": 100},
    "pir.table": {"seconds": 1.5, "count": 1},
    "pir.kernel_load": {"seconds": 0.25, "count": 3},
}
READINGS = {
    "server.shell_ms": 8.0,
    "server.payload_ms": 60.0,
    "pipeline.head_ms": 100.0,
    "pipeline.expand_ms": 2.0,
    "pipeline.scan_ms": 3.0,
    "server.copy_ms": 25.0,
    "server.results_ms": 4.0,
    "server.table_build_s": 1.5,
    "kernels.load_s": 0.25,
}


def _totals(monkeypatch, snap):
    from pir_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "span_totals", lambda: {k: dict(v) for k, v in snap.items()})


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reading_from_a_known_snapshot(monkeypatch, name):
    _totals(monkeypatch, SNAPSHOT)
    assert harness.reader(name)(None) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_none_with_no_spans(monkeypatch, name):
    _totals(monkeypatch, {})
    assert harness.reader(name)(None) is None


def test_per_batch_needs_the_root_span(monkeypatch):
    _totals(monkeypatch, {k: v for k, v in SNAPSHOT.items() if k != "pir.dispatch"})
    assert harness.reader("pipeline.head_ms")(None) is None
    assert harness.reader("server.table_build_s")(None) == pytest.approx(1.5)


def test_none_from_a_program_without_the_recorder(monkeypatch):
    real = builtins.__import__

    def refuse(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "pir_tpu_torch.utils.metrics" and "span_totals" in (fromlist or ()):
            raise ImportError("cannot import name 'span_totals'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", refuse)
    assert program_spans.totals() == {}
    assert harness.reader("server.shell_ms")(None) is None


@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_a_traced_run_reports_the_host_spans(cell):
    res = run_small(cell, seconds=1.0, traced=True)
    host = set(READINGS) - {"kernels.load_s"}
    assert host <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] >= 0 for n in host)
