"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds for it."""

import json
import os
import re

import pytest

from benchh100_util import COMPAT, FAST, ROOT, run_small

import harness  # noqa: E402
import named  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec(ROOT)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench_h100/run.py"]
    assert SPEC["paths"] == ["bench_h100"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("bench_h100/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"] and len(entry["source"]) <= 200
    assert config["reduced"] == entry["reduced"] == []
    # the protocol's files, and what its configurations state
    protocol = named.module("protocols", config["protocol"])
    assert callable(named.module("systems", config["protocol"]).System)
    assert set(protocol.CONFIG_KEYS) <= set(config)
    assert all(type(config[k]) is int and config[k] > 0 for k in ("rows", "row_bytes"))
    if config["protocol"] == "dpf2":
        assert config["keys"] in ("fast", "compat")
        if config["keys"] == "fast":
            assert type(config["leaf_bits"]) is int and config["leaf_bits"] % 128 == 0


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    _, config, mix = harness.load_cell(SPEC, ROOT, cell["name"])
    assert config["name"] == cell["config"]
    assert callable(named.module("entries", mix["entry"]).make)
    assert callable(named.module("loops", mix["loop"]).make)
    assert mix.get("clients", 1) >= 1
    assert mix["pool"] >= 2 * mix["batch"] and mix["in_flight"] >= 2
    for kind in ("end_to_end", "per_layer"):
        assert harness.metrics_of(SPEC, cell["name"], kind)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert metric["layer"] in ("server shell", "pipeline", "kernels", "device")
    if metric["name"].endswith("roofline"):
        assert metric["unit"] == "%"


def test_kernel_sets():
    assert named.kernel_set("aes") == ["compat_stage_kernel", "stacked_tail_kernel"]


def test_unknown_file_is_refused():
    with pytest.raises(KeyError):
        named.module("entries", "no_such_entry")


def test_setup_metric():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_result_line(cell, traced):
    res = run_small(cell, seconds=1.5 if traced else 4.0, traced=traced)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in harness.metrics_of(SPEC, cell, kind)}
    assert set(res["metrics"]) <= names
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"qps", "batch_p90_ms", "setup_s"} <= set(res["metrics"])
    assert json.loads(json.dumps(res)) == res
