"""Nothing the benchmark loads imports JAX or the JAX package, compared by
whole top-level module name, and no protocol file imports the program;
without a card the benchmark refuses to run."""

import os
import subprocess
import sys

import torch

from benchh100_util import BENCH, FAST, ROOT

import harness  # noqa: E402

PROBE = """
import json, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run, harness, system, traffic, dpf_ref, check, peaks, devtrace, control, named
import pir_tpu_torch.server
spec = harness.load_spec({root!r})
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.reader(m["name"])
for c in spec["configs"]:
    with open(os.path.join({root!r}, c["file"])) as f:
        protocol = json.load(f)["protocol"]
    named.module("protocols", protocol)
    named.module("systems", protocol)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
# every protocol file, loaded in a process of its own
PROTOCOLS = """
import glob, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
import named
names = [os.path.basename(p)[:-3] for p in glob.glob(os.path.join({bench!r}, "protocols", "*.py"))]
assert names
for name in names:
    named.module("protocols", name)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top(probe: str) -> set:
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", probe.format(bench=BENCH, root=ROOT)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    return set(out.stdout.split())


def test_no_jax_in_the_benchmark_process():
    top = _top(PROBE)
    assert "pir_tpu_torch" in top and "torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_protocols_import_nothing_of_the_program():
    top = _top(PROTOCOLS)
    assert "torch" in top
    assert "pir_tpu_torch" not in top and not top & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole():
    names = ["pir_tpu_torch", "pir_tpu_torch.server", "jaxtyping", "flaxen.x", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["pir_tpu.server", "jax"]) == ["jax", "pir_tpu"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", FAST,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
