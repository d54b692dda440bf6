"""Nothing the benchmark loads imports JAX or the JAX package, compared by
whole top-level module name; without a card the benchmark refuses to run."""

import os
import subprocess
import sys

import torch

from benchh100_util import BENCH, FAST, ROOT

import harness  # noqa: E402

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import run, harness, system, reference, traffic, dpf_ref, check, peaks, devtrace, control
import pir_tpu_torch.server
spec = harness.load_spec({root!r})
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.reader(m["name"])
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_benchmark_process():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=BENCH, root=ROOT)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    top = set(out.stdout.split())
    assert "pir_tpu_torch" in top and "torch" in top
    assert not top & set(harness.FORBIDDEN)


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
