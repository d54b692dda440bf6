"""On the card: a short run of each cell through run.py comes out correct
and prints the contract's last line. Skipped without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchh100_util import BENCH, ROOT

import harness  # noqa: E402


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", [c["name"] for c in harness.load_spec(ROOT)["workloads"]])
def test_short_run_on_the_card(card, cell, traced):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
                          "--seed", str(2**31 + 101), "--seconds", "3", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
