"""pir_tpu_torch and chip_smoke.py stand alone: no JAX, no cryptography,
nothing of pir_tpu; and chip_smoke.py refuses to run without a card."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "cryptography", "pir_tpu"}
PORT_FILES = sorted((ROOT / "pir_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# every module of the port's slices so far; each must be among PORT_FILES
SLICE_MODULES = [
    "pir_tpu_torch/dpf/device.py", "pir_tpu_torch/dpf/host.py", "pir_tpu_torch/query.py",
    "pir_tpu_torch/state.py", "pir_tpu_torch/server.py", "pir_tpu_torch/utils/bits.py",
    "pir_tpu_torch/ops/expand.py", "pir_tpu_torch/ops/packed_scan.py",
    "pir_tpu_torch/ops/compat_stage.py", "pir_tpu_torch/models/pipeline.py",
    "pir_tpu_torch/ops/fast_tail.py", "pir_tpu_torch/ops/fused.py",
    "pir_tpu_torch/ops/xor_scan.py", "pir_tpu_torch/ops/scan.py", "pir_tpu_torch/entry.py",
    "pir_tpu_torch/ops/planes_scan.py", "pir_tpu_torch/ops/matmul_scan.py",
    "pir_tpu_torch/keyword.py", "pir_tpu_torch/database.py", "pir_tpu_torch/slot.py",
    "pir_tpu_torch/benchmarks_overlap.py", "pir_tpu_torch/wire.py",
    "pir_tpu_torch/commitment.py", "pir_tpu_torch/aspir.py", "pir_tpu_torch/aspir_shared.py",
    "pir_tpu_torch/encrypted.py", "pir_tpu_torch/config.py", "pir_tpu_torch/service.py",
    "pir_tpu_torch/demo.py", "pir_tpu_torch/crypto/paillier.py",
    "pir_tpu_torch/utils/metrics.py", "pir_tpu_torch/crypto/mont.py",
    "pir_tpu_torch/benchmarks_paillier.py", "pir_tpu_torch/parallel/__init__.py",
    "pir_tpu_torch/parallel/mesh.py", "pir_tpu_torch/native/__init__.py",
]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_nothing_forbidden(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_the_slices_modules_are_all_checked():
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert set(SLICE_MODULES) <= checked


def test_importing_the_port_loads_nothing_forbidden():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES if p.name != "chip_smoke.py"]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py runs for real there")
    out = _run_smoke(ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
