"""The protocol seam holds for a protocol that is not DPF: a toy protocol, a
plain index read whose answer is the row asked for, runs through
``harness.run_cell`` from files of its own (``protocols/toy.py`` and
``systems/toy.py`` in a directory of the test's), while the cell's entry,
loop and metrics are found where they are. A sound run comes out correct;
one wrong byte, or the control, does not."""

import textwrap

import pytest

from benchh100_util import COMPAT, ROOT, SIZES

import control  # noqa: E402
import harness  # noqa: E402
import named  # noqa: E402
import system  # noqa: E402

TOY_PROTOCOL = '''
"""toy: an index read in the clear; the answer is the row asked for."""

from dataclasses import dataclass

import numpy as np
import torch

import traffic

CONFIG_KEYS = ("rows", "row_bytes")
SERVED = "rows"
LIMITS = {"mismatched": (0, "max"), "missing": (0, "max"), "checked": (1, "min")}


@dataclass
class Pool:
    targets: np.ndarray


def make_pool(config, mix, seed, device):
    return Pool(traffic.rng(seed, "targets").integers(0, config["rows"], mix["pool"]))


def answers(config, seed, pool, idx, device, broken=False):
    table = traffic.make_table(config, seed, device)
    if broken:
        table[:, -1] ^= 1
    return {"rows": table[torch.from_numpy(pool.targets[idx])].cpu().numpy()}


def compare(kept, draws, sample, ref, missing):
    bad = sum(not np.array_equal(np.frombuffer(a, np.uint8),
                                 ref["rows"][np.searchsorted(sample, draws[d][p])])
              for d, p, a in kept)
    values = {"mismatched": bad, "missing": missing, "checked": len(kept)}
    return {k: {"value": v, "limit": LIMITS[k][0], "rule": LIMITS[k][1]}
            for k, v in values.items()}
'''

TOY_SYSTEM = '''
"""toy: a server that reads the row asked for, in the batch API's shape."""

import named


class Server:
    def __init__(self, table):
        self.table = table

    def private_secret_shared_query_batch_async(self, batch):
        rows = [self.table[i].copy() for i in batch]
        return lambda: rows


class System:
    def __init__(self, config, table, device, seed, pool, sample):
        self.server = Server(table)

    def shares(self, pool, server=0):
        return [int(t) for t in pool.targets]

    def entry(self, name):
        return named.module("entries", name).make(self.server)


def answer_bytes(result):
    return result.tobytes()
'''


class WrongByte(system.Entry):
    """The toy's entry with the first answer of every batch one byte off."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def dispatch(self, batch):
        self.inner.dispatch(batch)

    @staticmethod
    def _broken(res: list) -> list:
        res[0] = res[0].copy()
        res[0][0] ^= 1
        return res

    def take(self):
        return self._broken(self.inner.take())

    def drain(self):
        return [self._broken(r) for r in self.inner.drain()]


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """named finds the toy's protocol and system files under tmp_path, and
    every other kind where it is."""
    for kind, src in (("protocols", TOY_PROTOCOL), ("systems", TOY_SYSTEM)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / "toy.py").write_text(textwrap.dedent(src))
    real = named.module

    def module(kind, name, root=named.HERE):
        return real(kind, name, str(tmp_path) if kind in ("protocols", "systems") else root)

    monkeypatch.setattr(named, "module", module)
    return {"config": {"protocol": "toy", "rows": 512, "row_bytes": 8},
            "mix": SIZES[COMPAT]["mix"]}


def _run(sizes, **kw) -> dict:
    import time

    return harness.run_cell(ROOT, COMPAT, 2**31 + 41, 0.5, False, "cpu", time.perf_counter(),
                            log=lambda msg: None, sizes=sizes, **kw)


def test_a_sound_toy_run_is_correct(toy):
    res = _run(toy)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"mismatched", "missing", "checked"}
    assert res["checks"]["checked"]["value"] > 0
    assert {"qps", "batch_p90_ms", "setup_s"} <= set(res["metrics"])


def test_a_wrong_byte_in_a_toy_run_is_not_correct(toy):
    res = _run(toy, wrap_entry=WrongByte)
    assert res["correct"] is False
    assert res["checks"]["mismatched"]["value"] > 0 and res["failed"] > 0


def test_the_toy_control_is_not_correct(toy, monkeypatch):
    monkeypatch.setattr(control.System, "period", 0.01)
    res = _run(toy, system=control)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["mismatched"]["value"] == checks["checked"]["value"] > 0

