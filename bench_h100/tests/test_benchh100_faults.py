"""The comparison that decides ``correct`` catches what it is there for: a
whole run on the CPU at a small size (the harness's look for a card
skipped), once sound, once with the timed path broken underneath it in
each way a cell of this benchmark can break, and once with the control
(the reference in the program's place, its rows one byte narrower) in
the program's place."""

import pytest
import torch

from benchh100_util import COMPAT, FAST, run_small

import control  # noqa: E402
import system  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Faulty(system.Entry):
    """The system's entry with one fault planted where its answers are made."""

    def __init__(self, inner, fault: str):
        super().__init__()
        self.inner, self.fault, self.last = inner, fault, None

    def dispatch(self, batch):
        self.inner.dispatch(batch)

    def _broken(self, res: list) -> list:
        if self.fault == "stale":  # the step hands back its previous state
            prev, self.last = self.last, res
            return prev if prev is not None else res
        if self.fault == "half":  # half the batch left out, answered from the rest
            half = len(res) // 2
            return res[:half] + res[:len(res) - half]
        if self.fault == "altered":  # one answer altered where it is made
            res[0].shares[0].data[0] ^= 1
            return res
        raise ValueError(self.fault)

    def take(self):
        return self._broken(self.inner.take())

    def drain(self):
        return [self._broken(r) for r in self.inner.drain()]


@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_a_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"] is True
    checks = res["checks"]
    assert checks["checked"]["value"] > 0
    assert all(checks[k]["value"] == 0 for k in ("mismatched", "unrecovered", "missing"))


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_a_fault_is_not_correct(cell, fault):
    res = run_small(cell, wrap_entry=lambda e: Faulty(e, fault))
    assert res["correct"] is False
    assert res["checks"]["mismatched"]["value"] > 0 and res["failed"] > 0


@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_the_control_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(control.System, "period", 0.01)
    res = run_small(cell, seconds=0.3, system=control)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["mismatched"]["value"] == checks["checked"]["value"] > 0
