"""pir_tpu_torch.benchmarks_overlap's plain versions vs the TPU probe.

The TPU probe's three Pallas kernels (benchmarks_overlap.py at the
repository root) run in interpret mode, as that script runs them on the
CPU (OVERLAP_INTERPRET=1, ITERS set on the module, its jitted functions
rebuilt); the port's plain versions must give equal words on the same
seeded inputs. mxu_chain is also held against the chain's closed form
acc_t = a @ b + bit_{t-1} x colsum(b), and the integer round against
Python integers at the words where shifts and wraps bite. The kernels
themselves run on the card (tests/test_torch_cuda.py).
"""

import json

import numpy as np
import pytest
import torch

import benchmarks_overlap as tpu_probe
from pir_tpu_torch import benchmarks_overlap as ov
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EDGE_WORDS = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9, 0x61C88647]


@pytest.fixture
def tpu_kernels(monkeypatch):
    """iters -> the TPU probe's (fa, fb, fc), interpreted on the CPU."""
    monkeypatch.setenv("OVERLAP_INTERPRET", "1")

    def at(iters):
        monkeypatch.setattr(tpu_probe, "ITERS", iters)
        tpu_probe.fns.cache_clear()
        return tpu_probe.fns()

    yield at
    tpu_probe.fns.cache_clear()


def _inputs(seed, edge=False):
    v, a, b = ov.make_inputs(seed)
    if edge:  # the edge words spread over v, and a byte of 127 that wraps when 1 is added
        v.view(-1)[: 7 * 64] = torch.tensor(np.array(EDGE_WORDS * 64, np.uint32).view(np.int32))
        a[::3, ::5] = 127
        a[1::3, ::7] = -128
    return v, a, b


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("iters", [1, 2, 5])
@pytest.mark.parametrize("edge", [False, True], ids=["seeded", "edge words"])
def test_plain_versions_equal_the_tpu_kernels(tpu_kernels, iters, edge):
    fa, fb, fc = tpu_kernels(iters)
    v, a, b = _inputs(iters, edge)
    vn, an, bn = _u32(v), a.numpy(), b.numpy()
    want_v = np.asarray(fa(vn))
    want_m = np.asarray(fb(an, bn))
    got_v, got_m = ov.vpu_chain(v, iters), ov.mxu_chain(a, b, iters)
    assert np.array_equal(_u32(got_v), want_v)
    assert np.array_equal(got_m.numpy(), want_m)
    mixed_v, mixed_m = (np.asarray(x) for x in fc(vn, an, bn))
    port_v, port_m = ov.mixed(v, a, b, iters)
    assert np.array_equal(_u32(port_v), mixed_v) and np.array_equal(port_m.numpy(), mixed_m)


def test_mxu_chain_equals_its_closed_form():
    """Each round adds one bit a row to a, so acc_t = P + bit_{t-1} colsum(b)
    with P = a @ b; only column 0 has to be followed round by round."""
    iters = ov.ITERS
    v, a, b = ov.make_inputs(0)
    p = a.to(torch.int64) @ b.to(torch.int64)
    colsum = b.to(torch.int64).sum(0)
    bit = torch.zeros(ov.M, dtype=torch.int64)
    for _ in range(iters - 1):
        bit = (p[:, 0] + bit * colsum[0]) & 1
    want = p + bit[:, None] * colsum[None, :]
    got = ov.mxu_chain(a, b, iters)
    assert torch.equal(got.to(torch.int64), want)
    assert int(want.abs().max()) < 1 << 26


def _round_py(x):
    c = ov.C
    for _ in range(4):
        x ^= (x << 1) & 0xFFFFFFFF
        x |= x >> 3
        x = (x & c) ^ ((x << 2) & 0xFFFFFFFF)
        x = (x + c) & 0xFFFFFFFF
    return x


@pytest.mark.parametrize("iters", [1, 3])
def test_vpu_chain_shifts_and_wraps_as_uint32(iters):
    v = torch.tensor(np.array(EDGE_WORDS, np.uint32).view(np.int32))
    want = []
    for x in EDGE_WORDS:
        for _ in range(iters):
            x = _round_py(x)
        want.append(x)
    assert _u32(ov.vpu_chain(v, iters)).tolist() == want


def test_wrappers_take_the_plain_versions_on_the_cpu():
    v, a, b = ov.make_inputs(1)
    before = (ov.vpu_probe.launches, ov.mxu_probe.launches, ov.mixed_probe.launches)
    assert torch.equal(ov.vpu_probe(v, 3), ov.vpu_chain(v, 3))
    assert torch.equal(ov.mxu_probe(a, b, 2), ov.mxu_chain(a, b, 2))
    got = ov.mixed_probe(v, a, b, 2)
    assert torch.equal(got[0], ov.vpu_chain(v, 2)) and torch.equal(got[1], ov.mxu_chain(a, b, 2))
    # a wrapper counts only the kernel's launches
    assert (ov.vpu_probe.launches, ov.mxu_probe.launches, ov.mixed_probe.launches) == before


def test_wrappers_reject_other_shapes_types_and_devices():
    v, a, b = ov.make_inputs(2)
    with pytest.raises(ValueError, match="must be a"):
        ov.vpu_probe(v[:, :256])
    with pytest.raises(ValueError, match="must be a"):
        ov.mxu_probe(a.to(torch.int32), b)
    with pytest.raises(ValueError, match="must be a"):
        ov.mixed_probe(v, a, b[:, :128])
    with pytest.raises(ValueError, match="different devices"):
        ov.mxu_probe(a, torch.empty(b.shape, dtype=b.dtype, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ov.streams(v, a, b, 1)


def test_the_probe_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ov.main(["--iters", "1", "--reps", "1"])
    assert ov.main(["--iters", "1", "--reps", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"vpu_ms", "mxu_ms", "mixed_ms", "overlap", "streams_ms",
            "streams_overlap", "max_active_clusters"} <= set(rec)
    assert rec["device"] == "cpu" and rec["streams_ms"] is None and rec["iters"] == 1
    assert rec["max_active_clusters"] is None
    with pytest.raises(ValueError, match="CUDA device"):
        ov.max_active_clusters("cpu")


def test_mixed_split_takes_the_plain_version_on_the_cpu():
    """Both placements of C have mixed as their plain version, and a CPU
    call counts no launch."""
    v, a, b = ov.make_inputs(4)
    before = (ov.mixed_probe.launches, ov.mixed_split_probe.launches)
    got = ov.mixed_split_probe(v, a, b, 3)
    want = ov.mixed(v, a, b, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (ov.mixed_probe.launches, ov.mixed_split_probe.launches) == before
    with pytest.raises(ValueError, match="must be a"):
        ov.mixed_split_probe(v, a, b[:, :128])
    with pytest.raises(ValueError, match="different devices"):
        ov.mixed_split_probe(v, a, torch.empty(b.shape, dtype=b.dtype, device="meta"))


def test_run_on_the_cpu_times_both_placements():
    rec = ov.run(2, 1, "cpu")
    assert {"mixed_ms", "mixed_split_ms", "overlap", "overlap_split"} <= set(rec)
    assert rec["overlap_split"] == ov.overlap_of(rec["vpu_ms"], rec["mxu_ms"],
                                                 rec["mixed_split_ms"])


def test_chain_floor_is_the_rounds_of_each_dependent_path():
    """A: a round of one element; B: CRIT_STEPS dependent products and a
    hop; C: the larger, in both placements; in ms."""
    lat = {"int_round": {"cycles": 150.0, "ns": 80.0},
           "wgmma_step": {"cycles": 30.0, "ns": 16.0},
           "dsmem_hop": {"cycles": 400.0, "ns": 210.0}}
    floor = ov.chain_floor_ms(lat, 1000)
    assert floor["vpu"] == pytest.approx(1000 * 80.0 * 1e-6)
    assert floor["mxu"] == pytest.approx(1000 * (ov.CRIT_STEPS * 16.0 + 210.0) * 1e-6)
    assert floor["mixed"] == floor["mixed_split"] == max(floor["vpu"], floor["mxu"])
    assert ov.CRIT_STEPS == ov.K // ov.CLUSTER // 32
    assert ov.chain_floor_ms(lat, 0) == {k: 0.0 for k in floor}


def test_chain_latencies_need_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        ov.chain_latencies("cpu")
