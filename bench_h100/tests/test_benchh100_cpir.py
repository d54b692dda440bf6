"""The cPIR protocol of the benchmark (``protocols/cpir.py``,
``systems/cpir.py``, the ``cpir-sqrt-1mx3b.q8`` cell) on the CPU at a
small size (2^10 slots of 3 B as a 32 x 32 grid, 128-bit keys): the plain
reference's answers equal the port's byte for byte; the pool's ebits
decrypt to one-hot rows at their targets; a run of the cell is correct,
one with a wrong byte or with the control in the program's place is not;
the seven readers of the cell give known values from known spans and a
known trace."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchh100_util import ROOT

import control  # noqa: E402
import harness  # noqa: E402
import named  # noqa: E402
import peaks  # noqa: E402
import system  # noqa: E402
import traffic  # noqa: E402

CPIR = named.module("protocols", "cpir")
CELL = "cpir-sqrt-1mx3b.q8"
SIZES = {"config": {"rows": 1 << 10, "key_bits": 128, "grid_height": 32, "grid_width": 32},
         "mix": {"batch": 2, "pool": 4, "draws": 4, "check_queries": 2, "warmup_batches": 1,
                 "trace_batches": 2}}
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small():
    _, config, mix = harness.load_cell(harness.load_spec(ROOT), ROOT, CELL)
    return {**config, **SIZES["config"]}, {**mix, **SIZES["mix"]}


def _run(seconds: float = 0.3, traced: bool = False, **kw) -> dict:
    import time

    return harness.run_cell(ROOT, CELL, SEED, seconds, traced, "cpu", time.perf_counter(),
                            log=lambda msg: None, sizes=SIZES, **kw)


def test_the_reference_equals_the_port_byte_for_byte():
    config, mix = _small()
    pool = CPIR.make_pool(config, mix, SEED, "cpu")
    table = traffic.make_table(config, SEED, "cpu").numpy()
    sut_mod = named.module("systems", "cpir")
    sut = sut_mod.System(config, table, "cpu")
    idx = np.array([0, 3])
    got = sut.server.private_encrypted_query_batch_async([sut.shares(pool)[i] for i in idx])()
    ref = CPIR.answers(config, SEED, pool, idx, "cpu")
    assert ref[CPIR.SERVED].shape == (2, 32 * 32)  # 32 columns of 32-byte ciphertexts
    for i, res in enumerate(got):
        assert np.array_equal(np.frombuffer(sut_mod.answer_bytes(res), np.uint8),
                              ref[CPIR.SERVED][i])
    assert np.array_equal(ref["rows"], table[pool.targets[idx]])
    broken = CPIR.answers(config, SEED, pool, idx, "cpu", broken=True)
    assert all(not np.array_equal(a, b) for a, b in zip(broken[CPIR.SERVED], ref[CPIR.SERVED]))


def test_the_ebits_decrypt_one_hot_under_each_clients_key():
    config, mix = _small()
    pool = CPIR.make_pool(config, mix, SEED, "cpu")
    assert len(set(pool.primes)) == mix["clients"] == 4
    for i in range(mix["pool"]):
        p, q = pool.primes[int(pool.client[i])]
        assert (p * q).bit_length() == config["key_bits"]
        t_row = int(pool.targets[i]) // config["grid_width"]
        assert [CPIR.decrypt(c, p, q) for c in pool.ebits[i]] == [
            int(r == t_row) for r in range(config["grid_height"])]
    again = CPIR.make_pool(config, mix, SEED, "cpu")
    assert again.ebits == pool.ebits and again.primes == pool.primes


def test_primes():
    assert all(CPIR.is_probable_prime(p) for p in (2, 3, 1999, 2**61 - 1, 2**127 - 1))
    assert not any(CPIR.is_probable_prime(x) for x in (0, 1, 561, 2**61 + 1, 3215031751,
                                                        (2**61 - 1) * (2**31 - 1)))
    r = np.random.default_rng(1)
    p = CPIR.make_prime(r, 64)
    assert p.bit_length() == 64 and p >> 62 == 3 and CPIR.is_probable_prime(p)


def test_a_sound_run_is_correct():
    res = _run(seconds=3.0)
    assert res["correct"] is True, res["checks"]
    checks = res["checks"]
    assert checks["checked"]["value"] > 0
    assert all(checks[k]["value"] == 0 for k in ("mismatched", "unrecovered", "missing"))
    assert {"qps", "batch_p90_ms", "setup_s"} <= set(res["metrics"])


def test_a_traced_run_reports_the_host_spans():
    res = _run(traced=True)
    host = {"cpir.shell_ms", "cpir.bases_ms", "cpir.scan_ms", "cpir.copy_ms",
            "cpir.results_ms", "cpir.table_build_s"}
    assert res["correct"] is True
    assert host <= set(res["metrics"]) <= {m["name"] for m in harness.metrics_of(
        harness.load_spec(ROOT), CELL, "per_layer")}
    assert all(res["metrics"][n]["value"] >= 0 for n in host)
    assert "mont_scan_roofline" not in res["metrics"]  # the CPU runs no kernel


class WrongByte(system.Entry):
    """The system's entry with one ciphertext of each first answer off by one."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def dispatch(self, batch):
        self.inner.dispatch(batch)

    @staticmethod
    def _broken(res: list) -> list:
        ct = res[0].slots[0].cts[0]
        res[0].slots[0].cts[0] = type(ct)(ct.c ^ 1, ct.level)
        return res

    def take(self):
        return self._broken(self.inner.take())

    def drain(self):
        return [self._broken(r) for r in self.inner.drain()]


def test_a_wrong_byte_is_not_correct():
    res = _run(wrap_entry=WrongByte)
    assert res["correct"] is False
    assert res["checks"]["mismatched"]["value"] > 0 and res["failed"] > 0


def test_the_control_is_not_correct(monkeypatch):
    monkeypatch.setattr(control.System, "period", 0.01)
    res = _run(system=control)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["mismatched"]["value"] == checks["checked"]["value"] > 0
    assert checks["unrecovered"]["value"] > 0


SNAPSHOT = {
    "pir.dispatch": {"seconds": 0.01, "count": 100},
    "pir.cpir.bases": {"seconds": 0.7, "count": 100},
    "pir.cpir.scan": {"seconds": 0.55, "count": 100},
    "pir.answers.copy": {"seconds": 10.8, "count": 100},
    "pir.cpir.results": {"seconds": 1.4, "count": 100},
    "pir.table": {"seconds": 0.048, "count": 1},
}
READINGS = {
    "cpir.shell_ms": 0.1,
    "cpir.bases_ms": 7.0,
    "cpir.scan_ms": 5.5,
    "cpir.copy_ms": 108.0,
    "cpir.results_ms": 14.0,
    "cpir.table_build_s": 0.048,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_readers_from_a_known_snapshot(monkeypatch, name):
    from pir_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "span_totals", lambda: {k: dict(v) for k, v in SNAPSHOT.items()})
    assert harness.reader(name)(None) == pytest.approx(READINGS[name])
    monkeypatch.setattr(metrics, "span_totals", lambda: {})
    assert harness.reader(name)(None) is None


def _trace(kernels: list, batches: int = 12):
    return SimpleNamespace(batches=batches, kernels=lambda part: [
        (n, 0.0, d) for n, d in kernels if part in n])


def test_the_roofline_from_a_known_trace():
    _, config, mix = harness.load_cell(harness.load_spec(ROOT), ROOT, CELL)
    read = harness.reader("mont_scan_roofline")
    roof = named.module("metrics", "mont_scan_roofline")
    # the least products and seconds of one query of the cell (PERF.md)
    assert roof.least_products(1024, 1024, 24) == 3_433_472
    assert roof.query_s(config, peaks.INT32_OPS_PER_S) == pytest.approx(3.3847e-3, rel=1e-4)
    from pir_tpu_torch.crypto.mont import least_scan_products

    assert roof.least_products(1024, 1024, 24) == least_scan_products(1024, 1024, 24)
    # 12 batches of 8 queries, 14.5 ms of the set's kernels each, a kernel outside it
    per = 14.5e-3 / 3
    ks = [("mont_table_kernel<8>", 12 * 8 * per), ("mont_scan_kernel<8, 512>", 12 * 8 * per),
          ("mont_merge_kernel<8>", 12 * 8 * per), ("at::native::CatArrayBatchedCopy", 1.0)]
    ctx = SimpleNamespace(config=config, mix=mix, trace=_trace(ks), peaks=peaks,
                          kernel_set=named.kernel_set)
    assert read(ctx) == pytest.approx(100 * 3.3847 / 14.5, rel=1e-4)
    assert read(SimpleNamespace(**{**vars(ctx), "trace": _trace(ks[3:])})) is None
    assert read(SimpleNamespace(**{**vars(ctx), "trace": None})) is None
    assert named.kernel_set("mont") == ["mont_merge_kernel", "mont_scan_kernel",
                                        "mont_table_kernel"]
