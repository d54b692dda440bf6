"""The traffic generator: one seed, the same bytes; another seed, others;
every seed the same sizes."""

import numpy as np
import pytest
import torch

from benchh100_util import COMPAT, FAST, ROOT, SIZES

import harness  # noqa: E402
import named  # noqa: E402
import traffic  # noqa: E402

SPEC = harness.load_spec(ROOT)


def _inputs(cell: str, seed: int):
    _, config, mix = harness.load_cell(SPEC, ROOT, cell)
    config, mix = {**config, **SIZES[cell]["config"]}, {**mix, **SIZES[cell]["mix"]}
    pool = named.module("protocols", config["protocol"]).make_pool(config, mix, seed, "cpu")
    return (traffic.make_table(config, seed, "cpu").numpy(), pool,
            traffic.make_draws(mix, seed), traffic.make_sample(mix, seed), mix)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_same_seed_same_bytes(cell, seed):
    a, b = _inputs(cell, seed), _inputs(cell, seed)
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1].targets, b[1].targets) and a[1].prf_keys == b[1].prf_keys
    for k in a[1].keys:
        assert np.array_equal(a[1].keys[k], b[1].keys[k])
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))
    assert np.array_equal(a[3], b[3])


@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_other_seed_other_bytes_same_sizes(cell):
    a, b = _inputs(cell, 2**31 + 1), _inputs(cell, 2**31 + 2)
    assert not np.array_equal(a[0], b[0])
    assert a[1].prf_keys != b[1].prf_keys
    assert not np.array_equal(a[1].keys["s0"], b[1].keys["s0"])
    mix = a[4]
    for x in (a, b):
        assert x[0].shape == (SIZES[cell]["config"]["rows"], SIZES[cell]["config"]["row_bytes"])
        assert len(x[2]) == mix["draws"]
        assert all(len(d) == mix["batch"] and len(set(d.tolist())) == mix["batch"] for d in x[2])
        assert len(x[3]) == mix["check_queries"] and len(set(x[3].tolist())) == len(x[3])
        assert len(x[1].targets) == mix["pool"]


def test_table_on_the_generator_of_its_device():
    config = {"rows": 64, "row_bytes": 8}
    t = traffic.make_table(config, 5, "cpu")
    assert t.dtype == torch.uint8 and t.device.type == "cpu" and t.shape == (64, 8)
