"""The cells' inputs and the reference's answers, frozen: for each cell at
its CPU sizes (``SIZES``) and three seeds, the sha256 of the table, of every
array of the query pool, of the draws, of the sample and of the reference's
answers, and the names, limits and rules of the checks a sound run reports.
Moving the harness's code between files may change none of them."""

import hashlib

import numpy as np
import pytest
import torch

from benchh100_util import COMPAT, FAST, ROOT, SIZES, run_small

import harness  # noqa: E402
import named  # noqa: E402
import traffic  # noqa: E402

SEEDS = [0, 2**31 + 11, 2**40 + 3]
# (cell, seed) -> part -> the first 20 hex digits of its sha256 (pool.*: its
# other fields by repr)
DIGESTS = {
    (FAST, 0): {
        "table": "25d9919b4460222bc9ce", "draws": "46c4e02174c2213fc79c",
        "sample": "ea242f3fba1dff7e8ab9", "pool.client": "726839811188f24ed62b",
        "pool.keys.cw": "26ff5a9181b48ca28712", "pool.keys.fcw": "efbc6519a2cc8689d457",
        "pool.keys.s0": "b5055758e82f4c64be76", "pool.keys.s1": "2c64e7311765bad2db6d",
        "pool.keys.t0": "9c764ebaeb8b9e202fd5", "pool.keys.t1": "561df4fbba043c2667ba",
        "pool.num_levels": "5", "pool.prf_keys": "6fbe03cd3ae45d5fe127", "pool.style": "'fast'",
        "pool.targets": "d8721ce7f9c638e33459", "ref.rows": "502b031339524ed1b364",
        "ref.share0": "bc6bb895fdb44a9f6f02", "ref.share1": "aa66b57ef8c1294dc60a",
    },
    (FAST, 2**31 + 11): {
        "table": "7a70a4db7e413baf5f42", "draws": "ffaf3c87e4b2c9ee54a9",
        "sample": "ea242f3fba1dff7e8ab9", "pool.client": "726839811188f24ed62b",
        "pool.keys.cw": "6b85e0ac1f319687e16d", "pool.keys.fcw": "d10cee90a0a519d55a5a",
        "pool.keys.s0": "409db385e8f025ca074d", "pool.keys.s1": "c20c9b37b08f85175ad1",
        "pool.keys.t0": "acd3998de85733770c59", "pool.keys.t1": "7369c9aaaffdcd02d1be",
        "pool.num_levels": "5", "pool.prf_keys": "0716936a8e436d22cf8a", "pool.style": "'fast'",
        "pool.targets": "d8e2d2f4cf8408593d1b", "ref.rows": "59b23cd43246c10375e1",
        "ref.share0": "7b2ea05aaa95ba7ffdd6", "ref.share1": "e9f8cd6d9b0ce77853bd",
    },
    (FAST, 2**40 + 3): {
        "table": "38319026713193a4fd48", "draws": "71243e59a905200df755",
        "sample": "ea242f3fba1dff7e8ab9", "pool.client": "726839811188f24ed62b",
        "pool.keys.cw": "5b79bcea9069cce5851f", "pool.keys.fcw": "3d8f6f2184afb186438e",
        "pool.keys.s0": "1c3d14ffa2bc80cadec9", "pool.keys.s1": "01c718b0cfdd5cd85aac",
        "pool.keys.t0": "7f326b2a9d48543c29d3", "pool.keys.t1": "c429f161b1cda6cc53d6",
        "pool.num_levels": "5", "pool.prf_keys": "f005541099750ef1bb99", "pool.style": "'fast'",
        "pool.targets": "7045f8fb83efb38ea4ac", "ref.rows": "d1027ea8b7999a36d401",
        "ref.share0": "63bc9777da3905fec29a", "ref.share1": "d86373ae9519271191e0",
    },
    (COMPAT, 0): {
        "table": "0f1eff565150e86db36e", "draws": "4378f6157a102e602480",
        "sample": "9d96bab1f1b20ca21e53", "pool.client": "35b70ecb40c626e3a746",
        "pool.keys.cw": "e0e0c9102118d418c572", "pool.keys.final_cw": "836e83a3d04b13992e8b",
        "pool.keys.s0": "a0149668b55da43f85a1", "pool.keys.s1": "060823d48f783702787e",
        "pool.keys.t0": "181f2004a37952315322", "pool.keys.t1": "8b178c37d45243098869",
        "pool.num_levels": "11", "pool.prf_keys": "6fbe03cd3ae45d5fe127", "pool.style": "'compat'",
        "pool.targets": "845b5e24473e934ae7ab", "ref.rows": "4073e431d31a59ce7580",
        "ref.share0": "eb1e33a5445256695119", "ref.share1": "c99b4be2f3b255495d95",
    },
    (COMPAT, 2**31 + 11): {
        "table": "b5a0cbf2819d60f70cc0", "draws": "c12d9bf7c659c2800b28",
        "sample": "9d96bab1f1b20ca21e53", "pool.client": "35b70ecb40c626e3a746",
        "pool.keys.cw": "df0e941d8d5a6985e37b", "pool.keys.final_cw": "e3702fa2a014827d2803",
        "pool.keys.s0": "7a790ec61369afb15c59", "pool.keys.s1": "1a6c15bac3324babf5ec",
        "pool.keys.t0": "41f8981b9d6a684cc9e2", "pool.keys.t1": "88d7c9d497ac1526a41a",
        "pool.num_levels": "11", "pool.prf_keys": "0716936a8e436d22cf8a", "pool.style": "'compat'",
        "pool.targets": "e232af5eb5e3d19099f9", "ref.rows": "e114f9b7808f38172c8a",
        "ref.share0": "8b7944e3ff10c3d09c5a", "ref.share1": "0fa7da9d28ed558155a1",
    },
    (COMPAT, 2**40 + 3): {
        "table": "cd9bad62bae4e15b400e", "draws": "7bab63cf4d3000f8f7f2",
        "sample": "9d96bab1f1b20ca21e53", "pool.client": "35b70ecb40c626e3a746",
        "pool.keys.cw": "e0abd09546a042c5a1b0", "pool.keys.final_cw": "2bdc279fcfea02568e66",
        "pool.keys.s0": "202e63a66b2a15c54dfc", "pool.keys.s1": "a31a5f95bf9105a14b18",
        "pool.keys.t0": "498c3d0a53eee159d9b5", "pool.keys.t1": "4146f5cba01425aaf53f",
        "pool.num_levels": "11", "pool.prf_keys": "f005541099750ef1bb99", "pool.style": "'compat'",
        "pool.targets": "d8a677aec9c3bfc307ac", "ref.rows": "51158af496b5c6d87f7f",
        "ref.share0": "a5da8b8c379e534c075c", "ref.share1": "48452a110fd0fa64b11f",
    },
}
# check -> (limit, rule) of both cells; a sound run reads 0 in each "max" check
CHECKS = {"mismatched": (0, "max"), "unrecovered": (0, "max"), "missing": (0, "max"),
          "checked": (1, "min")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:20]


def _parts(cell: str, seed: int) -> dict:
    _, config, mix = harness.load_cell(harness.load_spec(ROOT), ROOT, cell)
    config, mix = {**config, **SIZES[cell]["config"]}, {**mix, **SIZES[cell]["mix"]}
    protocol = named.module("protocols", config["protocol"])
    pool = protocol.make_pool(config, mix, seed, "cpu")
    draws, sample = traffic.make_draws(mix, seed), traffic.make_sample(mix, seed)
    ref = protocol.answers(config, seed, pool, sample, "cpu")
    parts = {"table": _sha(traffic.make_table(config, seed, "cpu").numpy()),
             "draws": _sha(*draws), "sample": _sha(sample)}
    for name, value in sorted(vars(pool).items()):
        if isinstance(value, dict):
            parts.update({f"pool.{name}.{k}": _sha(v) for k, v in sorted(value.items())})
        elif isinstance(value, np.ndarray):
            parts[f"pool.{name}"] = _sha(value)
        elif isinstance(value, list):
            parts[f"pool.{name}"] = _sha(np.frombuffer(b"".join(b"".join(x) for x in value),
                                                       np.uint8))
        else:
            parts[f"pool.{name}"] = repr(value)
    parts.update({f"ref.{k}": _sha(v) for k, v in sorted(ref.items())})
    return parts


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_inputs_and_answers_are_frozen(cell, seed):
    assert _parts(cell, seed) == DIGESTS[cell, seed]


@pytest.mark.parametrize("cell", [FAST, COMPAT])
def test_checks_are_frozen(cell):
    checks = run_small(cell, seed=2**31 + 29)["checks"]
    assert {k: (c["limit"], c["rule"]) for k, c in checks.items()} == CHECKS
    assert all(c["value"] == 0 for c in checks.values() if c["rule"] == "max")
