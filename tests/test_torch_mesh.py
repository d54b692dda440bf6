"""pir_tpu_torch's mesh engine on its root steps, and the compat preplane
route, against pir_tpu.

The same shares go through pir_tpu's ``parallel.mesh.MeshPirServer`` on
the virtual CPU devices of tests/conftest.py (its Pallas kernels in
interpret mode) and through the port's, built with
``make_mesh(..., device="cpu")`` (the kernels' plain versions): the
shared-key fast root step on both tail kernels (against pir_tpu's
stacked step: the bytes depend on the shares only) and the compat root
step at tp 4 x dp 2, the fast root step at tp 2 x dp 1 (group_size 2)
and at tp 1 x dp 2 (the compat root step on the small grids against
pir_tpu's host golden), batches whose length is not a
multiple of dp, group_size 2, a partial last shard, and batches after
apply_updates. (Each grid's other routes: the card tests hold them
against one card.) Every comparison is on equal bytes (tolerance 0), and
every answer recovers its row.

The compat preplane route (a compat batch of >= 8 on a table of 5 device
levels) is held against TpuPirServer's batch and the host golden on
tables of 17, 24 and 32 rows.

Time: pir_tpu compiles each new step in interpret mode (~20-25 s a fast
root step, ~50 s a compat root step, alone); the engines are module
fixtures and every test reuses one batch shape per engine where it can.
"""

import numpy as np
import pytest
import torch

from pir_tpu import query as jq
from pir_tpu import server as jsrv
from pir_tpu.database import generate_random_db
from pir_tpu.parallel import mesh as jmesh
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import server as tsrv
from pir_tpu_torch.models import pipeline as tpipe
from pir_tpu_torch.parallel import mesh as tmesh
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import database_from_numpy

from mesh_shares import answer_bytes, both, recovered, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLOT = 12
# 128-bit fast leaves: depth 8, so tp 4 leaves each shard a 6-level
# subtree; 700 rows past 2^14 make the last of 4 shards partial. Compat:
# 15 device levels, 13 a shard at tp 4 (the default w = 128 needs > 12)
BIG = (1 << 14) + 700
# 13 compat device levels
SMALL = (1 << 12) + 300
LEAF = 128
BATCH = 5  # not a multiple of dp = 2: pow2_padded_len pads it to 8


def _dbs(height, seed):
    jdb = generate_random_db(height, SLOT)
    jdb.data = np.random.default_rng(seed).integers(0, 256, jdb.data.shape, dtype=np.uint8)
    return jdb, database_from_numpy(jdb.data.copy(), SLOT)


def _pair(jdb, tdb, tp, dp, **kw):
    return (jmesh.MeshPirServer(jdb, mesh=jmesh.make_mesh(tp * dp, dp=dp), **kw),
            tmesh.MeshPirServer(tdb, mesh=tmesh.make_mesh(tp * dp, dp=dp, device="cpu"), **kw))


def _rows(height, n, seed):
    rows = [int(r) for r in np.random.default_rng(seed).integers(0, height, n)]
    rows[0], rows[-1] = 0, height - 1  # the first row and the partial shard's last
    return rows


def _kinds(teng):
    return {key[0] for key in teng._tables}


@pytest.fixture(scope="module")
def big():
    return _dbs(BIG, 1)


@pytest.fixture(scope="module")
def tp4(big):
    """tp 4 x dp 2 on the big table: pir_tpu's engine (stacked) and the
    port's, stacked and per-query tail."""
    jdb, tdb = big
    jeng, teng = _pair(jdb, tdb, 4, 2)
    return jeng, {True: teng, False: tmesh.MeshPirServer(
        tdb, mesh=tmesh.make_mesh(8, dp=2, device="cpu"), fast_stacked=False)}


@pytest.fixture(scope="module")
def fast_ref(big, tp4):
    """A shared-key fast batch on the big table and pir_tpu's tp 4 x dp 2
    answers to each server's shares. The answers depend on the shares
    only, not on the grid or the tail kernel: every grid and route of the
    port is held against them (pir_tpu compiles each new root step in
    interpret mode, ~25-45 s under the tier-1 run)."""
    jdb, _ = big
    rows = _rows(BIG, BATCH, 2)
    pairs = jq.new_index_query_shares_batch(jdb.metadata(), rows, 1, 2, fast=True,
                                            leaf_bits=LEAF)
    want = [answer_bytes(tp4[0].private_secret_shared_query_batch([p[k] for p in pairs]))
            for k in (0, 1)]
    return rows, pairs, want


def _held(teng, pairs, want):
    """The port's answers to each server's shares equal `want`'s bytes."""
    outs = []
    for k, w in enumerate(want):
        got = teng.private_secret_shared_query_batch(to_port([p[k] for p in pairs]))
        assert answer_bytes(got) == w
        outs.append(got)
    return outs


def test_make_mesh_grids_and_refusals():
    m = tmesh.make_mesh(8, dp=2, device="cpu")
    assert m.shape == {"dp": 2, "tp": 4} and m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    assert tmesh.make_mesh(device="cpu").shape == {"dp": 1, "tp": 1}
    m = tmesh.make_mesh(devices=["cpu"] * 6, dp=3)
    assert m.shape == {"dp": 3, "tp": 2}
    assert tmesh.make_mesh(4, devices=["cpu"] * 6).shape == {"dp": 1, "tp": 4}
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_mesh(6, dp=4, device="cpu")
    with pytest.raises(ValueError, match="only 2"):
        tmesh.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh device"):
        tmesh.make_mesh(2, device="tpu")
    if not torch.cuda.is_available():  # no silent drop to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.MeshPirServer(database_from_numpy(np.zeros((64, 4), np.uint8), 4), tp=2)


@pytest.mark.parametrize("stacked", [True, False])
def test_fast_root_tp4_dp2(big, tp4, fast_ref, stacked):
    """Shared-key fast batches take the root step on both tail kernels,
    with pir_tpu's bytes, the partial last shard among the rows."""
    rows, pairs, want = fast_ref
    teng = tp4[1][stacked]
    assert recovered(_held(teng, pairs, want), big[0].data, rows)
    tail = tmesh.stacked_fast_geometry(8 - 2, 1)[1] if stacked else None
    assert ("root", 1, 8, 1, tail) in teng._tables and _kinds(teng) == {"root"}


def test_fast_root_tp1_dp2(big, fast_ref):
    """The fast root step on one shard with two batch slices: no prefix
    walk, the single-card geometry (depth 8, stacked tail 1)."""
    rows, pairs, want = fast_ref
    teng = tmesh.MeshPirServer(big[1], tp=1, dp=2, device="cpu")
    assert recovered(_held(teng, pairs, want), big[0].data, rows)
    assert _kinds(teng) == {"root"}


def test_compat_root_tp4_dp2(big, tp4):
    """Compat batches take the compat root step (13 device levels a
    shard: head 12, one stage), with pir_tpu's bytes."""
    jdb, _ = big
    jeng, teng = tp4[0], tp4[1][True]
    rows = _rows(BIG, BATCH, 3)
    outs = both(jeng, teng, jq.new_index_query_shares_batch(jdb.metadata(), rows, 1, 2))
    assert recovered(outs, jdb.data, rows)
    assert ("compat", 1, 15) in teng._tables


def test_fast_root_tp2_dp1_group_size(big):
    """The fast root step on a 2-shard grid, group_size 2: rows of two
    slots, depth 7 at 128-bit leaves, a 6-level subtree a shard, the last
    shard partial. (Before the big table's updates.)"""
    jdb, tdb = big
    jeng, teng = _pair(jdb, tdb, 2, 1)
    rows = _rows(BIG // 2, BATCH, 4)
    pairs = jq.new_index_query_shares_batch(jdb.metadata(), rows, 2, 2, fast=True,
                                            leaf_bits=LEAF)
    outs = both(jeng, teng, pairs)
    assert recovered(outs, jdb.data, rows, group_size=2)
    assert _kinds(teng) == {"root"} and next(iter(teng._tables))[1] == 2


@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2)])
def test_compat_root_small_grids_match_the_host_golden(tp, dp):
    """The compat root step with a 1-level prefix walk and with none
    (compat_w 32: a 10-level head, one stage), against pir_tpu's host
    golden (pir_tpu's compat step is held at tp 4 above: ~50-110 s of
    interpret-mode compile a grid)."""
    jdb, tdb = _dbs(SMALL, 12)
    teng = tmesh.MeshPirServer(tdb, tp=tp, dp=dp, compat_w=32, device="cpu")
    rows = _rows(SMALL, BATCH, 6)
    pairs = jq.new_index_query_shares_batch(jdb.metadata(), rows, 1, 2)
    want = [answer_bytes([jsrv.private_secret_shared_query(jdb, p[k]) for p in pairs])
            for k in (0, 1)]
    assert recovered(_held(teng, pairs, want), jdb.data, rows)
    assert _kinds(teng) == {"compat"}


def test_root_steps_after_updates(big, tp4):
    """apply_updates patches every cached shard table (the stacked,
    classic and compat root tables on the big table), then the root
    steps serve the new rows with pir_tpu's bytes, half the batch on
    updated rows. (Last of the big table's tests: its rows change.)"""
    jdb, tdb = big
    jeng, tengs = tp4
    md = jdb.metadata()
    rows = _rows(BIG, BATCH, 7)
    rng = np.random.default_rng(8)
    updates = {r: rng.bytes(SLOT) for r in rows[:3] + [int(r) for r in
                                                        rng.integers(0, BIG, 40)]}
    for eng in (jeng, *tengs.values()):
        eng.apply_updates(updates)
    assert np.array_equal(tdb.data, jdb.data)
    pairs = jq.new_index_query_shares_batch(md, rows, 1, 2, fast=True, leaf_bits=LEAF)
    want = [answer_bytes(jeng.private_secret_shared_query_batch([p[k] for p in pairs]))
            for k in (0, 1)]
    for teng in tengs.values():
        assert recovered(_held(teng, pairs, want), tdb.data, rows)
    outs = both(jeng, tengs[True], jq.new_index_query_shares_batch(md, rows, 1, 2))
    assert recovered(outs, tdb.data, rows)


# ---- [21]: the compat preplane route at 5 device levels --------------------


@pytest.fixture(scope="module")
def preplane_tables():
    out = {}
    for h in (17, 24, 32):
        jdb, tdb = _dbs(h, h)
        out[h] = (jdb, TpuPirServer(jdb), TorchPirServer(tdb, device="cpu"))
    return out


@pytest.mark.parametrize("height", [17, 24, 32])
@pytest.mark.parametrize("n", [8, 12])
def test_compat_preplane_route_matches_pir_tpu(preplane_tables, monkeypatch, height, n):
    """A compat batch of >= 8 on 5 device levels (17-32 rows; 32 has one
    dead leading level) walks in plain torch and scans with the bit-plane
    scan kernel, once a batch, with TpuPirServer's and the host golden's
    bytes."""
    jdb, jeng, teng = preplane_tables[height]
    assert teng._compat_device_bits(1) == 5
    calls = []

    def spy(table, bits):
        calls.append(tuple(bits.shape))
        return tsrv.planes_scan(table, bits)

    monkeypatch.setattr(tpipe, "planes_scan", spy)
    rows = _rows(height, n, height + n)
    pairs = jq.new_index_query_shares_batch(jdb.metadata(), rows, 1, 2)
    outs = []
    for k in (0, 1):
        shares = [p[k] for p in pairs]
        got = teng.private_secret_shared_query_batch(to_port(shares))
        assert answer_bytes(got) == answer_bytes(jeng.private_secret_shared_query_batch(shares))
        assert answer_bytes(got) == answer_bytes(
            [jsrv.private_secret_shared_query(jdb, s) for s in shares])
        outs.append(got)
    assert calls == [(n, 32), (n, 32)]
    assert recovered(outs, jdb.data, rows)
    assert ("preplane", 1, 5) in teng._tables
