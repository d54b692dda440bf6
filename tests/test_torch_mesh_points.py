"""pir_tpu_torch's mesh engine on its host-prefix, keyword and
multi-party routes, and its host helpers, against pir_tpu.

The same shares go through pir_tpu's ``parallel.mesh.MeshPirServer`` on
the virtual CPU devices of tests/conftest.py and through the port's
(``make_mesh(..., device="cpu")``, the kernels' plain versions):
distinct-key fast batches and compat batches on tp 3 (no root step off a
power of two) and distinct-key fast batches on tp 4 x dp 2 (the
host-prefix steps), keyword batches and uniform 3-party index and keyword
batches on tp 2 x dp 2 (the point steps), a mixed batch (the host
golden), and batches after apply_updates. The host helpers' arrays
(sharded keys, permutations, padding, sharded tables) equal pir_tpu's.
Every comparison is on equal bytes (tolerance 0).

Time: pir_tpu's host-prefix and point steps are jitted jnp (no Pallas):
~5-35 s a new shape alone; the engines are module fixtures.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from pir_tpu import query as jq
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu.parallel import mesh as jmesh
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.dpf.bitslice import blocks_to_planes
from pir_tpu_torch.parallel import mesh as tmesh
from pir_tpu_torch.state import database_from_numpy
from pir_tpu_torch.utils.bits import num_bits_for_height

from mesh_shares import both, recovered, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLOT = 12
# >= 32 * 128 rows a shard at tp 4 for distinct-key fast batches; 700
# rows past 2^14 make the last shard partial
FAST_ROWS = (1 << 14) + 700
# the point steps: > 32 rows a shard; the last shard partial
POINT_ROWS = (1 << 10) + 37
LEAF = 128
BATCH = 5  # not a multiple of dp = 2


def _dbs(height, seed, keywords=False):
    jdb = generate_random_db(height, SLOT)
    rng = np.random.default_rng(seed)
    jdb.data = rng.integers(0, 256, jdb.data.shape, dtype=np.uint8)
    kws = None
    if keywords:
        kws = rng.choice(1 << 32, size=height, replace=False).astype(np.uint64)
        jdb.set_keywords(kws)
    return jdb, database_from_numpy(jdb.data.copy(), SLOT, keywords=kws)


def _pair(jdb, tdb, tp, dp):
    jm = (jmesh.make_mesh(tp * dp, dp=dp) if tp != 3 else
          Mesh(np.array(jax.devices()[:3]).reshape(1, 3), ("dp", "tp")))
    return (jmesh.MeshPirServer(jdb, mesh=jm),
            tmesh.MeshPirServer(tdb, mesh=tmesh.make_mesh(tp * dp, dp=dp, device="cpu")))


def _rows(height, n, seed):
    rows = [int(r) for r in np.random.default_rng(seed).integers(0, height, n)]
    rows[0], rows[-1] = 0, height - 1
    return rows


def _kinds(teng):
    return {key[0] for key in teng._tables}


@pytest.fixture(scope="module")
def fast_db():
    return _dbs(FAST_ROWS, 1)


@pytest.fixture(scope="module")
def tp3(fast_db):
    return _pair(*fast_db, 3, 1)


@pytest.fixture(scope="module")
def points():
    jdb, tdb = _dbs(POINT_ROWS, 2, keywords=True)
    return jdb, tdb, _pair(jdb, tdb, 2, 2)


@pytest.fixture(scope="module")
def points_tp3(points):
    return _pair(*points[:2], 3, 1)


# ---- host helpers ----------------------------------------------------------


def _fields_equal(got, want, names):
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        assert np.array_equal(np.asarray(g), np.asarray(w)), name
        assert np.asarray(g).dtype == np.asarray(w).dtype, name


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_keys_match_pir_tpu(fast_db, n_shards):
    jdb, _ = fast_db
    md = jdb.metadata()
    h = FAST_ROWS
    compat = jq.new_index_query_shares(md, 77, 1, 2)[1]
    nb = len(compat.key_two_party.cw)
    (p,) = to_port([compat])
    want = jmesh.make_sharded_key(jhost.server_initialize(compat.prf_keys, nb),
                                  compat.key_two_party, h, n_shards)
    got = tmesh.make_sharded_key(thost.server_initialize(p.prf_keys, nb), p.key_two_party, h,
                                 n_shards)
    _fields_equal(got, want, ("seeds", "t", "cw_seed_masks", "cw_tl", "cw_tr", "rk_masks",
                              "fcw_mask", "d_levels", "rows_per_shard"))
    for leaf in (128, 1024):
        fast = jq.new_index_query_shares(md, h - 1, 1, 2, fast=True, leaf_bits=leaf)[0]
        (p,) = to_port([fast])
        d = fast.key_fast.depth
        want = jmesh.make_sharded_fast_key(jhost.server_initialize(fast.prf_keys, d),
                                           fast.key_fast, n_shards)
        got = tmesh.make_sharded_fast_key(thost.server_initialize(p.prf_keys, d), p.key_fast,
                                          n_shards)
        _fields_equal(got, want, ("seeds", "t", "cw_seed_masks", "cw_tl", "cw_tr",
                                  "fcw_masks", "rk_masks", "rk_leaf", "d_levels",
                                  "per_shard_nodes", "rows_per_shard"))


def test_host_prefix_pieces_and_padding_match_pir_tpu(fast_db):
    """_host_prefix, the correction-word masks (pir_tpu's _cw_masks is
    the port's _cw_masks_list of the levels from `start`) and
    blocks_to_planes give pir_tpu's arrays; so do shard_local_perm,
    pow2_padded_len and pad_table_rows."""
    jdb, _ = fast_db
    share = jq.new_index_query_shares(jdb.metadata(), 4321, 1, 2)[0]
    (p,) = to_port([share])
    nb = len(share.key_two_party.cw)
    plan_args = (nb, FAST_ROWS, 9, 34, 64, nb - 9)
    want = jdev._host_prefix(jhost.server_initialize(share.prf_keys, nb), share.key_two_party,
                             jdev.ExpandPlan(*plan_args))
    got = tdev._host_prefix(thost.server_initialize(p.prf_keys, nb), p.key_two_party,
                            tdev.ExpandPlan(*plan_args))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    for start in (0, 9):
        want = jdev._cw_masks(share.key_two_party, start)
        got = tdev._cw_masks_list(p.key_two_party.cw[start:])
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    from pir_tpu.dpf.bitslice import blocks_to_planes as j_planes

    blocks = np.random.default_rng(3).integers(0, 256, (96, 16), dtype=np.uint8)
    assert np.array_equal(blocks_to_planes(blocks), j_planes(blocks))
    for d, nodes in ((0, 32), (3, 32), (5, 64)):
        assert np.array_equal(tmesh.shard_local_perm(d, nodes), jmesh.shard_local_perm(d, nodes))
    for n in range(1, 40):
        for dp in (1, 2, 3):
            for chunk in (1, 16):
                assert tmesh.pow2_padded_len(n, dp, chunk) == jmesh.pow2_padded_len(n, dp, chunk)
    t = np.arange(15, dtype=np.uint32).reshape(5, 3)
    assert np.array_equal(tmesh.pad_table_rows(t, 8), jmesh.pad_table_rows(t, 8))


@pytest.mark.parametrize("g,shard_levels,stacked_tail", [(1, 2, 0), (1, 1, None), (2, 2, 1)])
def test_sharded_tables_match_pir_tpu(fast_db, g, shard_levels, stacked_tail):
    """The root and compat tables, shard slices stacked, the last shard
    partial (and at g = 2 and 4 shards, a shard of zero rows past it)."""
    jdb, _ = fast_db
    h = FAST_ROWS // g
    depth = thost.fast_depth_for_height(h, LEAF)
    args = (jdb.data, FAST_ROWS, g, SLOT)
    want = jmesh.build_sharded_root_table_u8(*args, depth, shard_levels, n_blk=1,
                                             stacked_tail=stacked_tail)
    got = tmesh.build_sharded_root_table_u8(*args, depth, shard_levels, n_blk=1,
                                            stacked_tail=stacked_tail)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    nb = num_bits_for_height(h)
    nbd = nb - tdev.compat_skip_levels(nb, h)
    tails = tdev.compat_stage_plan(nbd - shard_levels, 8, 3)[1]
    want = jmesh.build_sharded_compat_table_u8(*args, nbd, shard_levels, 8, tails)
    got = tmesh.build_sharded_compat_table_u8(*args, nbd, shard_levels, 8, tails)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


# ---- host-prefix steps ------------------------------------------------------


def test_compat_host_prefix_tp3(points, points_tp3):
    """tp 3 is no power of two: compat batches take the host-prefix step
    (64 nodes a shard from the host, the last 3 levels in plain torch,
    the masked-XOR scan on the natural word table; the small table keeps
    pir_tpu's jitted walk short)."""
    jdb = points[0]
    jeng, teng = points_tp3
    rows = _rows(POINT_ROWS, BATCH, 3)
    outs = both(jeng, teng, jq.new_index_query_shares_batch(jdb.metadata(), rows, 1, 2))
    assert recovered(outs, jdb.data, rows)
    assert _kinds(teng) == {"words"}


def test_fast_host_prefix_tp3(fast_db, tp3):
    """Fast shares of the batch keygen on tp 3 take the host-prefix fast
    step (no root step off a power of two)."""
    jdb, _ = fast_db
    jeng, teng = tp3
    rows = _rows(FAST_ROWS, BATCH, 4)
    pairs = jq.new_index_query_shares_batch(jdb.metadata(), rows, 1, 2, fast=True,
                                            leaf_bits=LEAF)
    outs = both(jeng, teng, pairs)
    assert recovered(outs, jdb.data, rows)
    assert _kinds(teng) == {"words"}


@pytest.mark.parametrize("leaf", [LEAF, 1024])
def test_distinct_key_fast_tp4_dp2(fast_db, leaf):
    """Distinct-key fast batches (one keygen a query) take the host-prefix
    fast step on tp 4 x dp 2: 128-bit leaves, and 1024-bit leaves whose
    shards pad with zero seeds."""
    jdb, tdb = fast_db
    jeng, teng = _pair(jdb, tdb, 4, 2)
    rows = _rows(FAST_ROWS, BATCH, 5)
    pairs = [jq.new_index_query_shares(jdb.metadata(), r, 1, 2, fast=True, leaf_bits=leaf)
             for r in rows]
    outs = both(jeng, teng, pairs)
    assert recovered(outs, jdb.data, rows)
    assert _kinds(teng) == {"words"}


# ---- point steps -------------------------------------------------------------


def test_keyword_batch_tp2_dp2(points):
    jdb, _, (jeng, teng) = points
    rows = _rows(POINT_ROWS, BATCH, 6)
    pairs = jq.new_keyword_query_shares_batch(jdb.metadata(), [int(jdb.keywords[r])
                                                                for r in rows], 1, 2)
    outs = both(jeng, teng, pairs)
    assert recovered(outs, jdb.data, rows)
    assert (1, teng._point_rows_per_shard(POINT_ROWS)) in teng._kw_planes


@pytest.mark.parametrize("keyword", [False, True])
def test_multi_party_batch_tp2_dp2(points, keyword):
    """Uniform 3-party batches, index and keyword, through the sharded
    multi-party point step: every party's bytes equal pir_tpu's."""
    jdb, _, (jeng, teng) = points
    md = jdb.metadata()
    rows = _rows(POINT_ROWS, 3, 7 + keyword)
    pairs = [jq.new_keyword_query_shares(md, int(jdb.keywords[r]), 1, 3) if keyword
             else jq.new_index_query_shares(md, r, 1, 3) for r in rows]
    outs = both(jeng, teng, pairs)
    assert recovered(outs, jdb.data, rows)


def test_mixed_batch_goes_to_the_host_golden(points):
    """A batch of fast and compat shares is not uniform: pir_tpu answers
    it share by share on its host golden, and so does the port."""
    jdb, _, (jeng, teng) = points
    md = jdb.metadata()
    pairs = [jq.new_index_query_shares(md, 3, 1, 2),
             jq.new_index_query_shares(md, 9, 1, 2, fast=True, leaf_bits=LEAF)]
    outs = both(jeng, teng, pairs)
    assert recovered(outs, jdb.data, [3, 9])


def test_point_and_host_prefix_steps_after_updates(points):
    """apply_updates patches the natural word table of every shard; the
    keyword step then serves the new rows (the keyword planes stay:
    keywords do not change). (Last of the point table's tests: its rows
    change.)"""
    jdb, tdb, (jeng, teng) = points
    rows = _rows(POINT_ROWS, BATCH, 9)
    rng = np.random.default_rng(10)
    updates = {r: rng.bytes(SLOT) for r in rows[:3] + [int(r) for r in
                                                        rng.integers(0, POINT_ROWS, 20)]}
    jeng.apply_updates(updates)
    teng.apply_updates(updates)
    assert np.array_equal(tdb.data, jdb.data)
    pairs = jq.new_keyword_query_shares_batch(jdb.metadata(), [int(jdb.keywords[r])
                                                                for r in rows], 1, 2)
    outs = both(jeng, teng, pairs)
    assert recovered(outs, tdb.data, rows)
