"""pir_tpu_torch's multi-party (>= 3 server) queries vs pir_tpu.

The same keys, made by the JAX package's keygen and carried across with
pir_tpu_torch.state, go through both packages: the host golden
(eval_points_mp, evaluate_mp), the device sigma-slot PRG walk over the
index domain (expand_mp_full_domain_bits) and at arbitrary points
(eval_points_mp_bits), and TorchPirServer (on the CPU) against
TpuPirServer through expand_shared_query and private_secret_shared_query.
The port's own keygen is checked through its host golden. Selection bits
and answers are exact: tolerance 0.
"""

import random

import numpy as np
import pytest
import torch

from pir_tpu import query as jq
from pir_tpu import server as jsrv
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import query as tq
from pir_tpu_torch import server as tsrv
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import (
    compat_share_from_fields,
    database_from_numpy,
    key_mp_from_fields,
)
from pir_tpu_torch.utils.bits import num_bits_for_height
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def port_key(k):
    return key_mp_from_fields(k.num_parties, k.cw, k.sigma)


def port_share(s):
    """A pir_tpu share of any kind -> the port's."""
    keys = [thost.PrfKey(k.bytes) for k in s.prf_keys]
    if s.is_two_party:
        k = s.key_two_party
        return compat_share_from_fields(prf_keys=keys, s_init=k.s_init, t_init=k.t_init, cw=k.cw,
                                        final_cw=k.final_cw, share_number=s.share_number,
                                        group_size=s.group_size,
                                        is_keyword_based=s.is_keyword_based)
    return tq.QueryShare(key_two_party=None, key_multi_party=port_key(s.key_multi_party),
                         prf_keys=keys, is_keyword_based=s.is_keyword_based, is_two_party=False,
                         share_number=s.share_number, group_size=s.group_size)


def port_dpf(pf):
    return thost.server_initialize([thost.PrfKey(k.bytes) for k in pf.prf_keys], pf.num_bits)


# ---- host layer --------------------------------------------------------------

@pytest.mark.parametrize("num_parties", [3, 4, 5])
def test_port_keygen_xor_shares_point_function(num_parties):
    """The port's keygen: XOR of every party's evaluate_mp is b at a, 0
    elsewhere; eval_points_mp equals evaluate_mp point by point."""
    rng = np.random.default_rng(num_parties)
    r = random.Random(num_parties)
    num = r.randrange(1 << 8) + 50
    special, value = r.randrange(num), r.randrange(1, 1 << 32)
    client = thost.client_initialize(num_bits_for_height(num), rng.bytes)
    keys = thost.generate_multi_server(client, special, value, num_parties, rng.bytes)
    server = thost.server_initialize(client.prf_keys, client.num_bits)
    xs = r.sample(range(num), 15) + [special]
    vecs = [thost.eval_points_mp(server, k, np.array(xs)) for k in keys]
    for i, x in enumerate(xs):
        acc = 0
        for j, k in enumerate(keys):
            y = thost.evaluate_mp(server, k, x)
            assert y == vecs[j][i]
            acc ^= y
        assert acc == (value if x == special else 0)
    # no party holds every slot of any row (the 1-privacy rejection step)
    for k in keys:
        rows = np.frombuffer(b"".join(k.sigma), np.uint8).reshape(len(k.sigma), -1, 16)
        assert not rows.any(axis=2).all(axis=1).any()


@pytest.mark.parametrize("num_parties,nb", [(3, 8), (4, 11), (5, 9)])
def test_host_eval_matches_pir_tpu_on_its_keys(num_parties, nb):
    r = random.Random(nb)
    client = jhost.client_initialize(nb)
    keys = jhost.generate_multi_server(client, r.randrange(1 << nb), 1, num_parties)
    pts = np.array([r.randrange(1 << nb) for _ in range(300)], dtype=np.int64)
    for k in keys:
        want = jhost.eval_points_mp(client, k, pts)
        assert (thost.eval_points_mp(port_dpf(client), port_key(k), pts) == want).all()
        for x in pts[:3]:
            assert thost.evaluate_mp(port_dpf(client), port_key(k), int(x)) == \
                jhost.evaluate_mp(client, k, int(x))


def test_port_multiparty_shares_recover_through_the_host_golden():
    """query.new_index_query_shares(num_shares=3, 4) and the module-level
    private_secret_shared_query (numpy) recover the row."""
    rng = np.random.default_rng(10)
    db = database_from_numpy(rng.integers(0, 256, size=(1 << 9, 5), dtype=np.uint8), 5)
    for num_shares in (3, 4):
        idx = int(rng.integers(db.db_size))
        shares = tq.new_index_query_shares(db.metadata(), idx, 1, num_shares=num_shares,
                                           rand_bytes=rng.bytes)
        assert len(shares) == num_shares and not shares[0].is_two_party
        res = tq.recover([tsrv.private_secret_shared_query(db, s) for s in shares])
        assert bytes(res[0].data) == db.data[idx].tobytes()
    with pytest.raises(NotImplementedError, match="two-party"):
        tq.new_index_query_shares(db.metadata(), 1, 1, fast=True, num_shares=3)
    with pytest.raises(ValueError, match="outside of domain"):
        tq.new_index_query_shares(db.metadata(), db.db_size, 1, num_shares=3)


# ---- device layer ------------------------------------------------------------

@pytest.mark.parametrize("num_parties,nb,a,height", [
    (3, 8, 77, 256), (4, 9, 300, 500), (5, 7, 0, 128),
])
def test_device_full_domain_matches_pir_tpu(num_parties, nb, a, height):
    client = jhost.client_initialize(nb)
    keys = jhost.generate_multi_server(client, a, 1, num_parties)
    acc = torch.zeros(height, dtype=torch.uint8)
    for k in keys:
        got = tdev.expand_mp_full_domain_bits(port_dpf(client), port_key(k), height, "cpu")
        assert got.dtype == torch.uint8 and got.shape == (height,)
        want = np.asarray(jdev.expand_mp_full_domain_bits(client, k, height))
        assert (got.numpy() == want).all()
        acc ^= got
    assert torch.nonzero(acc).flatten().tolist() == ([a] if a < height else [])


def test_device_full_domain_block_chunks_change_no_bit(monkeypatch):
    client = jhost.client_initialize(10)
    k = jhost.generate_multi_server(client, 700, 1, 3)[1]
    want = tdev.expand_mp_full_domain_bits(port_dpf(client), port_key(k), 1000, "cpu")
    monkeypatch.setattr(tdev, "MP_CHUNK_WORDS", 1)  # one PRG block a chunk
    assert torch.equal(tdev.expand_mp_full_domain_bits(port_dpf(client), port_key(k), 1000, "cpu"),
                       want)


@pytest.mark.parametrize("num_parties,nb", [(3, 8), (4, 10), (3, 13), (5, 16)])
def test_device_point_eval_matches_pir_tpu(num_parties, nb):
    r = random.Random(31 + nb)
    client = jhost.client_initialize(nb)
    a = r.randrange(1 << nb)
    keys = jhost.generate_multi_server(client, a, 1, num_parties)
    pts = np.array([r.randrange(1 << nb) for _ in range(201)] + [a], dtype=np.int64)
    acc = np.zeros(len(pts), np.uint8)
    for k in keys:
        ops_j = jdev.mp_point_operands(client, k, pts)
        ops_t = tdev.mp_point_operands(port_dpf(client), port_key(k), pts)
        for x, y in zip(ops_j[:-1], ops_t[:-1]):
            assert (np.asarray(x) == y).all()
        got = tdev.eval_points_mp_bits(port_dpf(client), port_key(k), pts, "cpu").numpy()
        assert (got == np.asarray(jdev.eval_points_mp_bits(client, k, pts))).all()
        host = (thost.eval_points_mp(port_dpf(client), port_key(k), pts) & 1) == 1
        assert (got == host).all()
        acc ^= got
    assert (acc == (pts == a)).all()


def test_keyword_domain_point_eval_matches_golden_and_pir_tpu():
    """The 32-bit keyword domain: block-sparse host eval equals evaluate_mp
    at spot points, and the device bits equal it and pir_tpu's."""
    r = random.Random(92)
    client = jhost.client_initialize(32)
    kws = np.array(r.sample(range(1 << 32), 128), dtype=np.int64)
    keys = jhost.generate_multi_server(client, int(kws[17]), 1, 3)
    acc = np.zeros(len(kws), np.uint8)
    pf = port_dpf(client)
    for k in keys:
        vals = thost.eval_points_mp(pf, port_key(k), kws)
        for i in (3, 17):
            assert int(vals[i]) == jhost.evaluate_mp(client, k, int(kws[i]))
        bits = tdev.eval_points_mp_bits(pf, port_key(k), kws, "cpu").numpy()
        assert (((vals & 1) == 1) == bits).all()
        assert (bits == np.asarray(jdev.eval_points_mp_bits(client, k, kws))).all()
        acc ^= bits
    assert list(np.flatnonzero(acc)) == [17]


# ---- server ------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    rng = random.Random(47)
    db = generate_random_db(1 << 8, 6)
    kws = np.array(rng.sample(range(1 << 32), db.db_size), dtype=np.uint64)
    db.set_keywords(kws)
    tdb = database_from_numpy(db.data, db.slot_bytes, keywords=kws)
    return db, tdb, TpuPirServer(db), TorchPirServer(tdb, device="cpu")


@pytest.mark.parametrize("num_parties,keyword", [
    (3, False), (4, False), (5, False), (3, True), (4, True), (5, True),
])
def test_server_multiparty_singles_match_tpu_server(servers, num_parties, keyword):
    """expand_shared_query, the host golden and private_secret_shared_query
    give pir_tpu's bits and bytes on equal shares; the answers recover."""
    db, tdb, jeng, teng = servers
    r = random.Random(num_parties * 2 + keyword)
    row = r.randrange(db.db_size)
    shares = (jq.new_keyword_query_shares(db.metadata(), int(db.keywords[row]), 1, num_parties)
              if keyword else jq.new_index_query_shares(db.metadata(), row, 1, num_parties))
    res = []
    for s in shares:
        ps = port_share(s)
        bits = teng.expand_shared_query(ps)
        assert bits.dtype == torch.uint8 and bits.shape == (db.db_size,)
        assert (bits.numpy() == np.asarray(jeng.expand_shared_query(s))).all()
        assert (tsrv.expand_shared_query(tdb, ps) == jsrv.expand_shared_query(db, s)).all()
        got = teng.private_secret_shared_query(ps)
        assert got.shares[0].data == jeng.private_secret_shared_query(s).shares[0].data
        assert got.shares[0].data == tsrv.private_secret_shared_query(tdb, ps).shares[0].data
        res.append(got)
    assert bytes(tq.recover(res)[0].data) == db.data[row].tobytes()


@pytest.mark.parametrize("keyword", [False, True])
def test_multiparty_batches_raise_as_pir_tpu(servers, keyword):
    db, _, jeng, teng = servers
    shares = (jq.new_keyword_query_shares(db.metadata(), int(db.keywords[5]), 1, 3) if keyword
              else jq.new_index_query_shares(db.metadata(), 5, 1, 3))
    with pytest.raises(ValueError, match="uniform 2-party"):
        jeng.private_secret_shared_query_batch(shares)
    with pytest.raises(ValueError, match="uniform 2-party"):
        teng.private_secret_shared_query_batch([port_share(s) for s in shares])
    with pytest.raises(ValueError, match="uniform 2-party"):
        teng.private_secret_shared_query_batch_async([port_share(s) for s in shares])


def test_crafted_multiparty_keys_raise(servers):
    _, tdb, _, teng = servers
    share = tq.new_index_query_shares(tdb.metadata(), 3, 1, num_shares=3,
                                      rand_bytes=np.random.default_rng(1).bytes)[0]
    short = thost.KeyMP(3, share.key_multi_party.cw, share.key_multi_party.sigma[:-1])
    bad = tq.QueryShare(None, short, share.prf_keys, False, False, 0, 1)
    with pytest.raises(ValueError, match="geometry"):
        teng.private_secret_shared_query(bad)
    with pytest.raises(ValueError, match="geometry"):
        tsrv.expand_shared_query(tdb, bad)
    none = tq.QueryShare(None, None, share.prf_keys, False, False, 0, 1)
    with pytest.raises(ValueError, match="KeyMP"):
        teng.expand_shared_query(none)
