"""pir_tpu_torch's keyword queries vs pir_tpu.

2-party keyword shares, made by the JAX package's keygen and carried
across with pir_tpu_torch.state, go through both packages: the branch-bit
planes and device point keys, the host golden (eval_points), the device
point walk (eval_points_bits[_batch]), and TorchPirServer (on the CPU)
against TpuPirServer: keyword batches (one point walk, then the
bit-plane scan) and singles. The keyword search trees (PrivateSqrtST,
PrivateBST) run over the port's servers as tests/test_keyword.py and
tests/test_private_bst.py run them over pir_tpu's. Answers are exact:
tolerance 0.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from pir_tpu import query as jq
from pir_tpu import server as jsrv
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu.keyword import new_private_bst as j_new_private_bst
from pir_tpu.keyword import new_private_sqrt_st as j_new_private_sqrt_st
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import query as tq
from pir_tpu_torch import server as tsrv
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.keyword import (
    PrivateSqrtST,
    new_private_bst,
    new_private_sqrt_st,
    pad_to_power_of_2,
    pad_to_sqrt,
)
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import compat_share_from_fields, database_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROWS = 1 << 9  # one table height: the JAX package compiles its 32-level walk once


def port_share(s):
    keys = [thost.PrfKey(k.bytes) for k in s.prf_keys]
    k = s.key_two_party
    return compat_share_from_fields(prf_keys=keys, s_init=k.s_init, t_init=k.t_init, cw=k.cw,
                                    final_cw=k.final_cw, share_number=s.share_number,
                                    group_size=s.group_size, is_keyword_based=s.is_keyword_based)


def port_dpf(prf_keys, num_bits=32):
    return thost.server_initialize([thost.PrfKey(k.bytes) for k in prf_keys], num_bits)


@pytest.fixture(scope="module")
def servers():
    """(db, port db, TpuPirServer, TorchPirServer) over one table of 2^9
    rows x 5 B with distinct keywords."""
    rng = random.Random(5)
    db = generate_random_db(ROWS, 5)
    kws = np.array(rng.sample(range(1 << 32), ROWS), dtype=np.uint64)
    db.set_keywords(kws)
    tdb = database_from_numpy(db.data, db.slot_bytes, keywords=kws)
    return db, tdb, TpuPirServer(db), TorchPirServer(tdb, device="cpu")


# ---- device layer ------------------------------------------------------------

def test_point_planes_and_device_keys_match_pir_tpu(servers):
    db = servers[0]
    planes = tdev.pack_point_bit_planes(db.keywords, 32)
    assert planes.dtype == np.uint32 and (planes == jdev.pack_point_bit_planes(db.keywords, 32)).all()
    odd = db.keywords[:77]  # a ragged last lane word
    assert (tdev.pack_point_bit_planes(odd, 32) == jdev.pack_point_bit_planes(odd, 32)).all()
    share = jq.new_keyword_query_shares(db.metadata(), int(db.keywords[3]), 1, 2)[1]
    pf = jhost.server_initialize(share.prf_keys, 32)
    dj = jdev.make_device_point_key(pf, share.key_two_party)
    dt = tdev.make_device_point_key(port_dpf(share.prf_keys), port_share(share).key_two_party)
    assert dt.num_bits == dj.num_bits == 32
    for f in ("s_init_masks", "t_init_mask", "cw_seed_masks", "cw_tl", "cw_tr", "rk_masks",
              "fcw_mask"):
        assert (np.asarray(getattr(dj, f)) == getattr(dt, f)).all(), f


def test_point_eval_matches_golden_and_pir_tpu(servers):
    """Both shares of a keyword query: host golden equal to pir_tpu's,
    device bits equal to the golden and to pir_tpu's eval_points_bits,
    XOR one-hot at the keyword's row."""
    db = servers[0]
    planes_j = jdev.pack_point_bit_planes(db.keywords, 32)
    planes_t = tdev.u32_tensor(tdev.pack_point_bit_planes(db.keywords, 32))
    shares = jq.new_keyword_query_shares(db.metadata(), int(db.keywords[100]), 1, 2)
    acc = torch.zeros(ROWS, dtype=torch.uint8)
    for s in shares:
        pf = jhost.server_initialize(s.prf_keys, 32)
        ps = port_share(s)
        vals = thost.eval_points(port_dpf(s.prf_keys), s.share_number, ps.key_two_party,
                                 db.keywords)
        assert (vals == jhost.eval_points(pf, s.share_number, s.key_two_party, db.keywords)).all()
        for x in (0, 100):
            assert vals[x] == jhost.evaluate_2p(pf, s.share_number, s.key_two_party,
                                                int(db.keywords[x]))
        dkey = tdev.make_device_point_key(port_dpf(s.prf_keys), ps.key_two_party)
        bits = tdev.eval_points_bits(dkey, planes_t, ROWS)
        assert (bits.numpy() == ((vals & 1) == 0)).all()
        want = jdev.eval_points_bits(jdev.make_device_point_key(pf, s.key_two_party), planes_j,
                                     ROWS)
        assert (bits.numpy() == np.asarray(want)).all()
        acc ^= bits
    assert torch.nonzero(acc).flatten().tolist() == [100]


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_point_eval_batch_chunks_match_pir_tpu(servers, chunk, monkeypatch):
    db = servers[0]
    rows = [0, ROWS - 1, 7, 7, 300]
    pairs = jq.new_keyword_query_shares_batch(db.metadata(), [int(db.keywords[r]) for r in rows],
                                              1)
    shares = [p[i] for p in pairs for i in (0, 1)]
    pf = jhost.server_initialize(shares[0].prf_keys, 32)
    want = np.asarray(jdev.eval_points_bits_batch(
        [jdev.make_device_point_key(pf, s.key_two_party) for s in shares],
        jdev.pack_point_bit_planes(db.keywords, 32), ROWS))
    dkeys = [tdev.make_device_point_key(port_dpf(s.prf_keys), port_share(s).key_two_party)
             for s in shares]
    monkeypatch.setattr(tdev, "POINT_EVAL_CHUNK", chunk)
    got = tdev.eval_points_bits_batch(
        dkeys, tdev.u32_tensor(tdev.pack_point_bit_planes(db.keywords, 32)), ROWS)
    assert got.shape == (len(shares), ROWS) and (got.numpy() == want).all()


def test_point_eval_rejects_mixed_domains(servers):
    db = servers[0]
    share = port_share(jq.new_keyword_query_shares(db.metadata(), 1, 1, 2)[0])
    dkey = tdev.make_device_point_key(port_dpf(share.prf_keys), share.key_two_party)
    planes = tdev.u32_tensor(tdev.pack_point_bit_planes(db.keywords, 20))
    with pytest.raises(ValueError, match="one domain"):
        tdev.eval_points_bits(dkey, planes, ROWS)


# ---- server ------------------------------------------------------------------

def _rows(results):
    return [bytes(r.shares[0].data) for r in results]


@pytest.mark.parametrize("asynchronous", [False, True])
def test_keyword_batch_matches_tpu_server(servers, asynchronous):
    """A keyword batch (a duplicate and an absent keyword among them):
    equal bytes to TpuPirServer's keyword batch, both shares; every present
    keyword recovers its row, the absent one zero bytes."""
    db, _, jeng, teng = servers
    rows = [0, ROWS - 1, 42, 42, 311, 12, 99, 250, None]
    absent = next(x for x in range(1 << 20) if x not in set(db.keywords.tolist()))
    kws = [absent if r is None else int(db.keywords[r]) for r in rows]
    pairs = jq.new_keyword_query_shares_batch(db.metadata(), kws, 1)
    out = []
    for part in (0, 1):
        js = [p[part] for p in pairs]
        ts = [port_share(s) for s in js]
        got = (teng.private_secret_shared_query_batch_async(ts)() if asynchronous
               else teng.private_secret_shared_query_batch(ts))
        assert _rows(got) == _rows(jeng.private_secret_shared_query_batch(js))
        out.append(got)
    for i, r in enumerate(rows):
        rec = bytes(tq.recover([out[0][i], out[1][i]])[0].data)
        assert rec == (bytes(5) if r is None else db.data[r].tobytes())


@pytest.mark.parametrize("slot,group", [(5, 2), (3, 1)])
def test_keyword_batch_slots_and_groups(slot, group):
    """Group size 2 (two slots a row) and 3-byte slots: the natural word
    table pads each slot to whole words; the answers drop the padding and
    equal the host golden's."""
    rng = np.random.default_rng(slot * 10 + group)
    data = rng.integers(0, 256, size=(ROWS, slot), dtype=np.uint8)
    kws = rng.choice(1 << 32, size=ROWS // group, replace=False).astype(np.uint64)
    tdb = database_from_numpy(data, slot, keywords=kws)
    teng = TorchPirServer(tdb, device="cpu")
    rows = [0, 3, ROWS // group - 1]
    pairs = tq.new_keyword_query_shares_batch(tdb.metadata(), [int(kws[r]) for r in rows], group,
                                              rand_bytes=rng.bytes)
    out = []
    for part in (0, 1):
        got = teng.private_secret_shared_query_batch([p[part] for p in pairs])
        for res, p in zip(got, pairs):
            want = tsrv.private_secret_shared_query(tdb, p[part])
            assert [s.data for s in res.shares] == [s.data for s in want.shares]
        out.append(got)
    for i, r in enumerate(rows):
        rec = tq.recover([out[0][i], out[1][i]])
        assert b"".join(bytes(s.data) for s in rec) == data[r * group:(r + 1) * group].tobytes()


def test_keyword_singles_match_tpu_server(servers):
    db, tdb, jeng, teng = servers
    shares = jq.new_keyword_query_shares(db.metadata(), int(db.keywords[17]), 1, 2)
    res = []
    for s in shares:
        ps = port_share(s)
        bits = teng.expand_shared_query(ps)
        assert (bits.numpy() == np.asarray(jeng.expand_shared_query(s))).all()
        assert (tsrv.expand_shared_query(tdb, ps) == jsrv.expand_shared_query(db, s)).all()
        got = teng.private_secret_shared_query(ps)
        assert got.shares[0].data == jeng.private_secret_shared_query(s).shares[0].data
        assert got.shares[0].data == teng.private_secret_shared_query_with_expanded_bits(
            ps, bits).shares[0].data
        res.append(got)
    assert bytes(tq.recover(res)[0].data) == db.data[17].tobytes()


def test_port_keyword_shares_recover(servers):
    """The port's own keyword keygen (no domain check, 32-bit keys)."""
    db, tdb, _, teng = servers
    rng = np.random.default_rng(3)
    shares = tq.new_keyword_query_shares(tdb.metadata(), int(db.keywords[5]), 1,
                                         rand_bytes=rng.bytes)
    assert all(s.is_keyword_based and len(s.key_two_party.cw) == 32 for s in shares)
    assert bytes(tq.recover([teng.private_secret_shared_query(s) for s in shares])[0].data) == \
        db.data[5].tobytes()


def test_keyword_shares_the_port_cannot_serve_raise(servers):
    db, tdb, _, teng = servers
    md = db.metadata()
    kw = port_share(jq.new_keyword_query_shares(md, int(db.keywords[1]), 1, 2)[0])
    idx = port_share(jq.new_index_query_shares(md, 1, 1, 2)[0])
    with pytest.raises(ValueError, match="uniform 2-party keyword"):
        teng.private_secret_shared_query_batch([kw, idx])
    short = dataclasses.replace(kw, key_two_party=dataclasses.replace(
        kw.key_two_party, cw=kw.key_two_party.cw[:20]))
    with pytest.raises(ValueError, match="keyword key geometry"):
        teng.private_secret_shared_query(short)
    with pytest.raises(ValueError, match="keyword key geometry"):
        teng.private_secret_shared_query_batch([short])
    bare = TorchPirServer(database_from_numpy(db.data, db.slot_bytes), device="cpu")
    with pytest.raises(ValueError, match="keyword for every row"):
        bare.private_secret_shared_query(kw)
    with pytest.raises(ValueError, match="keyword for every row"):
        tsrv.expand_shared_query(bare.db, kw)
    fast = tq.new_index_query_shares(md, 1, 1, fast=True, leaf_bits=128)[0]
    with pytest.raises(ValueError, match="fast-mode index queries only"):
        teng.fast_serving_stream().submit([dataclasses.replace(fast, is_keyword_based=True)])


# ---- keyword search trees -------------------------------------------------------

def _sqrt_tree(rng, device="cpu"):
    num_strings = rng.randrange(1 << 10) + 100
    data = pad_to_sqrt([str(i) for i in range(num_strings)])
    data.sort()
    data.reverse()
    sqst = new_private_sqrt_st(device)
    sqst.build_for_data(data)
    return sqst, data


def test_sqrt_tree_matches_pir_tpu_and_finds_keys():
    """The tree equals pir_tpu's on the same data; lookups through the
    tree's own server and through a TorchPirServer the caller passes find
    every key, with the host golden's bytes."""
    rng = random.Random(0)
    sqst, data = _sqrt_tree(rng)
    jst = j_new_private_sqrt_st()
    jst.build_for_data(list(data))
    assert sqst.first_layer == jst.first_layer and (sqst.width, sqst.height, sqst.slot_bytes) == \
        (jst.width, jst.height, jst.slot_bytes)
    assert (sqst.second_layer.data == jst.second_layer.data).all()
    md = sqst.get_second_layer_metadata()
    server = TorchPirServer(sqst.second_layer, device="cpu")
    assert sqst.server() is sqst.server() and sqst.server().device.type == "cpu"
    nrng = np.random.default_rng(1)
    for n, i in enumerate(rng.sample(range(len(data)), 6)):
        key = data[i]
        row_index = sqst.find_bucket(key)
        assert row_index == jst.find_bucket(key)
        shares = tq.new_index_query_shares(md, row_index, sqst.height, rand_bytes=nrng.bytes)
        answers = [sqst.private_query(s, server if n % 2 else None) for s in shares]
        assert [a.shares for a in answers] == \
            [tsrv.private_secret_shared_query(sqst.second_layer, s).shares for s in shares]
        res = tq.recover(answers)
        assert len(res) == len(sqst.first_layer)
        index = row_index * sqst.width + sqst.find_in_row(res, key)
        assert index == i or data[index] == data[i], (i, index)


def test_trees_reject_bad_input_and_pad():
    with pytest.raises(ValueError, match="perfect square"):
        PrivateSqrtST().build_for_data(["c", "b", "a"])
    with pytest.raises(ValueError, match="not sorted"):
        PrivateSqrtST().build_for_data(["a", "b", "c", "d"])
    with pytest.raises(ValueError, match="power of two"):
        new_private_bst().build_for_data(["c", "b", "a"])
    with pytest.raises(ValueError, match="not sorted"):
        new_private_bst().build_for_data(["a", "b", "c", "d"])
    assert len(pad_to_power_of_2(["a"] * 5)) == 8
    assert len(pad_to_sqrt(["a"] * 5)) == 9 and pad_to_sqrt(["a"] * 5)[8] == "\x00"


def test_private_bst_lookup():
    """The level-order tree equals pir_tpu's; a full PIR walk a level,
    each level through the tree's own server (the host golden's bytes) and
    the data through a TorchPirServer, finds every key."""
    rng = random.Random(0)
    data = pad_to_power_of_2([f"key-{i:06d}" for i in range(700)])
    data.sort()
    data.reverse()
    bst = new_private_bst("cpu")
    bst.build_for_data(data)
    jbst = j_new_private_bst()
    jbst.build_for_data(list(data))
    assert bst.depth == jbst.depth == 10
    assert len(bst.levels[0].slots) == 1 and len(bst.levels[9].slots) == 512
    assert all((a.data == b.data).all() for a, b in zip(bst.levels, jbst.levels))
    nrng = np.random.default_rng(2)
    data_srv = TorchPirServer(bst.data_layer, device="cpu")

    def query_level(lvl, index):
        db = bst.levels[lvl]
        shares = tq.new_index_query_shares(db.metadata(), index, 1, rand_bytes=nrng.bytes)
        answers = [bst.private_level_query(lvl, s) for s in shares]
        assert [a.shares for a in answers] == \
            [tsrv.private_secret_shared_query(db, s).shares for s in shares]
        return tq.recover(answers)[0]

    def query_data(index):
        shares = tq.new_index_query_shares(bst.data_layer.metadata(), index, 1,
                                           rand_bytes=nrng.bytes)
        return tq.recover([data_srv.private_secret_shared_query(s) for s in shares])

    for i in rng.sample(range(len(data)), 6):
        key = data[i]
        idx, slots = bst.lookup(key, query_level, query_data)
        assert idx == i or data[idx] == key, (i, idx)
        assert slots[0].to_string() == key


def test_trees_answer_on_the_card_unless_asked_for_the_cpu():
    """A tree made with no device answers on a CUDA device: here, with no
    GPU, its first query raises instead of falling back to the host."""
    sqst, _ = _sqrt_tree(random.Random(3), device=None)
    bst = new_private_bst()
    bst.build_for_data(pad_to_power_of_2(["b", "a"]))
    assert sqst.device is None and bst.device is None
    share = tq.new_index_query_shares(sqst.get_second_layer_metadata(), 0, sqst.height)[0]
    level_share = tq.new_index_query_shares(bst.levels[0].metadata(), 0, 1)[0]
    if torch.cuda.is_available():
        assert sqst.server().device.type == "cuda" and bst.level_server(0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        sqst.private_query(share)
    with pytest.raises(RuntimeError, match="CUDA"):
        bst.private_level_query(0, level_share)
