"""TorchPirServer (CPU) vs TpuPirServer (Pallas in interpret mode).

Both packages answer the same shares — pir_tpu's keygen, converted with
pir_tpu_torch.state — over the same rows; answer shares must be equal
bytes and recover the rows exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pir_tpu import query as jq
from pir_tpu.database import generate_random_db
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import query as tq
from pir_tpu_torch.dpf.host import PrfKey
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import database_from_numpy, share_from_fields
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEIGHT = 1 << 13
SLOT = 8


def to_port(shares):
    keysets = {}
    out = []
    for s in shares:
        kf = s.key_fast
        keys = keysets.setdefault(id(s.prf_keys), [PrfKey(k.bytes) for k in s.prf_keys])
        out.append(share_from_fields(
            prf_keys=keys, s_init=kf.s_init, t_init=kf.t_init, cw=kf.cw,
            final_cw_block=kf.final_cw_block, depth=kf.depth, height=kf.height,
            share_number=s.share_number, group_size=s.group_size))
    return out


@pytest.fixture(scope="module")
def servers():
    db = generate_random_db(HEIGHT, SLOT)
    jsrv = TpuPirServer(db, use_pallas=True, fast_nonshared_chunk=4)
    tsrv = TorchPirServer(database_from_numpy(db.data, SLOT), device="cpu",
                          fast_nonshared_chunk=4)
    return db, jsrv, tsrv


def _answers(srv, shares):
    return np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8)
                     for r in srv.private_secret_shared_query_batch(shares)])


def _check_both(servers, pairs, idxs):
    db, jsrv, tsrv = servers
    got, want = [], []
    for part in (0, 1):
        jshares = [p[part] for p in pairs]
        want.append(_answers(jsrv, jshares))
        got.append(_answers(tsrv, to_port(jshares)))
        assert (got[part] == want[part]).all(), f"share {part} differs"
    assert ((got[0] ^ got[1]) == db.data[idxs]).all()


@pytest.mark.parametrize("leaf_bits", [None, 256])
def test_storage_table_matches_pir_tpu(servers, leaf_bits):
    _, jsrv, tsrv = servers
    share = jq.new_index_query_shares(servers[0].metadata(), 5, 1, 2, fast=True,
                                      leaf_bits=leaf_bits)[0]
    depth, n_blk = share.key_fast.depth, share.key_fast.leaf_bits // 128
    want = np.asarray(jsrv._root_table_u8(1, depth, n_blk, stacked=True))
    got = tsrv._root_table_u8(1, depth, n_blk)
    # the port pads each row with zero bytes to a multiple of 4 (none here)
    assert got.dtype == torch.uint8 and got.shape == (want.shape[0], -(-SLOT // 4) * 4)
    assert (got.numpy()[:, :SLOT] == want).all() and not got.numpy()[:, SLOT:].any()


@pytest.mark.parametrize("n", [35, 3])
def test_shared_key_batches_match_pir_tpu(servers, n):
    """35 is not a multiple of k = 32; 3 is below the batch threshold."""
    idxs = [int(i) for i in np.random.default_rng(n).integers(0, HEIGHT, size=n)]
    pairs = jq.new_index_query_shares_batch(servers[0].metadata(), idxs, 1, 2, fast=True)
    _check_both(servers, pairs, idxs)


def test_distinct_key_batch_matches_pir_tpu(servers):
    """Distinct PRF keys per query, chunked at 4 (4 + 4 + 1)."""
    idxs = [int(i) for i in np.random.default_rng(9).integers(0, HEIGHT, size=9)]
    pairs = [jq.new_index_query_shares(servers[0].metadata(), i, 1, 2, fast=True)
             for i in idxs]
    _check_both(servers, pairs, idxs)


def test_port_keygen_recovers_through_port_server(servers):
    db, _, tsrv = servers
    rng = np.random.default_rng(12)
    idxs = [int(i) for i in rng.integers(0, HEIGHT, size=40)]
    pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True,
                                            rand_bytes=rng.bytes)
    fut = [tsrv.private_secret_shared_query_batch_async([p[i] for p in pairs]) for i in (0, 1)]
    res = [f() for f in fut]
    for i, idx in enumerate(idxs):
        rec = tq.recover([res[0][i], res[1][i]])
        assert bytes(rec[0].data) == db.data[idx].tobytes()


def test_batches_the_port_cannot_serve_raise(servers):
    db, _, tsrv = servers
    md = db.metadata()
    a = tq.new_fast_index_query_shares(md, 1, 1, leaf_bits=128)[0]
    b = tq.new_fast_index_query_shares(md, 2, 1, leaf_bits=256)[0]
    with pytest.raises(ValueError, match="leaf widths"):
        tsrv.private_secret_shared_query_batch([a, b])
    with pytest.raises(ValueError, match="empty"):
        tsrv.private_secret_shared_query_batch([])
    # a keyword share carries a reference-exact key, never a fast one; a
    # fast key of depth < 5, which raised before the per-query path, is
    # served (host bits)
    keyword = dataclasses.replace(a, is_keyword_based=True)
    with pytest.raises(ValueError, match="reference-exact keys"):
        tsrv.private_secret_shared_query_batch([keyword])
    with pytest.raises(ValueError, match="reference-exact keys"):
        tsrv.private_secret_shared_query(keyword)
    tiny = TorchPirServer(database_from_numpy(db.data[:512], SLOT), device="cpu")
    shallow = tq.new_fast_index_query_shares(tiny.db.metadata(), 3, 1)
    assert shallow[0].key_fast.depth < 5
    res = [tiny.private_secret_shared_query_batch([s])[0] for s in shallow]
    assert bytes(tq.recover(res)[0].data) == db.data[3].tobytes()


def test_default_device_is_cuda_and_raises_without_one(servers):
    db = servers[2].db
    if torch.cuda.is_available():
        assert TorchPirServer(db).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchPirServer(db)
