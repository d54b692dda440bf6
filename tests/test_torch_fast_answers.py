"""pir_tpu_torch's last fast routes vs pir_tpu: the whole fast expansion
in plain torch with Q in lanes (``expand_fast_root_lanes_full``, the
``all_xla_expand`` switch of the per-query tail route) and the per-query
fast answers (``fused_fast_answer*``, ``mxu_preplane_scan``), then
TorchPirServer's fast singles below the root route and its per-query fast
batches against TpuPirServer.

The same shares, made by the JAX package's keygen and carried across with
pir_tpu_torch.state, go through both packages (pir_tpu's Pallas kernels in
interpret mode). Every comparison is on equal bytes (tolerance 0). The
CUDA kernels these routes launch (2, 6 and 7) are held against their plain
versions in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_single import to_port

from pir_tpu import query as jq
from pir_tpu.database import DBMetadata as JDBMetadata
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu.models import pipeline as jpipe
from pir_tpu.ops import matmul_scan as jmm
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import server as tsrv_mod
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.models import pipeline as tpipe
from pir_tpu_torch.ops import matmul_scan as tmm
from pir_tpu_torch.ops.fast_tail import fast_tail_expand
from pir_tpu_torch.ops.scan import pack_table_u32, pad_cols_u8, pad_rows_u8
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import database_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _u32(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _bytes(res):
    return [bytes(s.data) for s in res.shares]


# ---- [19]: the whole fast expansion with Q in lanes -------------------------

@pytest.mark.parametrize("height,leaf_bits", [(1 << 13, 128), (1 << 14, 256)])
def test_expand_fast_root_lanes_full_matches_pir_tpu(height, leaf_bits):
    """Depth 6, one and two leaf blocks: the packed leaf words equal
    pir_tpu's, and every query's words equal the per-query tail route's
    (head walk + tail kernel) on the same payloads."""
    md = JDBMetadata(8, height)
    idxs = [int(i) for i in np.random.default_rng(height).integers(0, height, size=5)]
    shares = [p[0] for p in jq.new_index_query_shares_batch(md, idxs, 1, 2, fast=True,
                                                           leaf_bits=leaf_bits)]
    pj, lj = jdev.make_fast_payload_batch(shares)
    pt, lt = tdev.make_fast_payload_batch(to_port(shares))
    assert (pj == pt).all() and lt.shared_rk and lt.leaf_blocks == leaf_bits // 128
    rk_j, rkl_j = jdev.unpack_fast_root_payload(jnp.asarray(pj[0]), lj)[6:]
    want = np.asarray(jdev.expand_fast_root_lanes_full(jnp.asarray(pj), lj, rk_j, rkl_j))
    pay = tdev.u32_tensor(pt, "cpu")
    rk, rkl = tdev.unpack_fast_root_payload(pay[0], lt)[6:]
    got = tdev.expand_fast_root_lanes_full(pay, lt, rk, rkl)
    assert got.shape == want.shape and (_u32(got.contiguous()) == want).all()
    ops, tail = tpipe.pertail_head(pay, lt, 1)
    assert (_u32(fast_tail_expand(*ops, levels=tail)) == want).all()


def _classic_tables(db, depth, n_blk, block):
    """pir_tpu's and the port's storage tables of the per-query tail route:
    rows scattered by _fast_leaf_perm_root, padded to `block` rows."""
    flat = (128 * n_blk) << depth
    perm = jdev._fast_leaf_perm_root(depth, db.db_size, n_blk)
    sc = pad_rows_u8(jdev.scatter_rows_to_storage_order(db.data, perm, flat), block)
    return jnp.asarray(sc), torch.from_numpy(pad_cols_u8(sc))


def test_all_xla_expand_route_matches_pir_tpu():
    """pir_tpu's test_all_xla_expand_matches_pallas_tail shape (3000 rows
    of 8 bytes, 4 queries): the port's route with all_xla_expand equals
    pir_tpu's, and the port's tail-kernel route, byte for byte, and the
    two shares recover the rows."""
    db = generate_random_db(3000, 8)
    idxs = [int(i) for i in np.random.default_rng(11).integers(0, db.db_size, size=4)]
    sh = jq.new_index_query_shares_batch(db.metadata(), idxs, 1, 2, fast=True)
    depth, n_blk = sh[0][0].key_fast.depth, sh[0][0].key_fast.leaf_bits // 128
    jtab, ttab = _classic_tables(db, depth, n_blk, 512)
    outs = []
    for s in range(2):
        pay, layout = jdev.make_fast_payload_batch([x[s] for x in sh])
        want = np.asarray(jpipe.fused_fast_root_batch_pallas_fn(
            layout, 512, 8, 1, True, all_xla_expand=True)(jtab, pay))
        tpay, tlayout = tdev.make_fast_payload_batch(to_port([x[s] for x in sh]))
        tpay = tdev.u32_tensor(tpay, "cpu")
        got = tpipe.fused_fast_root_batch_pertail(ttab, tpay, tlayout, 1, all_xla_expand=True)
        assert (got.numpy()[:, :8] == want).all(), s
        assert torch.equal(got, tpipe.fused_fast_root_batch_pertail(ttab, tpay, tlayout, 1))
        outs.append(want)
    rec = outs[0] ^ outs[1]
    assert all(rec[k].tobytes() == db.data[i].tobytes() for k, i in enumerate(idxs))


def test_all_xla_expand_refuses_distinct_keys_and_shards():
    """pir_tpu raises ValueError for a distinct-key layout; the port too,
    and for a row shard (the walk starts at the root)."""
    db = generate_random_db(1 << 13, 8)
    md = db.metadata()
    distinct = [jq.new_index_query_shares(md, i, 1, 2, fast=True)[0] for i in (3, 700, 8000)]
    pj, lj = jdev.make_fast_payload_batch(distinct)
    assert not lj.shared_rk
    with pytest.raises(ValueError, match="batch-shared"):
        jpipe.fused_fast_root_batch_pallas_fn(lj, 512, 8, 1, True, all_xla_expand=True)
    pt, lt = tdev.make_fast_payload_batch(to_port(distinct))
    ttab = torch.zeros((lt.leaf_blocks * 128 << lt.depth, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="batch-shared"):
        tpipe.fused_fast_root_batch_pertail(ttab, tdev.u32_tensor(pt, "cpu"), lt, 1,
                                            all_xla_expand=True)
    shared = [p[0] for p in jq.new_index_query_shares_batch(md, [1, 2], 1, 2, fast=True)]
    ps, ls = tdev.make_fast_payload_batch(to_port(shared))
    with pytest.raises(ValueError, match="shard"):
        tpipe.fused_fast_root_batch_pertail(ttab, tdev.u32_tensor(ps, "cpu"), ls, 1,
                                            shard=(0, 1), all_xla_expand=True)


# ---- [20]: the per-query fast answers ---------------------------------------

# depth 6 at 128-bit leaves; the default min_device_nodes leaves 1 device
# level (pir_tpu compiles each function once a level count, ~5 s a level)
HEIGHT, SLOT, MDN = 1 << 13, 6, 32


@pytest.fixture(scope="module")
def per_query():
    """Both shares of 3 fast queries as per-query payloads (pir_tpu's and
    the port's, equal words), the leaf permutation, and the tables each
    function takes: the natural word table, its bytes and their planes,
    and the storage-order (flat) words, bytes and planes."""
    db = generate_random_db(HEIGHT, SLOT)
    idxs = [0, HEIGHT - 1, 4321]
    pairs = jq.new_index_query_shares_batch(db.metadata(), idxs, 1, 2, fast=True,
                                            leaf_bits=128)
    parts = []
    for s in range(2):
        shares = [p[s] for p in pairs]
        keys = []
        for sh, port in zip(shares, to_port(shares)):
            dj = jdev.make_device_fast_key(
                jhost.server_initialize(sh.prf_keys, sh.key_fast.depth), sh.key_fast, MDN)
            dt = tdev.make_device_fast_key(
                thost.server_initialize(port.prf_keys, port.key_fast.depth), port.key_fast, MDN)
            pj, lj = jdev.pack_fast_payload(dj)
            pt, lt = tdev.pack_fast_payload(dt)
            assert (pj == pt).all() and dt.plan.device_levels == 1
            keys.append((pj, lj, pt, lt, dj))
        parts.append(keys)
    dj = parts[0][0][4]
    perm = dj.perm
    mp, d = dj.plan.m_padded, dj.plan.device_levels
    flat = (mp << d) * 128
    words = pack_table_u32(db.data, HEIGHT, 1)  # (H, 2) uint32: 6-byte slots in 2 words
    swords = jdev.scatter_rows_to_storage_order(words, jdev._fast_leaf_perm(d, HEIGHT, mp), flat)
    u8, su8 = words.view(np.uint8), swords.view(np.uint8)
    return dict(db=db, idxs=idxs, parts=parts, perm=perm, words=words, swords=swords, u8=u8,
                su8=su8, planes=jmm.make_plane_table(u8), splanes=jmm.make_plane_table(su8))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32
                            else np.ascontiguousarray(a))


FUNCS = {
    # name: (pir_tpu function factory, its table, the port's table, natural order?, batch?)
    "fused_fast_answer": (jpipe.fused_fast_answer_fn, "words", "words", True, False),
    "fused_fast_answer_batch": (jpipe.fused_fast_answer_batch_fn, "words", "words", True, True),
    "fused_fast_answer_batch_mxu": (jpipe.fused_fast_answer_batch_mxu_fn, "u8", "u8", True, True),
    "fused_fast_answer_batch_storage": (jpipe.fused_fast_answer_batch_storage_fn, "splanes",
                                        "su8", False, True),
    "fused_fast_answer_storage": (jpipe.fused_fast_answer_storage_fn, "swords", "swords",
                                  False, False),
    "fused_fast_answer_batch_preplane": (jpipe.fused_fast_answer_batch_preplane_fn, "planes",
                                         "u8", True, True),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_fused_fast_answers_match_pir_tpu(per_query, name):
    """Each function's answers equal its pir_tpu function's on the same
    payloads and tables, and the two shares recover the rows."""
    jbuild, jtab, ttab, natural, batch = FUNCS[name]
    port_fn = getattr(tpipe, name)
    perm = per_query["perm"]
    shares = []
    for keys in per_query["parts"]:
        lj, lt = keys[0][1], keys[0][3]
        jfn = jbuild(lj)
        jt, tt = jnp.asarray(per_query[jtab]), _t(per_query[ttab])
        tperm = torch.from_numpy(perm)
        if batch:
            pj = np.stack([k[0] for k in keys])
            pt = tdev.u32_tensor(np.stack([k[2] for k in keys]), "cpu")
            want = np.asarray(jfn(jt, pj, perm) if natural else jfn(jt, pj))
            got = port_fn(tt, pt, tperm, lt) if natural else port_fn(tt, pt, lt)
        else:
            want = np.stack([np.asarray(jfn(jt, k[0], perm) if natural else jfn(jt, k[0]))
                             for k in keys])
            got = torch.stack([
                port_fn(tt, tdev.u32_tensor(k[2], "cpu"), tperm, lt) if natural
                else port_fn(tt, tdev.u32_tensor(k[2], "cpu"), lt) for k in keys])
        got = _u32(got)
        assert got.shape == want.shape and (got == want).all(), name
        shares.append(np.ascontiguousarray(got).view(np.uint8).reshape(len(keys), -1))
    rec = shares[0] ^ shares[1]
    db = per_query["db"]
    for k, i in enumerate(per_query["idxs"]):
        assert rec[k, :SLOT].tobytes() == db.data[i].tobytes(), (name, k)


def test_mxu_preplane_scan_matches_pir_tpu(per_query):
    """The plain scan over a plane table built once equals pir_tpu's on
    its int8 planes and the port's uint8 ones, and the scan of the bytes."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(7, HEIGHT), dtype=np.uint8)
    planes = per_query["planes"]
    want = np.asarray(jmm.mxu_preplane_scan(jnp.asarray(planes), jnp.asarray(bits)))
    tb = torch.from_numpy(bits)
    u8 = torch.from_numpy(per_query["u8"].copy())
    for p in (torch.from_numpy(planes), tmm.make_plane_table(u8)):
        assert (tmm.mxu_preplane_scan(p, tb).numpy() == want).all()
    assert (tmm.mxu_batched_scan(u8, tb).numpy() == want).all()


# ---- the server routes that reach them ----------------------------------------

@pytest.mark.parametrize("n", [1, 3])
def test_server_fast_routes_below_the_root_match_pir_tpu(n):
    """Fast keys of depth 3 with device levels (min_device_nodes 2): a
    single through TorchPirServer.private_secret_shared_query (the
    storage-order word table, fused_fast_answer_storage) and a batch of 3
    through the per-query batch path (fused_fast_answer_batch) equal
    TpuPirServer's bytes and the host golden's, and recover the rows."""
    rows, g, slot = 2048, 2, 3
    db = generate_random_db(rows, slot)
    tdb = database_from_numpy(db.data, slot)
    jsrv = TpuPirServer(db, min_device_nodes=2)
    tsrv = TorchPirServer(tdb, device="cpu", min_device_nodes=2)
    h = rows // g
    idxs = [0, h - 1, 517][:n]
    pairs = jq.new_index_query_shares_batch(db.metadata(), idxs, g, 2, fast=True,
                                            leaf_bits=128)
    assert pairs[0][0].key_fast.depth == 3
    got = []
    for part in (0, 1):
        jshares = [p[part] for p in pairs]
        ports = to_port(jshares)
        if n == 1:
            want = [_bytes(jsrv.private_secret_shared_query(jshares[0]))]
            ans = [_bytes(tsrv.private_secret_shared_query(ports[0]))]
            assert any(k[0] == "storage words" for k in tsrv._tables)
        else:
            want = [_bytes(r) for r in jsrv.private_secret_shared_query_batch(jshares)]
            ans = [_bytes(r) for r in tsrv.private_secret_shared_query_batch(ports)]
        assert ans == want
        assert ans == [_bytes(tsrv_mod.private_secret_shared_query(tdb, p)) for p in ports]
        got.append(ans)
    for i, idx in enumerate(idxs):
        for c in range(g):
            rec = bytes(np.frombuffer(got[0][i][c], np.uint8) ^ np.frombuffer(got[1][i][c],
                                                                             np.uint8))
            assert rec == db.data[idx * g + c].tobytes()


def test_server_storage_words_follow_updates():
    """apply_updates patches the fast singles' storage word table: a single
    after the update recovers the new row."""
    rows, g, slot = 2048, 2, 3
    db = generate_random_db(rows, slot)
    tdb = database_from_numpy(db.data.copy(), slot)
    tsrv = TorchPirServer(tdb, device="cpu", min_device_nodes=2)
    idx = 517
    pair = to_port(jq.new_index_query_shares(db.metadata(), idx, g, 2, fast=True,
                                             leaf_bits=128))
    tsrv.private_secret_shared_query(pair[0])  # builds the table
    new = {idx * g + 1: b"\x01\x02\x03"}
    tsrv.apply_updates(new)
    ans = [_bytes(tsrv.private_secret_shared_query(s)) for s in pair]
    rec = bytes(np.frombuffer(ans[0][1], np.uint8) ^ np.frombuffer(ans[1][1], np.uint8))
    assert rec == b"\x01\x02\x03"
