"""pir_tpu_torch's per-query fast tail path vs pir_tpu.

The same inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port: the classic storage order, the
head walk with Q in lanes (shared and distinct keys), the per-query tail
(``fast_tail_expand_pallas``), the fused scan + tail
(``fused_scan_expand_pallas``), and whole ``fast_stacked=False`` batches
through both servers. Every comparison is on equal bytes (tolerance 0).
The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_server import to_port

from pir_tpu import query as jq
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.ops.pallas_expand import fast_tail_expand_pallas
from pir_tpu.ops.pallas_fused import fused_geometry, fused_scan_expand_pallas
from pir_tpu.server import TpuPirServer
from pir_tpu_torch.database import DBMetadata
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf.device import u32_tensor
from pir_tpu_torch.models.pipeline import pertail_head
from pir_tpu_torch.ops.fast_tail import fast_tail_expand
from pir_tpu_torch.ops.fused import fused_scan_expand
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import database_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEIGHT = 1 << 13
FULL = np.uint32(0xFFFFFFFF)


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("depth,height,n_blk", [(5, 4096, 1), (6, 5000, 1), (7, 1 << 14, 2),
                                                (10, 1 << 20, 8)])
def test_classic_perm_matches_pir_tpu(depth, height, n_blk):
    assert (tdev._fast_leaf_perm_root(depth, height, n_blk)
            == jdev._fast_leaf_perm_root(depth, height, n_blk)).all()


def _jax_vmapped_head(payloads, layout, head_levels):
    """pir_tpu's distinct-key head (models/pipeline.py:381-393): the
    per-query unpack and walk, vmapped over the batch."""

    def head(payload):
        seeds, t, cw_s, cw_tl, cw_tr, fcw, rk, rk_leaf = jdev.unpack_fast_root_payload(
            payload, layout)
        for i in range(head_levels):
            seeds, t = jdev._expand_root_level(seeds, t, cw_s[i], cw_tl[i], cw_tr[i], rk, i)
        return (seeds, t[None, :], cw_s[head_levels:], cw_tl[head_levels:],
                cw_tr[head_levels:], rk, fcw, rk_leaf)

    return jax.jit(jax.vmap(head))(jnp.asarray(payloads))


@pytest.mark.parametrize("height,leaf_bits,tail_levels,distinct", [
    (HEIGHT, 128, 5, False), (HEIGHT, 128, 5, True), (1 << 14, 256, 2, True),
    (1 << 12, 128, 0, False)])
def test_head_matches_pir_tpu(height, leaf_bits, tail_levels, distinct):
    md = DBMetadata(8, height)
    rng = np.random.default_rng(height + distinct)
    idxs = [int(i) for i in rng.integers(0, height, size=6)]
    if distinct:
        shares = [jq.new_index_query_shares(md, i, 1, 2, fast=True, leaf_bits=leaf_bits)[0]
                  for i in idxs]
    else:
        shares = [p[0] for p in jq.new_index_query_shares_batch(md, idxs, 1, 2, fast=True,
                                                               leaf_bits=leaf_bits)]
    pay, layout = tdev.make_fast_payload_batch(to_port(shares))
    assert layout.shared_rk != distinct
    got, tail = pertail_head(u32_tensor(pay, "cpu"), layout, tail_levels)
    head = layout.depth - tail
    jlayout = jdev.FastRootLayout(layout.depth, layout.height, layout.shared_rk,
                                  layout.leaf_blocks)
    if distinct:
        want = _jax_vmapped_head(pay, jlayout, head)
    else:
        rk, rkl = jdev.unpack_fast_root_payload(jnp.asarray(pay[0]), jlayout)[6:]
        want = jdev.expand_root_head_lanes(jnp.asarray(pay), jlayout, rk, head)
        want = want[:5] + (rk, want[5], rkl)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape and (_u32(g) == np.asarray(w)).all()


def _operands(seed, q, nw0, levels, n_blk, distinct):
    """Random seed, t and fcw words; round keys and correction words as
    0/~0 masks, the form the payload unpack gives them."""
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    rk, rkl = ((masks(q, 11, 8, 3, 16, 1), masks(q, 11, 8, 16, 1)) if distinct
               else (masks(11, 8, 3, 16, 1), masks(11, 8, 16, 1)))
    fcw = words(q, 8, n_blk, 16, 1) if n_blk > 1 else words(q, 8, 16, 1)
    return [words(q, 8, 16, nw0), words(q, 1, nw0), masks(q, levels, 8, 16, 1),
            masks(q, levels), masks(q, levels), rk, fcw, rkl]


def _t(ops):
    return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)) for x in ops]


@pytest.mark.parametrize("levels,distinct,n_blk", [
    (0, False, 1), (1, True, 2), (2, False, 2), (2, True, 1)])
def test_plain_tail_matches_pallas_interpret(levels, distinct, n_blk):
    q, nw0 = 3, 2
    ops = _operands(30 + levels + 2 * n_blk + distinct, q, nw0, levels, n_blk, distinct)
    want = np.asarray(fast_tail_expand_pallas(*ops, levels=levels, interpret=True))
    got = fast_tail_expand(*_t(ops), levels=levels)
    assert got.shape == want.shape == (q, 8, 16, n_blk * (nw0 << levels))
    assert (_u32(got) == want).all()


@pytest.mark.parametrize("levels", [0, 2])
def test_plain_fused_matches_pallas_interpret(levels):
    h, b, q, qe, nw0 = 2048, 8, 16, 2, 1
    rng = np.random.default_rng(levels)
    table = rng.integers(0, 256, size=(h, b), dtype=np.uint8)
    words = rng.integers(0, 1 << 32, size=(h // 32, q), dtype=np.uint64).astype(np.uint32)
    ops = _operands(50 + levels, qe, nw0, levels, 1, False)
    q_slice, br, bc = fused_geometry(h, b, q, qe)
    want = fused_scan_expand_pallas(table, words, *ops, levels=levels, q_slice=q_slice,
                                    block_rows=br, block_cols=bc, interpret=True)
    got = fused_scan_expand(torch.from_numpy(table), _t([words])[0], *_t(ops), levels=levels)
    assert (got[0].numpy() == np.asarray(want[0])).all()
    assert (_u32(got[1]) == np.asarray(want[1])).all()


def test_fused_wrapper_refuses_distinct_keys_and_wide_leaves():
    table = torch.zeros((64, 8), dtype=torch.uint8)
    words = torch.zeros((2, 4), dtype=torch.int32)
    for distinct, n_blk in ((True, 1), (False, 2)):
        ops = _t(_operands(1, 2, 1, 1, n_blk, distinct))
        with pytest.raises(ValueError, match="batch-shared keys and 128-bit leaves"):
            fused_scan_expand(table, words, *ops, levels=1)


# ---- whole batches through both servers, fast_stacked=False ---------------


def _servers(slot):
    db = generate_random_db(HEIGHT, slot)
    jsrv = TpuPirServer(db, use_pallas=True, fast_stacked=False, fast_nonshared_chunk=4)
    tsrv = TorchPirServer(database_from_numpy(db.data, slot), device="cpu",
                          fast_stacked=False, fast_nonshared_chunk=4)
    return db, jsrv, tsrv


@pytest.fixture(scope="module")
def servers():
    return _servers(8)


@pytest.fixture(scope="module")
def servers3():
    """3-byte slots: rows that are not whole 4-byte words."""
    return _servers(3)


def _answers(srv, shares):
    return np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8)
                     for r in srv.private_secret_shared_query_batch(shares)])


def _check_batch(servers, kind):
    db, jsrv, tsrv = servers
    md = db.metadata()
    idxs = [int(i) for i in np.random.default_rng(len(kind)).integers(0, HEIGHT, size=9)]
    if kind == "distinct":
        pairs = [jq.new_index_query_shares(md, i, 1, 2, fast=True) for i in idxs]
    else:
        pairs = jq.new_index_query_shares_batch(md, idxs, 1, 2, fast=True,
                                                leaf_bits=128 if kind == "leaf128" else None)
    got = []
    for part in (0, 1):
        shares = [p[part] for p in pairs]
        want = _answers(jsrv, shares)
        got.append(_answers(tsrv, to_port(shares)))
        assert (got[part] == want).all(), f"share {part} differs"
    assert ((got[0] ^ got[1]) == db.data[idxs]).all()


@pytest.mark.parametrize("kind", ["shared", "distinct", "leaf128"])
def test_pertail_batches_match_pir_tpu(servers, kind):
    """Shared keys (default leaves: 256 bits at 2^13 rows, depth 5, no
    tail level), distinct keys (9 queries, chunked at 4) and 128-bit
    leaves (depth 6, one tail level)."""
    _check_batch(servers, kind)


def test_pertail_3_byte_rows_match_pir_tpu(servers3):
    _check_batch(servers3, "leaf128")


@pytest.mark.parametrize("stacked", [True, False])
def test_padded_tables_match_pir_tpu(servers3, stacked):
    """The port pads each stored row to a multiple of 4 bytes: its first
    B columns equal TpuPirServer's table, the rest are zero."""
    db, jsrv, tsrv = servers3
    b = db.slot_bytes
    for depth, n_blk in ((5, 2), (6, 1)):
        want = np.asarray(jsrv._root_table_u8(1, depth, n_blk, stacked=stacked))
        got = tsrv._root_table_u8(1, depth, n_blk, stacked=stacked).numpy()
        assert got.shape == (want.shape[0], -(-b // 4) * 4)
        assert (got[:, :b] == want).all() and not got[:, b:].any()
