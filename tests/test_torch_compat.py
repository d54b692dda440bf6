"""pir_tpu_torch's compat (reference-exact) path vs pir_tpu.

The same inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port: keygen on one random stream, the
host golden model on the frozen vectors, the payload, storage order and
table, the compat stage, and whole batches through both servers. Every
comparison is on equal bytes (tolerance 0).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pir_tpu import query as jq
from pir_tpu import server as jsrv_mod
from pir_tpu import wire
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu.models import pipeline as jpipe
from pir_tpu.ops.pallas_expand import compat_stage_pallas
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import query as tq
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.models.pipeline import compat_head
from pir_tpu_torch.ops import compat_head as head_op
from pir_tpu_torch.ops.compat_stage import compat_stage, compat_stage_plain
from pir_tpu_torch import server as tsrv_mod
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import compat_share_from_fields, database_from_numpy
from pir_tpu_torch.utils import bits as tbits
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLOT = 3
VEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors", "dpf_golden.json")
# the geometries tests/test_pallas_compat.py runs: (height, w, max_tail)
GEOMETRIES = [
    (1 << 10, 8, 3),   # power of two: skip 1, device_bits 10, tails (2,)
    (1 << 10, 4, 2),   # two stages: split 7, tails (2, 1)
    (1000, 8, 3),      # no skip, device_bits 10
    (1 << 11, 8, 2),   # skip 1, device_bits 11, tails (2, 1)
]


def _u32(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).view(np.uint32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).view(np.int32))


def to_port(shares):
    """pir_tpu compat shares -> port shares, one PrfKey list per key set."""
    keysets = {}
    out = []
    for s in shares:
        k = s.key_two_party
        keys = keysets.setdefault(id(s.prf_keys), [thost.PrfKey(p.bytes) for p in s.prf_keys])
        out.append(compat_share_from_fields(
            prf_keys=keys, s_init=k.s_init, t_init=k.t_init, cw=k.cw, final_cw=k.final_cw,
            share_number=s.share_number, group_size=s.group_size))
    return out


class _Stream:
    """One seeded byte stream handed to both packages' keygens."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, n):
        return self.rng.bytes(n)


def _key_fields(share):
    k = share.key_two_party
    return (k.s_init, k.t_init, list(k.cw), k.final_cw,
            [p.bytes for p in share.prf_keys], share.share_number)


@pytest.mark.parametrize("height", [1 << 10, 1000, 37])
def test_compat_keygen_matches_pir_tpu(monkeypatch, height):
    """Single and batch keygen on the same random stream give the same keys."""
    md = tq.DBMetadata(SLOT, height)
    idxs = [0, height // 2, height - 1]
    monkeypatch.setattr(os, "urandom", _Stream(height))
    want = [jq.new_index_query_shares(md, i, 1, 2) for i in idxs]
    want_b = jq.new_index_query_shares_batch(md, idxs, 1, 2)
    monkeypatch.undo()
    src = _Stream(height)
    got = [tq.new_index_query_shares(md, i, 1, rand_bytes=src) for i in idxs]
    got_b = tq.new_index_query_shares_batch(md, idxs, 1, rand_bytes=src)
    for w_pairs, g_pairs in ((want, got), (want_b, got_b)):
        for wp, gp in zip(w_pairs, g_pairs):
            assert [_key_fields(s) for s in gp] == [_key_fields(s) for s in wp]
            assert all(s.key_fast is None and s.is_two_party for s in gp)
    with pytest.raises(ValueError, match="outside"):
        tq.new_index_query_shares_batch(md, [height], 1)


def test_bits_utils_match_pir_tpu():
    from pir_tpu.utils import bits as jbits

    for h in (1, 2, 3, 1000, 1 << 10, (1 << 20) - 1, 1 << 20, (1 << 29) + 7):
        assert tbits.num_bits_for_height(h) == jbits.num_bits_for_height(h)
    for nb in (1, 5, 11):
        assert (tbits.bitrev_permutation(nb) == jbits.bitrev_permutation(nb)).all()
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, size=(4096, 8), dtype=np.uint8)
    buf[:300] |= 0x80  # all-continuation rows decode to 0
    assert (tbits.go_varint_vec(buf) == jbits.go_varint_vec(buf)).all()
    assert all(tbits.go_varint(bytes(r)) == jbits.go_varint(bytes(r)) for r in buf[:64])
    assert all(tbits.get_bit(0b1011, p, 4) == jbits.get_bit(0b1011, p, 4) for p in range(1, 5))


def test_host_golden_matches_frozen_vectors():
    with open(VEC) as f:
        cases = json.load(f)["two_party"]
    for case in cases:
        nb, h = case["num_bits"], case["height"]
        pf = thost.server_initialize([thost.PrfKey(bytes.fromhex(k)) for k in case["prf_keys"]],
                                     nb)
        for sn in (0, 1):
            jk, _ = wire.deserialize_key2p(memoryview(bytes.fromhex(case[f"key{sn}"])))
            key = thost.Key2P(jk.s_init, jk.t_init, list(jk.cw), jk.final_cw)
            assert thost.eval_full_domain(pf, sn, key)[:h].tolist() == case[f"values{sn}"]
            bits = thost.eval_full_domain_bits(pf, sn, key, h).astype(np.uint8)
            assert bits.tolist() == case[f"bits{sn}"]
            for x in sorted({0, case["a"], h - 1}):
                assert thost.evaluate_2p(pf, sn, key, x) == case[f"values{sn}"][x]


@pytest.mark.parametrize("height,w,max_tail", GEOMETRIES)
def test_payload_plan_perm_and_table_match_pir_tpu(height, w, max_tail):
    db = generate_random_db(height, SLOT)
    pairs = jq.new_index_query_shares_batch(db.metadata(), [1, 5, height - 1], 1, 2)
    shares = [p[0] for p in pairs]
    want, jlayout = jdev.make_compat_payload_batch(shares, height=height)
    got, layout = tdev.make_compat_payload_batch(to_port(shares), height=height)
    assert (got == want).all() and got.dtype == np.uint32
    assert (layout.num_bits, layout.skip, layout.device_bits, layout.total) == (
        jlayout.num_bits, jlayout.skip, jlayout.device_bits, jlayout.total)
    nbd = layout.device_bits
    assert tdev.compat_stage_plan(nbd, w, max_tail) == jdev.compat_stage_plan(nbd, w, max_tail)
    _, tails = tdev.compat_stage_plan(nbd, w, max_tail)
    assert (tdev._compat_perm(nbd, height, w, tails)
            == jdev._compat_perm_pallas(nbd, height, w, tails)).all()
    jsrv = TpuPirServer(db, use_pallas=True)
    tsrv = TorchPirServer(database_from_numpy(db.data, SLOT), device="cpu")
    want_t = np.asarray(jsrv._compat_root_table_u8(1, nbd, w, tails))
    got_t = tsrv._compat_root_table_u8(1, nbd, w, tails).numpy()
    # the port pads each row with zero bytes to a multiple of 4
    assert got_t.dtype == np.uint8 and got_t.shape == (want_t.shape[0], 4)
    assert (got_t[:, :SLOT] == want_t).all() and not got_t[:, SLOT:].any()


def test_skip_levels_match_pir_tpu():
    for nb, h in [(11, 1 << 10), (10, 1000), (1, 1), (21, 1 << 20), (3, 2), (5, 9)]:
        assert tdev.compat_skip_levels(nb, h) == jdev.compat_skip_levels(nb, h)


def _jax_head(payloads, layout, w, max_tail):
    split, _ = jdev.compat_stage_plan(layout.device_bits, w, max_tail)
    sk = layout.skip

    def head(payload):
        seeds, t, cw_s, cw_tl, cw_tr, fcw, rk = jdev.unpack_compat_root_payload(payload, layout)
        seeds, t = jpipe._compat_skip_walk(seeds, t, cw_s, cw_tl, cw_tr, rk, sk)
        return jdev.expand_planes_from_root(seeds, t, cw_s[sk:sk + split], cw_tl[sk:sk + split],
                                            cw_tr[sk:sk + split], rk, split)

    return jax.jit(jax.vmap(head))(jnp.asarray(payloads))


@functools.lru_cache(maxsize=None)
def _jax_shard_head(layout, w, levels):
    """pir_tpu's sharded compat root step's head (parallel/mesh.py
    make_sharded_compat_root_step): skip walk, the shard's prefix walk
    with the shard index traced (one compile a geometry), root-start
    levels."""
    split = 5 + w.bit_length() - 1
    sk = layout.skip

    def head(payload, index):
        seeds, t, cw_s, cw_tl, cw_tr, _, rk = jdev.unpack_compat_root_payload(payload, layout)
        seeds, t = jpipe._compat_skip_walk(seeds, t, cw_s, cw_tl, cw_tr, rk, sk)
        for lv in range(levels):
            s_l, t_l, s_r, t_r = jdev._children(jdev._prf_triple(seeds, rk), t, cw_s[sk + lv],
                                                cw_tl[sk + lv], cw_tr[sk + lv])
            m = jnp.uint32(0) - ((index >> (levels - 1 - lv)) & 1).astype(jnp.uint32)
            seeds, t = s_l ^ ((s_l ^ s_r) & m), t_l ^ ((t_l ^ t_r) & m)
        lo = sk + levels
        return jdev.expand_planes_from_root(seeds, t, cw_s[lo:lo + split], cw_tl[lo:lo + split],
                                            cw_tr[lo:lo + split], rk, split)

    return jax.jit(jax.vmap(head, in_axes=(0, None)))


@pytest.mark.parametrize("height,w,index,levels", [
    (1 << 8, 2, 0, 1), (1 << 8, 2, 1, 1), (1 << 8, 2, 2, 2), (1 << 8, 2, 3, 2),
])
def test_compat_head_shard_prefix_matches_pir_tpu(height, w, index, levels):
    """The port's head with shard = (index, levels) on the CPU (the plain
    walk: skip, the moved prefix walk, root-start levels) equals pir_tpu's
    sharded step's head; skip 1 (power of two) and 0, both path bits."""
    db = generate_random_db(height, SLOT)
    idxs = [0, 150, height - 1]
    pairs = [jq.new_index_query_shares(db.metadata(), i, 1, 2) for i in idxs]
    shares = to_port([p[0] for p in pairs])
    pay, layout = tdev.make_compat_payload_batch(shares, height=height)
    seeds, t, cw_s, cw_tl, cw_tr, rk, _ = compat_head(tdev.u32_tensor(pay, "cpu"), layout, w,
                                                      shard=(index, levels))
    js, jt = _jax_shard_head(layout, w, levels)(jnp.asarray(pay), jnp.int32(index))
    assert (_u32(seeds[:, :, 0]) == np.asarray(js)).all()
    assert (_u32(t).reshape(len(idxs), w) == np.asarray(jt)).all()
    lv = layout.skip + levels + 5 + w.bit_length() - 1
    assert cw_s.shape[1] == cw_tl.shape[1] == cw_tr.shape[1] == layout.num_bits - lv


def test_compat_head_rejects_what_the_kernel_does_not_take():
    height, w = 1 << 11, 8
    shares = to_port([jq.new_index_query_shares(generate_random_db(height, SLOT).metadata(),
                                                5, 1, 2)[0]])
    pay, layout = tdev.make_compat_payload_batch(shares, height=height)
    seeds, t, cw_s, cw_tl, cw_tr, _, rk = tdev.unpack_compat_root_payload(
        tdev.u32_tensor(pay, "cpu"), layout)
    ops = (seeds, t, cw_s, cw_tl, cw_tr, rk)
    with pytest.raises(ValueError, match="power of two"):
        head_op.compat_head(*ops, skip=1, w=6)
    with pytest.raises(ValueError, match="exceed"):
        head_op.compat_head(*ops, skip=1, w=8, shard=(0, 4))  # 1 + 4 + 8 > 12 levels
    with pytest.raises(ValueError, match="prefix"):
        head_op.compat_head(*ops, skip=1, w=8, shard=(2, 1))
    with pytest.raises(ValueError, match="cw_tl"):
        head_op.compat_head(seeds, t, cw_s, cw_tl[:, :3], cw_tr, rk, skip=1, w=8)
    with pytest.raises(ValueError, match="rk"):
        head_op.compat_head(seeds, t, cw_s, cw_tl, cw_tr, rk.to(torch.int64), skip=1, w=8)
    assert head_op.compat_head.launches == 0  # the CPU runs the plain walk


@pytest.fixture(scope="module")
def stage_ops():
    """The port's compat head on JAX shares at (2^11, w=8, max_tail 2):
    the two stages' operands (tails (2, 1)), checked against JAX's head."""
    height, w, max_tail = 1 << 11, 8, 2
    db = generate_random_db(height, SLOT)
    idxs = [0, 77, 1500, height - 1]
    pairs = [jq.new_index_query_shares(db.metadata(), i, 1, 2) for i in idxs]  # own keys
    shares = to_port([p[1] for p in pairs])
    pay, layout = tdev.make_compat_payload_batch(shares, height=height)
    ops = compat_head(tdev.u32_tensor(pay, "cpu"), layout, w)
    js, jt = _jax_head(pay, layout, w, max_tail)
    assert (_u32(ops[0][:, :, 0]) == np.asarray(js)).all()
    assert (_u32(ops[1]).reshape(len(idxs), w) == np.asarray(jt)).all()
    return ops


@pytest.mark.parametrize("emit_bits", [False, True])
def test_compat_stage_plain_matches_pallas(stage_ops, emit_bits):
    seeds, t, cw_s, cw_tl, cw_tr, rk, fcw = stage_ops
    for off, tail in ((0, 2), (2, 1)):
        ops = (seeds, t, cw_s[:, off:off + tail].contiguous(),
               cw_tl[:, off:off + tail].contiguous(), cw_tr[:, off:off + tail].contiguous(),
               rk, fcw)
        want = compat_stage_pallas(*(jnp.asarray(_u32(x)) for x in ops), tail=tail,
                                   emit_bits=emit_bits, interpret=True)
        got = compat_stage(*ops, tail=tail, emit_bits=emit_bits)
        one = compat_stage_plain(*ops, tail=tail, emit_bits=emit_bits, q_chunk=1)
        if emit_bits:
            got, one, want = (got,), (one,), (want,)
        for g, o, wnt in zip(got, one, want):
            assert (_u32(g) == np.asarray(wnt)).all() and torch.equal(g, o)
        if not emit_bits:
            seeds, t = got


def test_compat_stage_rejects_what_the_kernel_does_not_take(stage_ops):
    seeds, t, cw_s, cw_tl, cw_tr, rk, fcw = stage_ops
    cw4 = cw_s.new_zeros((seeds.shape[0], 4, 8, 16, 1))
    tl4 = cw_tl.new_zeros((seeds.shape[0], 4))
    with pytest.raises(ValueError, match="1..3"):
        compat_stage(seeds, t, cw4, tl4, tl4, rk, fcw, tail=4, emit_bits=True)
    with pytest.raises(ValueError, match="cw_s"):
        compat_stage(seeds, t, cw_s, cw_tl[:, :2], cw_tr[:, :2], rk, fcw, tail=2,
                     emit_bits=True)
    with pytest.raises(ValueError, match="seeds"):
        compat_stage(seeds.to(torch.int64), t, cw_s[:, :2], cw_tl[:, :2], cw_tr[:, :2], rk,
                     fcw, tail=2, emit_bits=True)


def _answers(results):
    return np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8) for r in results])


def _golden(db, share):
    return np.frombuffer(bytes(jsrv_mod.private_secret_shared_query(db, share).shares[0].data),
                         np.uint8)


def _cascade(monkeypatch, w_max=None, max_tail=None, q_chunk=None, batch_cap=None):
    """Set the port server's compat cascade constants for one test."""
    for name, v in (("COMPAT_MAX_W", w_max), ("COMPAT_MAX_TAIL", max_tail),
                    ("COMPAT_Q_CHUNK", q_chunk), ("COMPAT_BATCH_CAP", batch_cap)):
        if v is not None:
            monkeypatch.setattr(tsrv_mod, name, v)


@pytest.mark.parametrize("height,w,max_tail", GEOMETRIES)
def test_compat_batches_match_pir_tpu_and_golden(monkeypatch, height, w, max_tail):
    db = generate_random_db(height, SLOT)
    jsrv = TpuPirServer(db, use_pallas=True, compat_pallas_w=w,
                        compat_pallas_max_tail=max_tail, compat_pallas_q_chunk=4)
    _cascade(monkeypatch, w_max=w, max_tail=max_tail, q_chunk=4)
    tsrv = TorchPirServer(database_from_numpy(db.data, SLOT), device="cpu")
    nbd = tsrv._compat_device_bits(1)
    assert tsrv._compat_geometry(1) == (nbd, w, jdev.compat_stage_plan(nbd, w, max_tail)[1])
    rng = np.random.default_rng(height + w)
    idxs = [0] + [int(i) for i in rng.integers(0, height, size=6)] + [height - 1]
    pairs = jq.new_index_query_shares_batch(db.metadata(), idxs, 1, 2)
    got = []
    for part in (0, 1):
        jshares = [p[part] for p in pairs]
        want = _answers(jsrv.private_secret_shared_query_batch(jshares))
        got.append(_answers(tsrv.private_secret_shared_query_batch(to_port(jshares))))
        assert (got[part] == want).all(), f"share {part} differs from TpuPirServer"
        for k, s in enumerate(jshares):
            assert (got[part][k] == _golden(db, s)).all(), (part, k)
    assert ((got[0] ^ got[1]) == db.data[idxs]).all()


def test_compat_geometry_derives_the_lane_width():
    """w is the largest power of two <= 128 that leaves a stage after the
    5 + log2(w)-level head; the stages then take at most 3 levels."""
    for rows, want in [(1 << 20, (20, 128, (3, 3, 2))), (1 << 13, (13, 128, (1,))),
                       (1000, (10, 16, (1,))), (1 << 6, (6, 1, (1,))),
                       ((1 << 14) + 1, (15, 128, (3,)))]:
        db = database_from_numpy(np.zeros((rows, SLOT), np.uint8), SLOT)
        assert TorchPirServer(db, device="cpu")._compat_geometry(1) == want, rows


@pytest.fixture(scope="module")
def port_server():
    """A port server on 2^10 rows (device_bits 10)."""
    db = generate_random_db(1 << 10, SLOT)
    return db, TorchPirServer(database_from_numpy(db.data, SLOT), device="cpu")


def test_q_chunk_padding_cap_and_async_change_no_byte(monkeypatch, port_server):
    """At w = 8 (stages (2,)): 10 queries (stage slices of 4, 4, 2 under
    q_chunk 4; 8, 2 under 8) and 37 queries (dispatch slices of 16, 16, 5
    at a cap of 16) give the same bytes under both q_chunk values,
    through the sync and the async entry points, and equal the host
    golden model."""
    db, srv = port_server
    _cascade(monkeypatch, w_max=8, batch_cap=16)
    rng = np.random.default_rng(11)
    for n in (10, 37):
        idxs = [int(i) for i in rng.integers(0, db.db_size, size=n)]
        pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, rand_bytes=rng.bytes)
        out = []
        for part in (0, 1):
            batch = [p[part] for p in pairs]
            _cascade(monkeypatch, q_chunk=4)
            a = _answers(srv.private_secret_shared_query_batch(batch))
            _cascade(monkeypatch, q_chunk=8)
            b = _answers(srv.private_secret_shared_query_batch_async(batch)())
            assert (a == b).all()
            out.append(a)
        assert ((out[0] ^ out[1]) == db.data[idxs]).all()
    pf = thost.server_initialize(pairs[0][0].prf_keys, len(pairs[0][0].key_two_party.cw))
    for k in (0, n - 1):
        bits = thost.eval_full_domain_bits(pf, 0, pairs[k][0].key_two_party, db.db_size)
        want = np.bitwise_xor.reduce(db.data[bits], axis=0)
        assert (out[0][k] == want).all()


@pytest.mark.parametrize("rows", [1 << 6, 1 << 8, 100])
def test_small_compat_tables_are_served(rows):
    """Tables of 6 to 8 device levels, below the 12-level head of w = 128,
    run a narrower cascade (w = 1, 4, 2) and equal the host golden."""
    db = generate_random_db(rows, SLOT)
    srv = TorchPirServer(database_from_numpy(db.data, SLOT), device="cpu")
    rng = np.random.default_rng(rows)
    idxs = [0] + [int(i) for i in rng.integers(0, rows, size=7)] + [rows - 1]
    pairs = jq.new_index_query_shares_batch(db.metadata(), idxs, 1, 2)
    got = [_answers(srv.private_secret_shared_query_batch(to_port([p[part] for p in pairs])))
           for part in (0, 1)]
    for k, p in enumerate(pairs):
        assert (got[0][k] == _golden(db, p[0])).all() and (got[1][k] == _golden(db, p[1])).all()
    assert ((got[0] ^ got[1]) == db.data[idxs]).all()


def thost_golden(db, share) -> bytes:
    return bytes(tsrv_mod.private_secret_shared_query(db, share).shares[0].data)


def test_compat_batches_the_port_cannot_serve_raise(port_server):
    db, srv = port_server
    md = db.metadata()
    rng = np.random.default_rng(5)
    compat = [p[0] for p in tq.new_index_query_shares_batch(md, list(range(8)), 1,
                                                            rand_bytes=rng.bytes)]
    fast = tq.new_index_query_shares_batch(md, [3], 1, fast=True, rand_bytes=rng.bytes)[0][0]
    with pytest.raises(ValueError, match="mix fast and compat"):
        srv.private_secret_shared_query_batch(compat[:7] + [fast])
    with pytest.raises(ValueError, match="mix fast and compat"):
        srv.private_secret_shared_query_batch([fast] + compat[:7])
    # below MIN_BATCH the batch runs per query (it raised before that path)
    for k, r in enumerate(srv.private_secret_shared_query_batch(compat[:7])):
        assert bytes(r.shares[0].data) == thost_golden(db, compat[k])
    k = compat[0].key_two_party
    crafted = compat_share_from_fields(prf_keys=compat[0].prf_keys, s_init=k.s_init,
                                       t_init=k.t_init, cw=k.cw * 3, final_cw=k.final_cw,
                                       share_number=0, group_size=1)
    with pytest.raises(ValueError, match="geometry"):
        srv.private_secret_shared_query_batch(compat[:7] + [crafted])
    # 2^5 rows: 6 bits, skip 1, 5 device levels: no stage after a 5-level head
    small = TorchPirServer(database_from_numpy(db.data[:32], SLOT), device="cpu")
    shallow = [p[0] for p in tq.new_index_query_shares_batch(small.db.metadata(),
                                                             list(range(8)), 1)]
    assert small._compat_device_bits(1) == 5
    for k, r in enumerate(small.private_secret_shared_query_batch(shallow)):
        assert bytes(r.shares[0].data) == thost_golden(small.db, shallow[k])
