"""pir_tpu_torch's single queries and small batches vs pir_tpu.

The same shares, made by the JAX package's keygen and carried across with
pir_tpu_torch.state, go through both packages: the per-query device keys,
payloads and expansions (dpf/device.py, models/pipeline.py), then
TorchPirServer (on the CPU, the kernels' plain versions) against
TpuPirServer (on the CPU, its XLA paths) through
private_secret_shared_query, expand_shared_query +
private_secret_shared_query_with_expanded_bits and small batches, and
against the host golden model. Answers are exact XORs: tolerance 0.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from pir_tpu import query as jq
from pir_tpu.database import DBMetadata as JDBMetadata
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu import server as jsrv_mod
from pir_tpu.models import pipeline as jpipe
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import server as tsrv_mod
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.entry import entry as port_entry
from pir_tpu_torch.models import pipeline as tpipe
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import (
    compat_share_from_fields,
    database_from_numpy,
    device_fast_key_from_numpy,
    device_key_from_numpy,
    share_from_fields,
)
from pir_tpu_torch.utils.bits import num_bits_for_height
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("seeds0", "t0", "cw_seed_masks", "cw_tl", "cw_tr", "rk_masks", "perm", "host_bits")
# (db rows, slot bytes, group size): 2^13 grid rows of 16 bytes, as one
# slot or as two of 8 (fast depth 5 at the default width, clamped to
# 256-bit leaves). Equal grid shapes let the JAX package compile each of
# its programs once for both; 3-byte slots run in the tiny-table test.
CONFIGS = {"g1s16": (1 << 13, 16, 1), "g2s8": (1 << 14, 8, 2)}
# the slice's servers walk levels on the host until this many nodes are
# live, leaving compat shares 1 device level: the JAX package compiles one
# program per level count and batch size, which the CPU run pays for
MIN_DEVICE_NODES = 4096


def _u32(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = _u32(a), _u32(b)
    return a.shape == b.shape and np.array_equal(a, b)


def to_port(shares):
    """pir_tpu index shares -> port shares, one PrfKey list per key set."""
    keysets, out = {}, []
    for s in shares:
        keys = keysets.setdefault(id(s.prf_keys), [thost.PrfKey(k.bytes) for k in s.prf_keys])
        common = dict(prf_keys=keys, share_number=s.share_number, group_size=s.group_size)
        if s.key_fast is not None:
            k = s.key_fast
            out.append(share_from_fields(s_init=k.s_init, t_init=k.t_init, cw=k.cw,
                                         final_cw_block=k.final_cw_block, depth=k.depth,
                                         height=k.height, **common))
        else:
            k = s.key_two_party
            out.append(compat_share_from_fields(s_init=k.s_init, t_init=k.t_init, cw=k.cw,
                                                final_cw=k.final_cw, **common))
    return out


def _port_dpf(prf_keys, num_bits):
    return thost.server_initialize([thost.PrfKey(k.bytes) for k in prf_keys], num_bits)


# ---- modules 1-3: device keys, payloads, expansions -----------------------

@pytest.mark.parametrize("height,mdn,jax_expand", [
    (1 << 10, 32, False), ((1 << 10) + 37, 32, False),
    (20, 32, False),     # every level on the host (host_bits)
    (1 << 10, 256, True),  # 2 device levels: JAX's expand_query_bits compiles 2 widths
])
def test_compat_device_key_payload_and_bits_match_pir_tpu(height, mdn, jax_expand):
    """Arrays and payloads equal the JAX package's; the expansion equals
    its host golden bits, and its expand_query_bits where jax_expand."""
    nb = num_bits_for_height(height)
    share = jq.new_index_query_shares(JDBMetadata(4, height), height // 3, 1, 2)[1]
    pf_j = jhost.server_initialize(share.prf_keys, nb)
    dj = jdev.make_device_key(pf_j, share.key_two_party, height, mdn)
    dt = tdev.make_device_key(_port_dpf(share.prf_keys, nb), to_port([share])[0].key_two_party,
                              height, mdn)
    assert dt.plan == tdev.ExpandPlan(**vars(dj.plan))
    for f in FIELDS + ("fcw_mask",):
        assert _same(getattr(dj, f), getattr(dt, f)), f
    got = tdev.expand_query_bits(dt, "cpu")
    golden = jhost.eval_full_domain_bits(pf_j, share.share_number, share.key_two_party, height)
    assert got.dtype == torch.uint8 and (got.numpy().astype(bool) == golden).all()
    if jax_expand:
        assert _same(np.asarray(jdev.expand_query_bits(dj)), got)
    if dj.host_bits is not None:
        assert dt.plan.device_levels == 0 and tdev.make_key_payload(
            _port_dpf(share.prf_keys, nb), to_port([share])[0].key_two_party, height)[1] is None
        return
    pj, lj = jdev.pack_key_payload(dj)
    pt, lt = tdev.pack_key_payload(dt)
    assert (pj == pt).all() and vars(lj) == vars(lt)
    assert _same(got, tpipe.fused_bits(tdev.u32_tensor(pt, "cpu"), torch.from_numpy(dt.perm), lt))


@pytest.mark.parametrize("height,leaf_bits,mdn,jax_bits", [
    (1 << 10, 128, 32, False),          # depth 3: every level on the host
    ((1 << 10) + 37, 1024, 32, False),  # depth 1, wide leaves, host bits
    ((1 << 10) + 37, 128, 2, False),    # ragged height, device 3 levels
    (1 << 13, 1024, 2, True),           # wide leaves on the device
    (1 << 13, 128, 32, False),          # depth 6 at the default: device 1 level
])
def test_fast_device_key_payload_and_bits_match_pir_tpu(height, leaf_bits, mdn, jax_bits):
    """Arrays and payloads equal the JAX package's; fused_fast_bits equals
    its host golden bits, and its fused_fast_bits_fn where jax_bits (one
    JAX compile a layout, which the CPU run pays for)."""
    depth = jhost.fast_depth_for_height(height, leaf_bits)
    pf_j = jhost.client_initialize(depth)
    key = jhost.generate_two_server_fast(pf_j, (height * 2) // 3, height, leaf_bits)[0]
    pf_t = _port_dpf(pf_j.prf_keys, depth)
    key_t = thost.FastKey2P(key.s_init, key.t_init, list(key.cw), key.final_cw_block,
                            key.depth, key.height)
    dj = jdev.make_device_fast_key(pf_j, key, mdn)
    dt = tdev.make_device_fast_key(pf_t, key_t, mdn)
    assert pf_t.num_bits == depth  # restored after the host prefix
    assert dt.plan == tdev.ExpandPlan(**vars(dj.plan)) and dt.height == dj.height
    for f in FIELDS + ("fcw_masks", "rk_leaf"):
        assert _same(getattr(dj, f), getattr(dt, f)), f
    if dj.host_bits is not None:
        return
    pj, lj = jdev.pack_fast_payload(dj)
    pt, lt = tdev.pack_fast_payload(dt)
    assert (pj == pt).all() and vars(lj) == vars(lt)
    got = tpipe.fused_fast_bits(tdev.u32_tensor(pt, "cpu"), torch.from_numpy(dt.perm), lt)
    assert (got.numpy().astype(bool) == jhost.eval_full_domain_fast_bits(pf_j, key)).all()
    if jax_bits:
        assert _same(np.asarray(jpipe.fused_fast_bits_fn(lj)(pj, dj.perm)), got)
    # the JAX key's own arrays, carried across by state.py
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk, rk_leaf, perm = device_fast_key_from_numpy(
        seeds0=dj.seeds0, t0=dj.t0, cw_seed_masks=dj.cw_seed_masks, cw_tl=dj.cw_tl,
        cw_tr=dj.cw_tr, fcw_masks=dj.fcw_masks, rk_masks=dj.rk_masks, rk_leaf=dj.rk_leaf,
        perm=dj.perm, device="cpu")
    seeds, t = tpipe._expand_planes_loop(seeds, t, cw_s, cw_tl, cw_tr, rk, lt.d_levels)
    assert _same(got, tdev.fast_leaf_bits(seeds, t, fcw, rk_leaf, perm))


def test_entry_matches_pir_tpu_entry():
    """The port's answer step on the JAX entry's own arguments."""
    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = port_entry(device="cpu")
    assert fn.keywords == {"d_levels": jargs[3].shape[0]}
    names = ("seeds0", "t0", "cw_seed_masks", "cw_tl", "cw_tr", "rk_masks", "fcw_mask", "perm")
    key = device_key_from_numpy(device="cpu", **dict(zip(names, jargs[1:])))
    table = torch.from_numpy(np.ascontiguousarray(jargs[0]).view(np.int32))
    assert _same(want, fn(table, *key))
    assert fn(*args).shape == (16,) and all(a.device.type == "cpu" for a in args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_entry()


# ---- the slice: TorchPirServer vs TpuPirServer ------------------------------

@pytest.fixture(scope="module", params=sorted(CONFIGS))
def servers(request):
    rows, slot, g = CONFIGS[request.param]
    db = generate_random_db(rows, slot)
    tdb = database_from_numpy(db.data, slot)
    mdn = MIN_DEVICE_NODES
    return (db, g, TpuPirServer(db, min_device_nodes=mdn),
            TorchPirServer(tdb, device="cpu", min_device_nodes=mdn),
            TorchPirServer(tdb, device="cpu", fast_stacked=False, min_device_nodes=mdn))


def _bytes(res):
    return [bytes(s.data) for s in res.shares]


def _recovers(db, g, idx, pair):
    return all(bytes(np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8))
               == db.data[idx * g + c].tobytes() for c, (a, b) in enumerate(zip(*pair)))


def _pir_tpu_answer(jsrv, share) -> list[bytes]:
    """TpuPirServer's answer to one share. Fast shares go through its
    expand + scan API: at depth 5 its host walks every level, while its
    single-query and batch APIs take its root-start batch path, an XLA
    program of ~20 s to compile per table on the CPU, equal in bytes
    (tests/test_torch_server.py holds the port's fast batches against
    that path)."""
    if share.key_fast is None:
        return _bytes(jsrv.private_secret_shared_query(share))
    bits = jsrv.expand_shared_query(share)
    return _bytes(jsrv.private_secret_shared_query_with_expanded_bits(share, bits))


def _keys(db, g, idxs, style, batch=False):
    md = db.metadata()
    fast, lb = style != "compat", (128 if style == "fast128" else None)
    if batch:
        return jq.new_index_query_shares_batch(md, idxs, g, 2, fast=fast, leaf_bits=lb)
    return [jq.new_index_query_shares(md, i, g, 2, fast=fast, leaf_bits=lb) for i in idxs]


@pytest.mark.parametrize("style", ["fast", "compat"])
def test_single_queries_match_pir_tpu(servers, style):
    """Both fast_stacked values for fast shares; indices 0, H - 1 and one
    between; both shares recover the row and equal the host golden."""
    db, g, jsrv, tsrv, tsrv_pt = servers
    h = db.db_size // g
    idxs = [0, h - 1, int(np.random.default_rng(h).integers(h))]
    for idx, pair in zip(idxs, _keys(db, g, idxs, style)):
        answers = []
        for share in pair:
            want = _pir_tpu_answer(jsrv, share)
            port = to_port([share])[0]
            assert _bytes(tsrv.private_secret_shared_query(port)) == want
            if style != "compat":
                assert _bytes(tsrv_pt.private_secret_shared_query(port)) == want
            assert _bytes(tsrv_mod.private_secret_shared_query(tsrv.db, port)) == want
            answers.append(want)
        assert _recovers(db, g, idx, answers)


@pytest.mark.parametrize("style", ["fast", "compat"])
def test_expand_then_scan_matches_pir_tpu(servers, style):
    """Fast keys of depth 5 expand on the host at this min_device_nodes;
    test_fast_device_key_payload_and_bits_match_pir_tpu holds their
    device expansion."""
    db, g, jsrv, tsrv, _ = servers
    h = db.db_size // g
    idx = h // 2
    answers = []
    for share in _keys(db, g, [idx], style)[0]:
        port = to_port([share])[0]
        jbits = np.asarray(jsrv.expand_shared_query(share))
        bits = tsrv.expand_shared_query(port)
        assert bits.dtype == torch.uint8 and bits.shape == (h,) and _same(jbits, bits)
        golden = tsrv_mod.expand_shared_query(tsrv.db, port)
        assert (golden == bits.numpy().astype(bool)).all()
        want = _bytes(jsrv.private_secret_shared_query_with_expanded_bits(share, jbits))
        assert _bytes(tsrv.private_secret_shared_query_with_expanded_bits(port, bits)) == want
        assert _bytes(tsrv.private_secret_shared_query_with_expanded_bits(port, golden)) == want
        answers.append(want)
    assert _recovers(db, g, idx, answers)


@pytest.mark.parametrize("style", ["fast", "compat"])
@pytest.mark.parametrize("n", [1, 3, 7])
def test_small_batches_match_pir_tpu(servers, style, n):
    """TpuPirServer's batch API gives the reference bytes for the compat
    batch of 3; its answers to each share (_pir_tpu_answer) for the other
    batches (the same bytes: its compat batch compiles a program per
    batch size, which the CPU run pays for)."""
    db, g, jsrv, tsrv, tsrv_pt = servers
    h = db.db_size // g
    idxs = [int(i) for i in np.random.default_rng(n * h).integers(0, h, size=n)]
    pairs = _keys(db, g, idxs, style, batch=True)
    got = []
    for part in (0, 1):
        jshares = [p[part] for p in pairs]
        if style == "compat" and n == 3:
            want = [_bytes(r) for r in jsrv.private_secret_shared_query_batch(jshares)]
        else:
            want = [_pir_tpu_answer(jsrv, s) for s in jshares]
        ports = to_port(jshares)
        got.append([_bytes(r) for r in tsrv.private_secret_shared_query_batch(ports)])
        assert got[part] == want, f"share {part} differs from TpuPirServer"
        assert [_bytes(r) for r in tsrv.private_secret_shared_query_batch_async(ports)()] == want
        if style == "fast":
            assert [_bytes(r) for r in tsrv_pt.private_secret_shared_query_batch(ports)] == want
    for i, idx in enumerate(idxs):
        assert _recovers(db, g, idx, (got[0][i], got[1][i]))


@pytest.mark.parametrize("style,rows,g,slot,n", [("compat", 40, 2, 3, 12),
                                                 ("fast", 2048, 2, 3, 12),
                                                 ("fast128", (1 << 10) + 37, 1, 16, 3)])
def test_tiny_table_batches_match_pir_tpu(style, rows, g, slot, n):
    """A compat table of at most 5 device levels (20 grid rows: 5 device
    levels, every one walked on the host) and fast keys of depth < 5 (host
    bits) run per query; 12 queries scan in slices of 8 and 4; 3-byte
    slots make 1-word table rows. The compat batch is held against the
    JAX package's host golden model (TpuPirServer sends it through its
    preplane route, whose compile the CPU run would pay for), the fast
    batches against TpuPirServer."""
    db = generate_random_db(rows, slot)
    tsrv = TorchPirServer(database_from_numpy(db.data, slot), device="cpu")
    h = rows // g
    idxs = [0, h - 1] + [int(i) for i in np.random.default_rng(rows).integers(0, h, size=n - 2)]
    pairs = _keys(db, g, idxs, style, batch=True)
    if style == "compat":
        assert tsrv._compat_device_bits(g) == 5
        want_of = lambda shares: [_bytes(jsrv_mod.private_secret_shared_query(db, s))
                                  for s in shares]
    else:
        assert pairs[0][0].key_fast.depth < 5
        jsrv = TpuPirServer(db)
        want_of = lambda shares: [_bytes(r) for r in jsrv.private_secret_shared_query_batch(shares)]
    got = []
    for part in (0, 1):
        jshares = [p[part] for p in pairs]
        got.append([_bytes(r) for r in tsrv.private_secret_shared_query_batch(to_port(jshares))])
        assert got[part] == want_of(jshares)
    for i, idx in enumerate(idxs):
        assert _recovers(db, g, idx, (got[0][i], got[1][i]))
