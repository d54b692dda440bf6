"""pir_tpu_torch host DPF, bitsliced AES and head walk vs pir_tpu.

Every comparison is on equal bytes: the same inputs, made from a seed
with numpy (or the JAX package's own keygen), go through the JAX package
and through its port.
"""

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from pir_tpu import query as jq
from pir_tpu.database import DBMetadata as JDBMetadata
from pir_tpu.dpf import bitslice as jbs
from pir_tpu.dpf import device as jdev
from pir_tpu.dpf import host as jhost
from pir_tpu.dpf.aes_host import key_schedule_batch as j_key_schedule_batch
from pir_tpu_torch import query as tq
from pir_tpu_torch.database import DBMetadata
from pir_tpu_torch.dpf import bitslice as tbs
from pir_tpu_torch.dpf import device as tdev
from pir_tpu_torch.dpf import host as thost
from pir_tpu_torch.dpf.aes_host import SBOX, EcbCipher, key_schedule_batch
from pir_tpu_torch.models.pipeline import stacked_fast_geometry
from pir_tpu_torch.state import share_from_fields
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).view(np.uint32)


def to_port(shares):
    """pir_tpu fast shares -> port shares, one PrfKey list per key set."""
    keysets = {}
    out = []
    for s in shares:
        kf = s.key_fast
        keys = keysets.setdefault(id(s.prf_keys), [thost.PrfKey(k.bytes) for k in s.prf_keys])
        out.append(share_from_fields(
            prf_keys=keys, s_init=kf.s_init, t_init=kf.t_init, cw=kf.cw,
            final_cw_block=kf.final_cw_block, depth=kf.depth, height=kf.height,
            share_number=s.share_number, group_size=s.group_size))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_aes_ecb_matches_cryptography(seed):
    rng = np.random.default_rng(seed)
    key = rng.bytes(16)
    blocks = rng.integers(0, 256, size=(513, 16), dtype=np.uint8)
    want = Cipher(algorithms.AES(key), modes.ECB()).encryptor().update(blocks.tobytes())
    got = EcbCipher(key).encrypt_blocks(blocks)
    assert got.tobytes() == want


def test_key_schedule_batch_matches_pir_tpu():
    keys = np.random.default_rng(3).integers(0, 256, size=(9, 16), dtype=np.uint8)
    assert (key_schedule_batch(keys) == j_key_schedule_batch(keys)).all()


def test_sub_bytes_exhaustive():
    blocks = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 16, axis=1)
    planes = _t(tbs.blocks_to_planes(blocks))
    out = tbs.planes_to_blocks(_u32(tbs.sub_bytes(planes)), 256)
    assert (out == SBOX[:, None]).all()


def test_plane_packing_matches_pir_tpu():
    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, size=(77, 16), dtype=np.uint8)
    planes = tbs.blocks_to_planes(blocks)
    assert (planes == jbs.blocks_to_planes(blocks)).all()
    assert (tbs.planes_to_blocks(planes, 77) == blocks).all()
    rks = rng.integers(0, 256, size=(3, 11, 16), dtype=np.uint8)
    assert (tbs.key_masks(rks) == jbs.key_masks(rks)).all()


@pytest.mark.parametrize("lanes", [1, 5])
def test_aes_encrypt_planes_matches_pir_tpu(lanes):
    """Random plaintext planes under per-lane (or broadcast) round keys."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5 + lanes)
    x = rng.integers(0, 1 << 32, size=(8, 3, 16, 5), dtype=np.uint64).astype(np.uint32)
    rks = rng.integers(0, 256, size=(3, lanes, 11, 16), dtype=np.uint8)
    masks = jbs.key_masks(rks.reshape(3 * lanes, 11, 16)).reshape(11, 8, 16, 3, lanes)
    masks = np.ascontiguousarray(masks.transpose(0, 1, 3, 2, 4))  # (11,8,3,16,lanes)
    want = np.asarray(jbs.aes_encrypt_planes(jnp.asarray(x), jnp.asarray(masks)))
    got = tbs.aes_encrypt_planes(_t(x), _t(masks))
    assert (_u32(got) == want).all()
    # and against AES-ECB on the un-bitsliced blocks (lane 0, block 1)
    if lanes == 1:
        blocks = tbs.planes_to_blocks(x[:, 1], 160)
        enc = tbs.planes_to_blocks(_u32(got)[:, 1], 160)
        from pir_tpu_torch.dpf.aes_host import aes_encrypt_blocks
        assert (enc == aes_encrypt_blocks(blocks, rks[1, 0])).all()


@pytest.mark.parametrize("leaf_bits", [None, 256])
def test_fast_keygen_golden_matches_pir_tpu(leaf_bits):
    """The port's golden full-domain eval equals pir_tpu's on pir_tpu
    keys, and the port's own keygen selects exactly the target row."""
    height = 1 << 13
    rng = np.random.default_rng(6)
    idxs = [int(i) for i in rng.integers(0, height, size=3)]
    jshares = jq.new_index_query_shares_batch(JDBMetadata(8, height), idxs, 1, 2,
                                              fast=True, leaf_bits=leaf_bits)
    for pair in jshares:
        for s in pair:
            jpf = jhost.server_initialize(s.prf_keys, s.key_fast.depth)
            tpf = thost.server_initialize([thost.PrfKey(k.bytes) for k in s.prf_keys],
                                          s.key_fast.depth)
            ts = to_port([s])[0]
            assert (thost.eval_full_domain_fast_bits(tpf, ts.key_fast)
                    == jhost.eval_full_domain_fast_bits(jpf, s.key_fast)).all()
    seeded = np.random.default_rng(7)
    tshares = tq.new_index_query_shares_batch(DBMetadata(8, height), idxs, 1, fast=True,
                                              leaf_bits=leaf_bits, rand_bytes=seeded.bytes)
    again = tq.new_index_query_shares_batch(DBMetadata(8, height), idxs, 1, fast=True,
                                            leaf_bits=leaf_bits,
                                            rand_bytes=np.random.default_rng(7).bytes)
    for idx, pair, pair2 in zip(idxs, tshares, again):
        assert pair[0].key_fast == pair2[0].key_fast  # a seeded source repeats
        pf = thost.server_initialize(pair[0].prf_keys, pair[0].key_fast.depth)
        bits = (thost.eval_full_domain_fast_bits(pf, pair[0].key_fast)
                ^ thost.eval_full_domain_fast_bits(pf, pair[1].key_fast))
        assert np.flatnonzero(bits).tolist() == [idx]


def _jax_batch(height, n, distinct, leaf_bits=None, seed=8):
    md = JDBMetadata(8, height)
    rng = np.random.default_rng(seed)
    idxs = [int(i) for i in rng.integers(0, height, size=n)]
    if distinct:
        return [jq.new_index_query_shares(md, i, 1, 2, fast=True, leaf_bits=leaf_bits)[0]
                for i in idxs]
    return [p[0] for p in jq.new_index_query_shares_batch(md, idxs, 1, 2, fast=True,
                                                          leaf_bits=leaf_bits)]


@pytest.mark.parametrize("distinct", [False, True])
def test_payload_batch_matches_pir_tpu(distinct):
    jshares = _jax_batch(1 << 13, 5, distinct, leaf_bits=256)
    want, jlayout = jdev.make_fast_payload_batch(jshares)
    got, layout = tdev.make_fast_payload_batch(to_port(jshares))
    assert (got == want).all()
    assert (layout.depth, layout.height, layout.shared_rk, layout.leaf_blocks) == (
        jlayout.depth, jlayout.height, jlayout.shared_rk, jlayout.leaf_blocks)
    assert layout.shared_rk == (not distinct)


@pytest.mark.parametrize("depth,height,n_blk,tail", [
    (6, 1 << 13, 1, 0), (5, 1 << 13, 2, 0), (9, 1 << 16, 1, 2), (10, 1 << 20, 8, 3),
])
def test_storage_perm_and_ctr_masks_match_pir_tpu(depth, height, n_blk, tail):
    got = tdev._fast_leaf_perm_root_stacked(depth, height, n_blk, tail)
    assert (got == jdev._fast_leaf_perm_root_stacked(depth, height, n_blk, tail)).all()
    assert (tdev._leaf_ctr_masks(n_blk) == jdev._leaf_ctr_masks(n_blk)).all()
    rows = np.random.default_rng(9).integers(0, 256, size=(64, 3), dtype=np.uint8)
    perm = np.random.default_rng(10).permutation(80)[:64]
    assert (tdev.scatter_rows_to_storage_order(rows, perm, 80)
            == jdev.scatter_rows_to_storage_order(rows, perm, 80)).all()


@pytest.mark.parametrize("distinct", [False, True])
def test_head_walk_matches_pir_tpu(distinct):
    """Unpack + head walk + regroup for the stacked tail (depth 9: head 7
    levels, the last two over 1 and 2 words per query)."""
    import jax.numpy as jnp

    jshares = _jax_batch(1 << 16, 32, distinct, leaf_bits=128, seed=11)
    pay, jlayout = jdev.make_fast_payload_batch(jshares)
    k, tail = stacked_fast_geometry(jlayout.depth, jlayout.leaf_blocks)
    head = jlayout.depth - tail
    jpay = jnp.asarray(pay)
    if distinct:
        jrk = jdev.unpack_fast_root_payload_lanes_rk(jpay, jlayout)[0]
    else:
        jrk = jdev.unpack_fast_root_payload(jpay[0], jlayout)[6]
    want = jdev.expand_root_head_grouped(jpay, jlayout, jrk, head, k)

    tpay, layout = tdev.make_fast_payload_batch(to_port(jshares))
    tp = _t(tpay)
    if distinct:
        trk = tdev.unpack_fast_root_payload_lanes_rk(tp, layout)[0]
    else:
        trk = tdev.unpack_fast_root_payload(tp[0], layout)[6]
    assert (_u32(trk) == np.asarray(jrk)).all()
    got = tdev.expand_root_head_grouped(tp, layout, trk, head, k)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (_u32(g) == np.asarray(w)).all()
