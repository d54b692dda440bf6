"""pir_tpu_torch's CUDA kernels vs their plain versions, on the card.

Every test here needs a CUDA device and nvcc and skips without them.
The file imports nothing of JAX or pir_tpu, so it also runs where only
the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from pir_tpu_torch import benchmarks_overlap as ov
from pir_tpu_torch import query as tq
from pir_tpu_torch import server as server_mod
from pir_tpu_torch.crypto import mont
from pir_tpu_torch.database import generate_random_db
from pir_tpu_torch.keyword import new_private_bst, new_private_sqrt_st, pad_to_sqrt
from pir_tpu_torch.ops.compat_head import compat_head, compat_head_plain
from pir_tpu_torch.ops.compat_stage import compat_stage, compat_stage_plain
from pir_tpu_torch.ops.expand import (
    fast_tail_expand_stacked,
    fast_tail_expand_stacked_plain,
)
from pir_tpu_torch.ops.fast_tail import fast_tail_expand, fast_tail_expand_plain
from pir_tpu_torch.ops.fused import fused_scan_expand, fused_scan_expand_plain
from pir_tpu_torch.ops.packed_scan import packed_scan, packed_scan_plain
from pir_tpu_torch.ops.matmul_scan import mxu_batched_scan
from pir_tpu_torch.ops.planes_scan import planes_scan
from pir_tpu_torch.ops.xor_scan import masked_xor_scan, masked_xor_scan_plain
from pir_tpu_torch.server import TorchPirServer

pytestmark = pytest.mark.cuda
FULL = np.uint32(0xFFFFFFFF)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _tail_operands(dev, seed, s_n, w, tail, n_blk, distinct):
    """Random words; round keys as 0/~0 masks, the form the payload
    unpack gives them (the kernel reads bit 0 of each mask word)."""
    rng = np.random.default_rng(seed)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    rk, rkl = ((masks(s_n, 11, 8, 3, 16, w), masks(s_n, 11, 8, 16, w)) if distinct
               else (masks(11, 8, 3, 16, 1), masks(11, 8, 16, 1)))
    ops = (_words(rng, s_n, 8, 1, 16, w), _words(rng, s_n, 1, 1, w),
           _words(rng, s_n, tail, 8, 16, w), _words(rng, s_n, tail, 1, w),
           _words(rng, s_n, tail, 1, w), rk, _words(rng, s_n, 8, n_blk, 16, w), rkl)
    return [torch.from_numpy(x.view(np.int32)).to(dev) for x in ops]


@pytest.mark.parametrize("distinct,n_blk,tail,w", [
    (False, 8, 3, 128), (True, 8, 3, 128), (True, 1, 0, 64), (False, 2, 1, 20),
])
def test_tail_kernel_matches_plain(dev, distinct, n_blk, tail, w):
    ops = _tail_operands(dev, 40 + tail, 3, w, tail, n_blk, distinct)
    before = fast_tail_expand_stacked.launches
    got = fast_tail_expand_stacked(*ops, tail=tail, n_blk=n_blk)
    torch.cuda.synchronize()
    assert fast_tail_expand_stacked.launches == before + 1
    assert torch.equal(got, fast_tail_expand_stacked_plain(*ops, tail=tail, n_blk=n_blk))


def _pertail_operands(dev, seed, q, nw0, levels, n_blk, distinct):
    """Random seed, t and fcw words; every other operand 0/~0 masks, the
    form the payload unpack gives them (the kernel reads bit 0 of each)."""
    rng = np.random.default_rng(seed)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    rk, rkl = ((masks(q, 11, 8, 3, 16, 1), masks(q, 11, 8, 16, 1)) if distinct
               else (masks(11, 8, 3, 16, 1), masks(11, 8, 16, 1)))
    fcw = _words(rng, q, 8, n_blk, 16, 1) if n_blk > 1 else _words(rng, q, 8, 16, 1)
    ops = (_words(rng, q, 8, 16, nw0), _words(rng, q, 1, nw0), masks(q, levels, 8, 16, 1),
           masks(q, levels), masks(q, levels), rk, fcw, rkl)
    return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev) for x in ops]


@pytest.mark.parametrize("distinct,levels,n_blk,nw0,q", [
    (False, 5, 8, 1, 5), (True, 5, 8, 1, 3), (False, 0, 1, 1, 4), (True, 0, 8, 2, 3),
    (False, 5, 1, 8, 3), (True, 5, 1, 4, 2), (False, 2, 2, 16, 3), (True, 3, 1, 32, 2),
    # both serving geometries at a batch of 256: NW0 = 1, split 3, 8 leaf
    # blocks (the per-query tail path); NW0 = 8, split 0, 1 block (the
    # fused kernel's tail items); fcw past the 8 blocks in shared memory;
    # 12 thread-grid lane words (a block of 8 warps, one of 4)
    (False, 5, 8, 1, 256), (True, 5, 1, 8, 256), (True, 2, 16, 2, 3), (False, 3, 2, 3, 2),
])
def test_fast_tail_kernel_matches_plain(dev, distinct, levels, n_blk, nw0, q):
    ops = _pertail_operands(dev, 60 + levels + nw0, q, nw0, levels, n_blk, distinct)
    before = fast_tail_expand.launches
    got = fast_tail_expand(*ops, levels=levels)
    torch.cuda.synchronize()
    assert fast_tail_expand.launches == before + 1
    assert torch.equal(got, fast_tail_expand_plain(*ops, levels=levels))


@pytest.mark.parametrize("h,b,q,qe,nw0,levels", [
    (1 << 15, 64, 37, 5, 8, 5), (4096, 8, 3, 9, 1, 0), (1 << 16, 520, 70, 2, 2, 2),
    (4096, 16, 0, 3, 1, 2), (1 << 15, 16, 40, 0, 8, 5),  # one half empty
    # the scan tile's edges (tests/test_torch_packed_scan_lanes.py models
    # each): Q = 1 on rows not a multiple of a chunk, Q = 1000, 2^17 + 32
    # rows in 9 chunks, Q > 4096, B = 520
    (20512, 1024, 1, 3, 1, 2), (4128, 8, 1000, 2, 1, 2), ((1 << 17) + 32, 8, 3, 2, 1, 2),
    (1024, 8, 4200, 2, 1, 2), (4128, 520, 37, 3, 1, 2),
])
def test_fused_kernel_matches_plain(dev, h, b, q, qe, nw0, levels):
    rng = np.random.default_rng(h + q + qe)
    table = torch.from_numpy(rng.integers(0, 256, size=(h, b), dtype=np.uint8)).to(dev)
    words = torch.from_numpy(_words(rng, h // 32, q).view(np.int32)).to(dev)
    ops = _pertail_operands(dev, q + qe, qe, nw0, levels, 1, False)
    before = fused_scan_expand.launches
    got = fused_scan_expand(table, words, *ops, levels=levels)
    torch.cuda.synchronize()
    assert fused_scan_expand.launches == before + 1
    want = fused_scan_expand_plain(table, words, *ops, levels=levels)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,b,q", [
    (8192, 1024, 64), (4096, 8, 37), (2048, 520, 3),
    # the tile's edges (tests/test_torch_packed_scan_lanes.py models each):
    # Q = 1, Q = 1000 on rows not a multiple of a tile, Q > 4096, 2^16 + 32
    # rows in 513 chunks
    (4096, 1024, 1), (2080, 64, 1000), (1024, 8, 4200), ((1 << 16) + 32, 8, 37),
])
def test_packed_scan_kernel_matches_plain(dev, h, b, q):
    rng = np.random.default_rng(h + q)
    table = torch.from_numpy(rng.integers(0, 256, size=(h, b), dtype=np.uint8)).to(dev)
    words = torch.from_numpy(_words(rng, h // 32, q).view(np.int32)).to(dev)
    before = packed_scan.launches
    got = packed_scan(table, words)
    torch.cuda.synchronize()
    assert packed_scan.launches == before + 1
    assert torch.equal(got, packed_scan_plain(table, words))


def test_scan_kernels_read_a_table_not_16_byte_aligned(dev):
    """A table 4 bytes past a 16-byte boundary takes the tile's 4-byte
    loads in both scan kernels (packed_scan and the fused scan items)."""
    h, b, q = 4096, 64, 40
    rng = np.random.default_rng(3)
    buf = torch.empty(h * b + 16, dtype=torch.uint8, device=dev)
    off = (16 - buf.data_ptr() % 16) % 16 + 4
    table = buf[off:off + h * b].view(h, b)
    table.copy_(torch.from_numpy(rng.integers(0, 256, size=(h, b), dtype=np.uint8)))
    assert table.data_ptr() % 16 == 4 and table.is_contiguous()
    words = torch.from_numpy(_words(rng, h // 32, q).view(np.int32)).to(dev)
    want = packed_scan_plain(table, words)
    before = packed_scan.launches, fused_scan_expand.launches
    got = packed_scan(table, words)
    ops = _pertail_operands(dev, 5, 2, 1, 2, 1, False)
    fused = fused_scan_expand(table, words, *ops, levels=2)
    torch.cuda.synchronize()
    assert (packed_scan.launches, fused_scan_expand.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want) and torch.equal(fused[0], want)


def _compat_operands(dev, seed, q, nc, w, tail):
    """Random seed and t words; every other operand 0/~0 masks, the form
    the payload unpack gives them (the kernel reads bit 0 of each)."""
    rng = np.random.default_rng(seed)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    ops = (_words(rng, q, 8, nc, 16, w), _words(rng, q, nc, 1, w), masks(q, tail, 8, 16, 1),
           masks(q, tail), masks(q, tail), masks(q, 11, 8, 3, 16, 1), masks(q))
    return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev) for x in ops]


@pytest.mark.parametrize("q,nc,w,tail", [(3, 1, 128, 3), (2, 8, 128, 3), (3, 64, 128, 2),
                                         (2, 3, 8, 1), (2, 2, 4, 2), (3, 2, 1, 3)])
@pytest.mark.parametrize("emit_bits", [False, True])
def test_compat_stage_kernel_matches_plain(dev, q, nc, w, tail, emit_bits):
    ops = _compat_operands(dev, q * nc + w + tail, q, nc, w, tail)
    before = compat_stage.launches
    got = compat_stage(*ops, tail=tail, emit_bits=emit_bits)
    torch.cuda.synchronize()
    assert compat_stage.launches == before + 1
    want = compat_stage_plain(*ops, tail=tail, emit_bits=emit_bits)
    if emit_bits:
        assert torch.equal(got, want)
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _bitslice(blocks):
    """(..., W, 32, 16) uint8 lane blocks -> (..., 8, 16, W) uint32 planes:
    bit j of word (bit k, byte i) of lane word w is bit k of byte i of
    lane j's block."""
    bits = (blocks[..., None] >> np.arange(8, dtype=np.uint8)) & 1  # (..., W, 32, 16, 8)
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None, None]).sum(-3)
    return np.moveaxis(words.astype(np.uint32), [-3, -2, -1], [-1, -2, -3])


def _lane_blocks(rng, pattern, n, w):
    """(n, W, 32, 16) uint8 seeds. "equal": the 32 lanes of a lane word
    share a random block, so a warp's lanes read one table word at once;
    "bytes": lane j of lane word v, block m, byte i is 16 m + i + 17 j + v
    (mod 256), so over n = 16 blocks every lane sees every byte value."""
    if pattern == "equal":
        return np.repeat(rng.integers(0, 256, size=(n, w, 1, 16), dtype=np.uint8), 32, axis=2)
    m, v, j, i = np.ix_(range(n), range(w), range(32), range(16))
    return ((16 * m + i + 17 * j + v) % 256).astype(np.uint8)


@pytest.mark.parametrize("pattern,distinct,n_blk,tail,w", [
    ("equal", False, 8, 3, 128), ("bytes", False, 2, 3, 20), ("bytes", True, 2, 0, 20),
    ("equal", True, 1, 0, 64), ("bytes", True, 1, 2, 8),
])
def test_tail_kernel_structured_seeds(dev, pattern, distinct, n_blk, tail, w):
    """The per-bank AES table at its edges: a warp's lanes on one table
    word, every byte value in every lane (round key 0 zero, so the first
    round looks the seed bytes up), distinct keys, w = 20, tail = 0."""
    s_n = 16
    rng = np.random.default_rng(70 + tail + w)
    ops = _tail_operands(dev, 80 + tail + w, s_n, w, tail, n_blk, distinct)
    ops[0] = torch.from_numpy(_bitslice(_lane_blocks(rng, pattern, s_n, w))[:, :, None]
                              .copy().view(np.int32)).to(dev)
    ops[5][..., 0, :, :, :, :] = 0  # round 0 of the tree keys
    ops[7][..., 0, :, :, :] = 0     # and of the leaf key
    before = fast_tail_expand_stacked.launches
    got = fast_tail_expand_stacked(*ops, tail=tail, n_blk=n_blk)
    torch.cuda.synchronize()
    assert fast_tail_expand_stacked.launches == before + 1
    assert torch.equal(got, fast_tail_expand_stacked_plain(*ops, tail=tail, n_blk=n_blk))


@pytest.mark.parametrize("pattern,w,tail", [
    ("equal", 8, 3), ("bytes", 8, 2), ("bytes", 1, 3), ("equal", 1, 1),
])
@pytest.mark.parametrize("emit_bits", [False, True])
def test_compat_stage_kernel_structured_seeds(dev, pattern, w, tail, emit_bits):
    """As test_tail_kernel_structured_seeds, for the compat stage: the 16
    chunks of a query carry the patterned seeds; w = 1 is a one-word slice."""
    q, nc = 2, 16
    rng = np.random.default_rng(90 + w + tail)
    ops = _compat_operands(dev, 91 + w + tail, q, nc, w, tail)
    planes = _bitslice(_lane_blocks(rng, pattern, q * nc, w)).reshape(q, nc, 8, 16, w)
    ops[0] = torch.from_numpy(planes.transpose(0, 2, 1, 3, 4).copy().view(np.int32)).to(dev)
    ops[5][:, 0] = 0  # round 0 of the three tree keys
    before = compat_stage.launches
    got = compat_stage(*ops, tail=tail, emit_bits=emit_bits)
    torch.cuda.synchronize()
    assert compat_stage.launches == before + 1
    want = compat_stage_plain(*ops, tail=tail, emit_bits=emit_bits)
    if emit_bits:
        assert torch.equal(got, want)
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _head_operands(dev, seed, q, d):
    """Root seeds as bits (bit 0 of each word, the payload unpack's form;
    the upper bits random, which the kernel must not read), t and every
    other operand 0/~0 masks."""
    rng = np.random.default_rng(seed)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    ops = (_words(rng, q, 8, 16, 1) & ~np.uint32(1) | rng.integers(0, 2, size=(q, 8, 16, 1),
                                                                   dtype=np.uint32),
           masks(q, 1), masks(q, d, 8, 16, 1), masks(q, d), masks(q, d),
           masks(q, 11, 8, 3, 16, 1))
    return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev) for x in ops]


def _head_check(ops, skip, w, shard):
    before = compat_head.launches
    got = compat_head(*ops, skip=skip, w=w, shard=shard)
    torch.cuda.synchronize()
    assert compat_head.launches == before + 1
    want = compat_head_plain(*ops, skip=skip, w=w, shard=shard)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("w", [8, 32, 128])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("shard", [None, (0, 1), (1, 1), (2, 2), (1, 2)])
@pytest.mark.parametrize("q", [1, 7, 64, 1024])
def test_compat_head_kernel_matches_plain(dev, q, shard, skip, w):
    """The head kernel's seeds and t equal the plain walk's byte for
    byte: 1, 4 and 8 warps a block (w 8, 32, 128), skip 0 and 1, no
    shard prefix or one of 1 or 2 levels with both path bits."""
    split = 5 + w.bit_length() - 1
    d = skip + (shard[1] if shard else 0) + split + 2
    _head_check(_head_operands(dev, q + w + skip, q, d), skip, w, shard)


@pytest.mark.parametrize("pattern", ["zeros", "ones"])
@pytest.mark.parametrize("w,skip,shard", [(128, 1, None), (32, 0, (1, 1)), (8, 1, (2, 2))])
def test_compat_head_kernel_structured_seeds(dev, pattern, w, skip, shard):
    """All-zero and all-ones seeds, t and correction words (round key 0
    zero too): every node of a level sees the same correction, and with
    zeros the first round looks the seed bytes up at table word 0."""
    q = 16
    d = skip + (shard[1] if shard else 0) + 5 + w.bit_length() - 1
    ops = _head_operands(dev, 60 + w, q, d)
    fill = 0 if pattern == "zeros" else -1
    for x in ops[:5]:
        x.fill_(fill)
    ops[0] &= 1  # the unpack's seed bits
    ops[5][:, 0] = 0
    _head_check(ops, skip, w, shard)


@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("c", [1, 3, 256, 257])
def test_masked_xor_scan_kernel_matches_plain(dev, q, c):
    """Rows not a multiple of any row chunk; C = 256 reads 16 bytes a
    thread, 1, 3 and 257 read 4."""
    h = 4099 if c < 256 else 2053
    rng = np.random.default_rng(q * 1000 + c)
    table = torch.from_numpy(_words(rng, h, c).view(np.int32)).to(dev)
    bits = torch.from_numpy(rng.integers(0, 2, size=(q, h)).astype(np.uint8)).to(dev)
    before = masked_xor_scan.launches
    got = masked_xor_scan(table, bits)
    torch.cuda.synchronize()
    assert masked_xor_scan.launches == before + 1
    assert torch.equal(got, masked_xor_scan_plain(table, bits))
    assert torch.equal(masked_xor_scan(table, bits[0]), masked_xor_scan_plain(table, bits[0]))


def test_masked_xor_scan_kernel_slices_and_long_tables(dev):
    """12 queries run as launches of 8 and 4; 2^20 + 5 rows take more than
    one chunk per block column."""
    rng = np.random.default_rng(12)
    for h, c, q, launches in ((1000, 16, 12, 2), ((1 << 20) + 5, 4, 2, 1)):
        table = torch.from_numpy(_words(rng, h, c).view(np.int32)).to(dev)
        bits = torch.from_numpy(rng.integers(0, 2, size=(q, h)).astype(np.uint8)).to(dev)
        before = masked_xor_scan.launches
        got = masked_xor_scan(table, bits)
        torch.cuda.synchronize()
        assert masked_xor_scan.launches == before + launches
        assert torch.equal(got, masked_xor_scan_plain(table, bits))


def test_wrappers_reject_strided_cuda_operands(dev):
    table = torch.zeros((64, 16), dtype=torch.uint8, device=dev)
    words = torch.zeros((4, 2), dtype=torch.int32, device=dev).t()  # (2, 4), strided
    with pytest.raises(ValueError, match="contiguous"):
        packed_scan(table, words)
    ops = _tail_operands(dev, 1, 2, 8, 1, 1, False)
    ops[0] = ops[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fast_tail_expand_stacked(*ops, tail=1, n_blk=1)
    ops = _compat_operands(dev, 2, 2, 2, 8, 1)
    ops[0] = ops[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        compat_stage(*ops, tail=1, emit_bits=True)
    ops = _head_operands(dev, 3, 2, 9)
    ops[3] = ops[3].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        compat_head(*ops, skip=1, w=8)
    table_w = torch.zeros((16, 64), dtype=torch.int32, device=dev)
    bits = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        masked_xor_scan(table_w.t(), bits)
    with pytest.raises(ValueError, match="contiguous"):
        masked_xor_scan(table_w.t().contiguous(), bits.t().contiguous().t())
    with pytest.raises(ValueError, match="uint8"):
        masked_xor_scan(table_w.t().contiguous(), bits.to(torch.int32))
    with pytest.raises(ValueError, match="int32"):
        masked_xor_scan(table_w.t().contiguous().to(torch.int64), bits)


def test_cuda_server_matches_cpu_server(dev):
    """Shared keys (35 queries: not a multiple of k) and distinct keys
    (5 queries, chunked at 4) on the card equal the CPU server's bytes
    and recover every row."""
    db = generate_random_db(1 << 13, 8)
    gpu = TorchPirServer(db, fast_nonshared_chunk=4)
    cpu = TorchPirServer(db, device="cpu", fast_nonshared_chunk=4)
    rng = np.random.default_rng(3)
    idxs = [int(i) for i in rng.integers(0, db.db_size, size=35)]
    shared = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True,
                                            rand_bytes=rng.bytes)
    distinct = [tq.new_fast_index_query_shares(db.metadata(), i, 1, rand_bytes=rng.bytes)
                for i in idxs[:5]]
    for pairs in (shared, distinct):
        out = []
        for part in (0, 1):
            batch = [p[part] for p in pairs]
            g = gpu.private_secret_shared_query_batch(batch)
            c = cpu.private_secret_shared_query_batch(batch)
            assert [r.shares[0].data for r in g] == [r.shares[0].data for r in c]
            out.append(g)
        for i, (a, b) in enumerate(zip(*out)):
            assert bytes(tq.recover([a, b])[0].data) == db.data[idxs[i]].tobytes()


def test_cuda_server_compat_matches_cpu_server(dev, monkeypatch):
    """Compat batches of 10 (stage slices of 4, 4, 2) and 40 (dispatch
    slices of 16, 16, 8) on the card equal the CPU server's bytes and
    recover every row; 2^13 rows, w = 8: head 8 levels, stages (3, 2)."""
    for name, v in (("COMPAT_MAX_W", 8), ("COMPAT_Q_CHUNK", 4), ("COMPAT_BATCH_CAP", 16)):
        monkeypatch.setattr(server_mod, name, v)
    db = generate_random_db(1 << 13, 8)
    gpu = TorchPirServer(db)
    cpu = TorchPirServer(db, device="cpu")
    rng = np.random.default_rng(4)
    for n in (10, 40):
        idxs = [int(i) for i in rng.integers(0, db.db_size, size=n)]
        idxs[0], idxs[-1] = 0, db.db_size - 1
        pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, rand_bytes=rng.bytes)
        before = compat_stage.launches, compat_head.launches
        out = []
        for part in (0, 1):
            batch = [p[part] for p in pairs]
            g = gpu.private_secret_shared_query_batch_async(batch)()
            c = cpu.private_secret_shared_query_batch(batch)
            assert [r.shares[0].data for r in g] == [r.shares[0].data for r in c]
            out.append(g)
        assert compat_stage.launches > before[0] and compat_head.launches > before[1]
        for i, (a, b) in enumerate(zip(*out)):
            assert bytes(tq.recover([a, b])[0].data) == db.data[idxs[i]].tobytes()


def _pair_rows(srv, pairs, part):
    return [r.shares[0].data for r in
            srv.private_secret_shared_query_batch([p[part] for p in pairs])]


def _check_servers(gpu, cpu, db, idxs, pairs):
    """Both shares on the card equal the CPU server's bytes and recover
    every row."""
    out = []
    for part in (0, 1):
        g = _pair_rows(gpu, pairs, part)
        assert g == _pair_rows(cpu, pairs, part)
        out.append(g)
    for i, (a, b) in enumerate(zip(*out)):
        got = bytes(np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8))
        assert got == db.data[idxs[i]].tobytes()


def test_cuda_pertail_server_matches_cpu_server(dev):
    """fast_stacked=False: shared keys (35 queries, 1024-bit default leaves
    clamped to 256 at 2^13 rows; and 128-bit leaves, one tail level) and
    distinct keys (5, chunked at 4) through the per-query tail kernel."""
    db = generate_random_db(1 << 13, 8)
    gpu = TorchPirServer(db, fast_nonshared_chunk=4, fast_stacked=False)
    cpu = TorchPirServer(db, device="cpu", fast_nonshared_chunk=4, fast_stacked=False)
    rng = np.random.default_rng(5)
    idxs = [int(i) for i in rng.integers(0, db.db_size, size=35)]
    before = fast_tail_expand.launches
    for lb in (None, 128):
        pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True,
                                                leaf_bits=lb, rand_bytes=rng.bytes)
        _check_servers(gpu, cpu, db, idxs, pairs)
    distinct = [tq.new_fast_index_query_shares(db.metadata(), i, 1, rand_bytes=rng.bytes)
                for i in idxs[:5]]
    _check_servers(gpu, cpu, db, idxs[:5], distinct)
    assert fast_tail_expand.launches > before


def _stream_rows(srv, batches):
    stream = srv.fast_serving_stream()
    futs = [stream.submit(b) for b in batches][1:] + [stream.flush()]
    return [[r.shares[0].data for r in f()] for f in futs]


@pytest.mark.parametrize("slot", [8, 3])
@pytest.mark.parametrize("stacked", [True, False])
def test_cuda_stream_matches_batch_api(dev, slot, stacked):
    """Three batches of 16 and a flush, in both stream modes, equal the
    card's batch API and recover every row; fused mode launches the
    fused kernel once a batch and once for the flush."""
    db = generate_random_db(1 << 13, slot)
    gpu = TorchPirServer(db, fast_stacked=stacked)
    rng = np.random.default_rng(slot)
    batches = [[int(i) for i in rng.integers(0, db.db_size, size=16)] for _ in range(3)]
    pairs = [tq.new_index_query_shares_batch(db.metadata(), b, 1, fast=True, leaf_bits=128,
                                             rand_bytes=rng.bytes) for b in batches]
    before = fused_scan_expand.launches
    got = []
    for part in (0, 1):
        shares = [[p[part] for p in ps] for ps in pairs]
        rows = _stream_rows(gpu, shares)
        assert rows == [[r.shares[0].data for r in gpu.private_secret_shared_query_batch(s)]
                        for s in shares]
        got.append(rows)
    assert fused_scan_expand.launches - before == (0 if stacked else 8)
    for idxs, a_rows, b_rows in zip(batches, *got):
        for idx, a, b in zip(idxs, a_rows, b_rows):
            assert bytes(np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)) == \
                db.data[idx].tobytes()


def test_cuda_3_byte_rows_match_cpu_server(dev, monkeypatch):
    """Rows of 3 bytes (tables padded to 4-byte words) on the stacked and
    per-query-tail fast paths and the compat path (2^13 rows, w = 8:
    head 8 levels, stages (3, 2)) equal the CPU server and recover."""
    for name, v in (("COMPAT_MAX_W", 8), ("COMPAT_Q_CHUNK", 4)):
        monkeypatch.setattr(server_mod, name, v)
    db = generate_random_db(1 << 13, 3)
    rng = np.random.default_rng(6)
    idxs = [int(i) for i in rng.integers(0, db.db_size, size=10)]
    fast = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True,
                                           rand_bytes=rng.bytes)
    compat = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, rand_bytes=rng.bytes)
    for stacked in (True, False):
        gpu = TorchPirServer(db, fast_stacked=stacked)
        cpu = TorchPirServer(db, device="cpu", fast_stacked=stacked)
        _check_servers(gpu, cpu, db, idxs, fast)
    _check_servers(gpu, cpu, db, idxs, compat)


@pytest.mark.parametrize("slot", [16, 3])
def test_cuda_single_queries_match_cpu_server(dev, slot):
    """Single queries and small batches on the card: fast singles (both
    fast_stacked values) scan with the masked-XOR scan kernel and not the
    packed scan; compat singles, batches of 3 and expand + scan equal the
    CPU server's bytes and recover; so do the tiny-table fallbacks."""
    db = generate_random_db(1 << 13, slot)
    rng = np.random.default_rng(slot)
    idxs = [0, db.db_size - 1, int(rng.integers(db.db_size))]
    cpu = TorchPirServer(db, device="cpu")
    for fast in (True, False):
        pairs = [tq.new_index_query_shares(db.metadata(), i, 1, fast=fast,
                                           rand_bytes=rng.bytes) for i in idxs]
        for stacked in ((True, False) if fast else (True,)):
            gpu = TorchPirServer(db, fast_stacked=stacked)
            scans, packed = masked_xor_scan.launches, packed_scan.launches
            for idx, pair in zip(idxs, pairs):
                res = [gpu.private_secret_shared_query(s) for s in pair]
                assert [r.shares[0].data for r in res] == \
                    [cpu.private_secret_shared_query(s).shares[0].data for s in pair]
                assert bytes(tq.recover(res)[0].data) == db.data[idx].tobytes()
                bits = [gpu.expand_shared_query(s) for s in pair]
                assert all(b.is_cuda for b in bits)
                res = [gpu.private_secret_shared_query_with_expanded_bits(s, b)
                       for s, b in zip(pair, bits)]
                assert bytes(tq.recover(res)[0].data) == db.data[idx].tobytes()
            assert masked_xor_scan.launches > scans
            assert packed_scan.launches == packed
            batch = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=fast,
                                                    rand_bytes=rng.bytes)
            _check_servers(gpu, cpu, db, idxs, batch)
    tiny = generate_random_db(20, slot)
    t_idxs = [int(i) for i in rng.integers(0, 20, size=12)]
    for fast in (True, False):
        batch = tq.new_index_query_shares_batch(tiny.metadata(), t_idxs, 1, fast=fast,
                                                rand_bytes=rng.bytes)
        _check_servers(TorchPirServer(tiny), TorchPirServer(tiny, device="cpu"), tiny, t_idxs,
                       batch)


@pytest.mark.parametrize("h,b,q", [
    # the small-batch tile (Q <= 64): the keyword path's tile shape, whole
    # tiles; Q = 1 on ragged rows (h % 16 != 0: byte loads in the pack);
    # 3-byte slots padded to 4-byte rows; B % 16 != 0; Q = 63 and 64 on
    # rows a multiple of 32 but not of a stage, or not of 32
    (4096, 1024, 64), (1000, 12, 1), (4099, 4, 13), (8192, 68, 33), (2048, 80, 17),
    (2080, 36, 63), (1008, 8, 64),
    # the 128-query tile: several row chunks and query tiles; Q = 65 with
    # a half last word row (16-byte loads); Q = 1024
    (65536, 256, 130), (1040, 520, 65), (2048, 64, 1024),
])
def test_planes_scan_kernel_matches_plain(dev, h, b, q):
    rng = np.random.default_rng(h + b + q)
    table = torch.from_numpy(rng.integers(0, 256, (h, b), dtype=np.uint8)).to(dev)
    bits = torch.from_numpy(rng.integers(0, 2, (q, h), dtype=np.uint8)).to(dev)
    before = planes_scan.launches
    got = planes_scan(table, bits)
    torch.cuda.synchronize()
    assert planes_scan.launches == before + 1
    assert torch.equal(got, mxu_batched_scan(table, bits))
    assert torch.equal(got, masked_xor_scan_plain(table.view(torch.int32), bits).view(torch.uint8))


def test_planes_scan_rejects_what_the_kernel_cannot_read(dev):
    table = torch.zeros((64, 6), dtype=torch.uint8, device=dev)
    bits = torch.zeros((2, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="4-byte words"):
        planes_scan(table, bits)
    with pytest.raises(ValueError, match="contiguous"):
        planes_scan(torch.zeros((64, 8), dtype=torch.uint8, device=dev), bits.t().contiguous().t())


@pytest.mark.parametrize("slot", [16, 3])
def test_cuda_keyword_and_multiparty_match_cpu_server(dev, slot):
    """A keyword batch on the card launches the bit-plane scan kernel and
    equals the CPU server's bytes; keyword singles and 3-party index and
    keyword singles equal them too; every answer recovers its row."""
    db = generate_random_db(1 << 12, slot)
    rng = np.random.default_rng(30 + slot)
    kws = rng.choice(1 << 32, size=db.db_size, replace=False).astype(np.uint64)
    db.set_keywords(kws)
    gpu, cpu = TorchPirServer(db), TorchPirServer(db, device="cpu")
    rows = [0, db.db_size - 1] + [int(i) for i in rng.integers(0, db.db_size, size=7)]
    pairs = tq.new_keyword_query_shares_batch(db.metadata(), [int(kws[r]) for r in rows], 1,
                                              rand_bytes=rng.bytes)
    before = planes_scan.launches
    _check_servers(gpu, cpu, db, rows, pairs)
    assert planes_scan.launches > before
    singles = [tq.new_keyword_query_shares(db.metadata(), int(kws[rows[2]]), 1,
                                           rand_bytes=rng.bytes),
               tq.new_index_query_shares(db.metadata(), rows[3], 1, num_shares=3,
                                         rand_bytes=rng.bytes),
               tq.new_keyword_query_shares(db.metadata(), int(kws[rows[4]]), 1, num_shares=3,
                                           rand_bytes=rng.bytes)]
    for row, shares in zip(rows[2:5], singles):
        res = [gpu.private_secret_shared_query(s) for s in shares]
        assert [r.shares[0].data for r in res] == \
            [cpu.private_secret_shared_query(s).shares[0].data for s in shares]
        assert bytes(tq.recover(res)[0].data) == db.data[row].tobytes()


def test_cuda_keyword_trees_answer_on_the_card(dev):
    """PrivateSqrtST and PrivateBST made with no device answer their
    queries on the card (the masked-XOR scan kernel), with the CPU
    server's bytes, and find every key."""
    rng = np.random.default_rng(40)
    data = sorted(pad_to_sqrt([f"key-{i:05d}" for i in range(1000)]), reverse=True)
    sqst = new_private_sqrt_st()
    sqst.build_for_data(data)
    assert sqst.server().device.type == "cuda"
    cpu = TorchPirServer(sqst.second_layer, device="cpu")
    md = sqst.get_second_layer_metadata()
    before = masked_xor_scan.launches
    for i in (0, len(data) - 1, 517):
        row_index = sqst.find_bucket(data[i])
        shares = tq.new_index_query_shares(md, row_index, sqst.height, rand_bytes=rng.bytes)
        answers = [sqst.private_query(s) for s in shares]
        assert [a.shares for a in answers] == \
            [cpu.private_secret_shared_query(s).shares for s in shares]
        index = row_index * sqst.width + sqst.find_in_row(tq.recover(answers), data[i])
        assert data[index] == data[i]
    assert masked_xor_scan.launches > before

    keys = sorted([f"user-{i:04d}" for i in range(256)], reverse=True)
    bst = new_private_bst()
    bst.build_for_data(keys)
    data_srv = TorchPirServer(bst.data_layer)

    def query_level(lvl, index):
        db = bst.levels[lvl]
        shares = tq.new_index_query_shares(db.metadata(), index, 1, rand_bytes=rng.bytes)
        answers = [bst.private_level_query(lvl, s) for s in shares]
        assert bst.level_server(lvl).device.type == "cuda"
        return tq.recover(answers)[0]

    def query_data(index):
        shares = tq.new_index_query_shares(bst.data_layer.metadata(), index, 1,
                                           rand_bytes=rng.bytes)
        return tq.recover([data_srv.private_secret_shared_query(s) for s in shares])

    before = masked_xor_scan.launches
    for i in (0, 255, 100):
        idx, slots = bst.lookup(keys[i], query_level, query_data)
        assert idx == i and slots[0].to_string() == keys[i]
    # one launch a share: two shares a level and two for the data, a lookup
    assert masked_xor_scan.launches == before + 3 * (2 * bst.depth + 2)


@pytest.mark.parametrize("iters", [1, 7, 256])
def test_overlap_probe_kernels_match_plain(dev, iters):
    """The probe's three kernels and the two-stream run: equal words."""
    v, a, b = ov.make_inputs(iters, dev)
    want_v, want_m = ov.vpu_chain(v, iters), ov.mxu_chain(a, b, iters)
    before = (ov.vpu_probe.launches, ov.mxu_probe.launches, ov.mixed_probe.launches)
    got = {"vpu": (ov.vpu_probe(v, iters),), "mxu": (ov.mxu_probe(a, b, iters),),
           "mixed": ov.mixed_probe(v, a, b, iters), "streams": ov.streams(v, a, b, iters)}
    torch.cuda.synchronize()
    assert (ov.vpu_probe.launches, ov.mxu_probe.launches, ov.mixed_probe.launches) == \
        (before[0] + 2, before[1] + 2, before[2] + 1)
    for name, outs in got.items():
        want = {"vpu": (want_v,), "mxu": (want_m,)}.get(name, (want_v, want_m))
        assert all(torch.equal(g, w) for g, w in zip(outs, want)), name


def test_overlap_probe_zero_rounds_and_edge_words(dev):
    """iters = 0 returns v and zero accumulators; a = 63 and -64 everywhere
    wrap nowhere, words 0x80000000 and 0xFFFFFFFF shift and wrap."""
    v = torch.full(ov.VSHAPE, -1, dtype=torch.int32, device=dev)
    v[::2] = -(1 << 31)
    a = torch.full((ov.M, ov.K), 63, dtype=torch.int8, device=dev)
    a[1::2] = -64
    b = torch.full((ov.K, ov.N), -64, dtype=torch.int8, device=dev)
    b[::3] = 63
    for iters in (0, 3):
        vo, mo = ov.mixed_probe(v, a, b, iters)
        assert torch.equal(vo, ov.vpu_chain(v, iters))
        assert torch.equal(mo, ov.mxu_chain(a, b, iters))


@pytest.mark.parametrize("iters", [1, 7])
def test_overlap_probe_int8_wrap_of_a_plus_one(dev, iters):
    """Bytes of a at 127 and -1 wrap to -128 and 0 when their row's bit
    is set (the kernels' a + 1 buffer): equal words to mxu_chain."""
    v, a, b = ov.make_inputs(iters, dev)
    a[::3, ::5] = 127
    a[1::3, ::7] = -1
    want = ov.mxu_chain(a, b, iters)
    assert torch.equal(ov.mxu_probe(a, b, iters), want)
    assert torch.equal(ov.mixed_probe(v, a, b, iters)[1], want)


def test_overlap_probe_max_active_clusters(dev):
    """Each clustered kernel's resident clusters of CLUSTER: at least one,
    at most two blocks an SM (its launch bounds); A's blocks an SM at
    least one; the cluster size is the module's."""
    got = ov.max_active_clusters(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert set(got) == {"vpu", "mxu", "mixed", "mixed_split", "pair", "cluster"}
    assert got["cluster"] == ov.CLUSTER
    assert all(1 <= got[k] <= 2 * sms // ov.CLUSTER for k in ("mxu", "mixed", "mixed_split")), got
    assert got["vpu"] >= 1, got


@pytest.mark.parametrize("iters", [0, 1, 7, 256])
def test_overlap_probe_mixed_split_matches_plain(dev, iters):
    """C split (integer warps of their own): equal words to mixed."""
    v, a, b = ov.make_inputs(iters + 11, dev)
    before = ov.mixed_split_probe.launches
    vo, mo = ov.mixed_split_probe(v, a, b, iters)
    torch.cuda.synchronize()
    assert ov.mixed_split_probe.launches == before + 1
    assert torch.equal(vo, ov.vpu_chain(v, iters))
    assert torch.equal(mo, ov.mxu_chain(a, b, iters))


def test_overlap_probe_zero_rounds_every_kernel(dev):
    """0 rounds: every kernel and the two-stream run return v and zero
    accumulators."""
    v, a, b = ov.make_inputs(3, dev)
    zero = torch.zeros((ov.M, ov.N), dtype=torch.int32, device=dev)
    assert torch.equal(ov.vpu_probe(v, 0), v)
    assert torch.equal(ov.mxu_probe(a, b, 0), zero)
    for vo, mo in (ov.mixed_probe(v, a, b, 0), ov.mixed_split_probe(v, a, b, 0),
                   ov.streams(v, a, b, 0)):
        assert torch.equal(vo, v) and torch.equal(mo, zero)


@pytest.mark.parametrize("iters", [1, 2, 7])
def test_overlap_probe_int8_wrap_in_both_placements(dev, iters):
    """a = 127 and -128 wrap when their row's bit is set (the a + 1
    fragments), and rows whose column-0 parity flips every round (b's
    column 0 odd only in row 0 of K, a's column 0 odd in those rows):
    equal words in B and in both placements of C."""
    v, a, b = ov.make_inputs(iters + 5, dev)
    a[::3, ::5] = 127
    a[1::3, ::7] = -128
    b[:, 0] = 2 * (b[:, 0] // 2)
    b[0, 0] = 1
    a[::2, 0] = 1  # bit_t = (1 + bit_{t-1}) & 1: flips every round
    want = ov.mxu_chain(a, b, iters)
    assert torch.equal(ov.mxu_probe(a, b, iters), want)
    assert torch.equal(ov.mixed_probe(v, a, b, iters)[1], want)
    assert torch.equal(ov.mixed_split_probe(v, a, b, iters)[1], want)
    if iters > 1:  # the flipping rows did flip
        bits = [ov.mxu_chain(a, b, t)[::2, 0] & 1 for t in (iters - 1, iters)]
        assert not torch.equal(bits[0], bits[1])


def test_overlap_probe_cluster_size_launches_at_once(dev):
    """The chosen cluster size launches, and the card holds every cluster
    of a launch at once (PROBE_BLOCKS / CLUSTER), so no cluster waits for
    another to finish; one B block and one A block fit an SM together."""
    got = ov.max_active_clusters(dev)
    need = ov.PROBE_BLOCKS // ov.CLUSTER
    assert all(got[k] >= need for k in ("mxu", "mixed", "mixed_split")), got
    assert got["pair"] >= 1, got
    v, a, b = ov.make_inputs(4, dev)
    assert torch.equal(ov.mxu_probe(a, b, 3), ov.mxu_chain(a, b, 3))


def test_overlap_chain_latencies_on_the_card(dev):
    """The three latency probes run and give positive cycles and ns a step;
    the chain floor grows with the rounds."""
    lat = ov.chain_latencies(dev, reps=256)
    assert set(lat) == set(ov.LATENCY_PROBES)
    assert all(x["cycles"] > 0 and x["ns"] > 0 for x in lat.values()), lat
    # 28 dependent instructions take at least 28 cycles
    assert lat["int_round"]["cycles"] >= ov.ROUND_INSTRS, lat
    f1, f2 = ov.chain_floor_ms(lat, 256), ov.chain_floor_ms(lat, 512)
    assert all(f2[k] > f1[k] > 0 for k in f1)


def test_overlap_probe_rejects_what_the_kernels_cannot_read(dev):
    v, a, b = ov.make_inputs(0, dev)
    with pytest.raises(ValueError, match="different devices"):
        ov.mixed_probe(v, a.cpu(), b)
    with pytest.raises(ValueError, match="different devices"):
        ov.mxu_probe(a, b.cpu())
    with pytest.raises(ValueError, match="must be a"):
        ov.vpu_probe(v[:32])
    with pytest.raises(ValueError, match="must be a"):
        ov.mxu_probe(a.to(torch.uint8), b)
    with pytest.raises(ValueError, match="must be a"):
        ov.mxu_probe(a, b.t())
    with pytest.raises(ValueError, match="contiguous"):
        ov.vpu_probe(v.t().contiguous().t())
    with pytest.raises(ValueError, match="iters"):
        ov.vpu_probe(v, -1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ov.streams(v.cpu(), a.cpu(), b.cpu())
    with pytest.raises(ValueError, match="must be a"):
        ov.mixed_split_probe(v, a, b[:, :128])
    with pytest.raises(ValueError, match="iters"):
        ov.mixed_split_probe(v, a, b, -1)


@pytest.mark.parametrize("slot", [8, 3])
def test_cuda_apply_updates_equals_rebuild(dev, slot):
    """Every table kind on the card, patched by apply_updates, equals a
    fresh server's rebuild, and the updated rows are recovered."""
    db = generate_random_db(1 << 13, slot)
    rng = np.random.default_rng(6)
    md = db.metadata()

    def populated(fast_stacked):
        srv = TorchPirServer(db, fast_stacked=fast_stacked)
        idxs = [int(i) for i in rng.integers(0, db.db_size, size=16)]
        for fast in (True, False):
            pairs = tq.new_index_query_shares_batch(md, idxs, 1, fast=fast, rand_bytes=rng.bytes)
            srv.private_secret_shared_query_batch([p[0] for p in pairs])
        srv.private_secret_shared_query(tq.new_index_query_shares(md, 5, 1,
                                                                  rand_bytes=rng.bytes)[0])
        return srv

    servers = [populated(True), populated(False)]
    updates = {0: bytes(range(slot)), db.db_size - 1: b"", 4097: b"\x7f"}
    for srv in servers:
        srv.apply_updates(updates)
    for srv, fresh in zip(servers, [populated(True), populated(False)]):
        assert set(srv._tables) == set(fresh._tables)
        for key, table in fresh._tables.items():
            assert table.device.type == "cuda" and torch.equal(srv._tables[key], table), key
        for fast in (True, False):
            pairs = tq.new_index_query_shares_batch(md, sorted(updates), 1, fast=fast,
                                                    rand_bytes=rng.bytes)
            _check_servers(srv, TorchPirServer(db, device="cpu"), db, sorted(updates), pairs)


def _service_pair(db, key_db, device):
    from pir_tpu_torch.config import PirConfig
    from pir_tpu_torch.service import PirService

    cfg = PirConfig(device=device)
    lead = PirService(db, config=cfg, key_db=key_db).start()
    return [lead, PirService(db, config=cfg, key_db=key_db, audit_leader=lead.address).start()]


def _fan_frames(pair, frames):
    """frames[k] (a list of (opcode, payload)) in order on one connection
    to pair[k], the two connections in step (a shared ASPIR batch waits
    for both servers); the answer frames of each."""
    import socket

    from pir_tpu_torch.service import _recv_frame, _send_frame

    socks = [socket.create_connection(s.address) for s in pair]
    try:
        out = [[], []]
        for step in range(len(frames[0])):
            for k, s in enumerate(socks):
                _send_frame(s, *frames[k][step])
            for k, s in enumerate(socks):
                out[k].append(_recv_frame(s))
        return out
    finally:
        for s in socks:
            s.close()


def test_cuda_services_match_cpu_services(dev):
    """A port service pair on the card answers a fast batch, a compat
    batch, a stream (three batches and a flush) and a shared ASPIR batch
    (one wrong key) with the same frames as a pair on the CPU; every row
    recovers and the wrong key's item is refused."""
    import struct

    from pir_tpu_torch import wire
    from pir_tpu_torch.aspir_shared import new_authenticated_index_query_shares
    from pir_tpu_torch.service import (
        OP_ASPIR_SHARED_QUERY_BATCH,
        OP_QUERY_BATCH,
        OP_STREAM_FLUSH,
        OP_STREAM_SUBMIT,
        _pack_blobs,
        _unpack_blobs,
    )

    db = generate_random_db(1 << 15, 16)
    key_db = generate_random_db(1 << 15, 8)
    md = db.metadata()
    rng = np.random.default_rng(71)

    def idx(n):
        return [int(i) for i in rng.integers(0, db.db_size, size=n)]

    batches = {"fast": idx(16), "compat": idx(8), "aspir": idx(8)}
    fast = tq.new_index_query_shares_batch(md, batches["fast"], 1, fast=True,
                                           rand_bytes=rng.bytes)
    compat = tq.new_index_query_shares_batch(md, batches["compat"], 1, rand_bytes=rng.bytes)
    stream_idx = [idx(8) for _ in range(3)]
    stream = [tq.new_index_query_shares_batch(md, b, 1, fast=True, rand_bytes=rng.bytes)
              for b in stream_idx]
    keys = [key_db.slot(i) for i in batches["aspir"]]
    keys[3] = key_db.slot((batches["aspir"][3] + 1) % db.db_size)
    auth = [new_authenticated_index_query_shares(md, i, k, 1, 2, fast=True)
            for i, k in zip(batches["aspir"], keys)]

    def frames(k):
        ser = wire.serialize_query_share
        return ([(OP_QUERY_BATCH, _pack_blobs([ser(p[k]) for p in fast])),
                 (OP_QUERY_BATCH, _pack_blobs([ser(p[k]) for p in compat]))]
                + [(OP_STREAM_SUBMIT, _pack_blobs([ser(p[k]) for p in b])) for b in stream]
                + [(OP_STREAM_FLUSH, b""),
                   (OP_ASPIR_SHARED_QUERY_BATCH, struct.pack("<QB", 9, 2) + _pack_blobs(
                       [wire.serialize_auth_share(a[k]) for a in auth]))])

    answers = {}
    for device in ("cuda", "cpu"):
        pair = _service_pair(db, key_db, device)
        try:
            answers[device] = _fan_frames(pair, [frames(0), frames(1)])
        finally:
            for s in pair:
                s.close()
    assert answers["cuda"] == answers["cpu"]
    (a0, a1) = answers["cuda"]
    assert [op for op, _ in a0] == [op for op, _ in frames(0)]

    def rows(p0, p1):
        r0 = [wire.deserialize_shared_result(b) for b in _unpack_blobs(p0)]
        r1 = [wire.deserialize_shared_result(b) for b in _unpack_blobs(p1)]
        return [bytes(np.frombuffer(x.shares[0].data, np.uint8)
                      ^ np.frombuffer(y.shares[0].data, np.uint8)) for x, y in zip(r0, r1)]

    assert rows(a0[0][1], a1[0][1]) == [db.data[i].tobytes() for i in batches["fast"]]
    assert rows(a0[1][1], a1[1][1]) == [db.data[i].tobytes() for i in batches["compat"]]
    assert rows(a0[2][1], a1[2][1]) == []
    for step, b in zip((3, 4, 5), stream_idx):  # one-batch lag
        assert rows(a0[step][1], a1[step][1]) == [db.data[i].tobytes() for i in b]
    items = [_unpack_blobs(a[6][1]) for a in (a0, a1)]
    for q, (i0, i1) in enumerate(zip(*items)):
        if q == 3:
            assert i0 == i1 == b"\x00"
            continue
        x = wire.deserialize_shared_result(i0[1:]).shares[0].data
        y = wire.deserialize_shared_result(i1[1:]).shares[0].data
        assert bytes(np.frombuffer(x, np.uint8) ^ np.frombuffer(y, np.uint8)) == \
            db.data[batches["aspir"][q]].tobytes()


# ---- kernels 9 and 10: the Montgomery engine (crypto/mont.py) ----

def _mont_moduli():
    rnd = random.Random(0xC0FFEE)

    def odd(bits):
        return rnd.getrandbits(bits) | (1 << (bits - 1)) | 1

    # tests/test_mont_tpu.py's moduli, and N^3 of a 2048-bit key (6144 bits)
    return rnd, [odd(61), odd(256), (1 << 255) - 19, (1 << 511) - 1, odd(1024), odd(2049),
                 odd(6144)]


def _u32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("k", range(7))
@pytest.mark.parametrize("e_max", [24, 256])
def test_mont_powmod_kernel_matches_plain_and_pow(dev, k, e_max):
    rnd, mods = _mont_moduli()
    m = mods[k]
    L = mont.words_for_modulus(m)
    rows = 3 if m.bit_length() > 4096 else 13  # 13: not a multiple of a warp
    bases = [rnd.randrange(m) for _ in range(rows - 3)] + [m - 1, 0, 1]
    exps = [rnd.getrandbits(e_max) for _ in range(rows - 1)] + [(1 << e_max) - 1]
    exps[1] = 0
    b, e = _u32(mont.ints_to_words(bases, L)).to(dev), _u32(mont.pack_exponents(exps, e_max)).to(dev)
    before = mont.mont_powmod.launches
    got = mont.mont_powmod(b, e, m, e_max)
    torch.cuda.synchronize()
    assert mont.mont_powmod.launches == before + 1
    assert mont.words_to_ints(got.cpu().numpy()) == [pow(x, y, m) for x, y in zip(bases, exps)]
    if m.bit_length() <= 4096 or e_max < 64:  # the plain version: ~10^5 small launches
        assert torch.equal(got, mont.mont_powmod_plain(b, e, m, e_max))


def test_mont_powmod_kernel_per_row_moduli(dev):
    """Moduli of different word counts in one launch (the CRT halves of
    the secret-key batches), an odd row count, and 0 / m - 1 operands."""
    rnd, mods = _mont_moduli()
    pairs = [(mods[4], mods[5]), (rnd.getrandbits(300) | (1 << 299) | 1,
                                  rnd.getrandbits(250) | (1 << 249) | 1)]
    for m1, m2 in pairs:
        ms = [m1, m2, m1, m2, m1, m2, m1]
        bases = [rnd.randrange(m) for m in ms[:-2]] + [ms[-2] - 1, 0]
        exps = [0, 1, rnd.getrandbits(200), rnd.getrandbits(300), 2, 3, rnd.getrandbits(100)]
        assert mont.device_powmod_batch_multi(bases, exps, ms) == [
            pow(b, e, m) for b, e, m in zip(bases, exps, ms)]
        L = max(mont.words_for_modulus(m) for m in ms)
        b = _u32(mont.ints_to_words([x % m for x, m in zip(bases, ms)], L)).to(dev)
        e = _u32(mont.pack_exponents(exps, 512)).to(dev)
        assert torch.equal(mont.mont_powmod(b, e, ms, 512), mont.mont_powmod_plain(b, e, ms, 512))


@pytest.mark.parametrize("h,w,bits,e_max", [
    (1, 1, 512, 24), (5, 3, 512, 24), (64, 4, 2048, 24), (67, 1, 512, 24), (130, 33, 256, 40),
    (6, 2, 384, 384), (33, 3, 3072, 2048),
])
def test_mont_scan_kernel_matches_plain_and_pow(dev, h, w, bits, e_max):
    """The scan at level-1 (short exponents) and level-2 (exponents of
    bits(N^2)) shapes on scan_plan's plans, row counts that are not
    powers of two, exponent 0 (the identity) and the all-ones exponent."""
    rnd = random.Random(h * 1000 + w)
    m = rnd.getrandbits(bits) | (1 << (bits - 1)) | 1
    L = mont.words_for_modulus(m)
    ebits = [rnd.randrange(1, m) for _ in range(h)]
    vals = [rnd.getrandbits(e_max) if rnd.random() < 0.8 else 0 for _ in range(h * w)]
    vals[-1] = (1 << e_max) - 1
    b = _u32(mont.ints_to_words(ebits, L)).to(dev)
    e = _u32(mont.pack_exponents(vals, e_max).reshape(h, w, -1)).to(dev)
    before = mont.mont_scan.launches
    got = mont.mont_scan(b, e, m, e_max)
    torch.cuda.synchronize()
    assert mont.mont_scan.launches == before + 1
    want = []
    for c in range(w):
        acc = 1
        for r in range(h):
            acc = acc * pow(ebits[r], vals[r * w + c], m) % m
        want.append(acc)
    assert mont.words_to_ints(got.cpu().numpy()) == want
    if e_max < 64 or h * w <= 32:
        assert torch.equal(got, mont.mont_scan_plain(b, e, m, e_max))
    # one row a chunk: every partial goes through the merge
    assert torch.equal(mont.mont_scan(b, e, m, e_max, row_chunk=1), got)


def test_mont_kernels_at_the_serving_bound(dev):
    """N^3 of an 8192-bit key (768 words): 32 lanes of 24 words a number,
    the largest instance."""
    rnd = random.Random(8192)
    m = rnd.getrandbits(24576) | (1 << 24575) | 1
    p = mont.scan_plan(2, 1, 768, 64, 132, 232448)
    assert (p["G"], p["K"]) == (32, 24)
    bases, exps = [rnd.randrange(m), m - 1], [rnd.getrandbits(64), 3]
    assert mont.device_powmod_batch(bases, exps, m, e_max=64) == [
        pow(b, e, m) for b, e in zip(bases, exps)]
    assert mont.device_paillier_scan(bases, exps, 1, m, e_max=64) == [
        pow(bases[0], exps[0], m) * pow(bases[1], exps[1], m) % m]


def test_paillier_engine_torch_with_no_device_runs_on_the_card(dev):
    """PirConfig(paillier_engine="torch"), the default PirConfig() (whose
    None engine resolves to "torch") and device_modexp() with no device:
    the cPIR scans, the encryption and decryption batches and the DDLEQ
    checks launch kernels 9 and 10 on the card."""
    from pir_tpu_torch import encrypted as enc
    from pir_tpu_torch import service as tsvc
    from pir_tpu_torch.config import PirConfig
    from pir_tpu_torch.crypto import paillier

    sk, pk = paillier.keygen(512)
    db = generate_random_db(64, 3)
    key_db = generate_random_db(64, 8)
    for config in (PirConfig(paillier_engine="torch"), PirConfig()):
        before = (mont.mont_powmod.launches, mont.mont_scan.launches)
        svc = tsvc.PirService(db, config=config, key_db=key_db).start()
        try:
            client = tsvc.PirClient([svc.address])
            with paillier.device_modexp():
                got = client.query_encrypted(2, sk, pk)
                w = len(got)
                assert [bytes(s.data) for s in got] == [db.data[2 * w + j].tobytes()
                                                        for j in range(w)]
                assert bytes(client.query_encrypted_recursive(41, sk, pk)[0].data) == \
                    db.data[41].tobytes()
                assert bytes(client.query_authenticated(9, sk, key_db.slot(9))[0].data) == \
                    db.data[9].tobytes()
                with pytest.raises(PermissionError):
                    client.query_authenticated(9, sk, key_db.slot(10))
            client.close()
        finally:
            svc.close()
        assert mont.mont_powmod.launches > before[0] and mont.mont_scan.launches > before[1]
    q = enc.new_encrypted_query(db.metadata(), pk, 1, 5)
    def ints(engine):
        return [[c.c for c in s.cts]
                for s in enc.private_encrypted_query(db, q, engine=engine).slots]

    assert ints("torch") == ints(None) == ints("python")


def test_cuda_cpir_batches_in_flight_match_the_python_engine(dev):
    """TorchPirServer.private_encrypted_query_batch_async on the card: two
    batches in flight under three moduli (256 and 1024 bits), taken in
    either order, give the CPython engine's ciphertexts; the exponent
    matrix is built once, and after apply_updates a batch reads the new
    rows."""
    from pir_tpu_torch import encrypted as enc
    from pir_tpu_torch.crypto import paillier
    from pir_tpu_torch.utils.metrics import reset_spans, span_totals

    db = generate_random_db(1 << 12, 3)
    srv = TorchPirServer(db, device=dev)
    keys = [paillier.keygen(256), paillier.keygen(256), paillier.keygen(1024)]
    qs = [enc.new_encrypted_query(db.metadata(), keys[k][1], 1, row)
          for k, row in ((0, 3), (1, 40), (2, 63), (2, 0), (0, 17))]
    reset_spans()
    first = srv.private_encrypted_query_batch_async(qs[:3])
    second = srv.private_encrypted_query_batch_async(qs[3:])
    got = second() + first()
    want = [enc.private_encrypted_query(db, q, engine="python") for q in qs[3:] + qs[:3]]
    assert [[c.c for c in s.cts] for r in got for s in r.slots] == \
        [[c.c for c in s.cts] for r in want for s in r.slots]
    assert span_totals()["pir.table"]["count"] == 1
    srv.apply_updates({63 * 64 + 5: b"xyz"})
    res = srv.private_encrypted_query_batch_async([qs[2]])()[0]
    assert bytes(enc.recover_encrypted(res, keys[2][0])[5].data) == b"xyz"


def test_mont_wrappers_reject_bad_operands(dev):
    m = (1 << 255) - 19
    b = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    e = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        mont.mont_powmod(torch.zeros((8, 4), dtype=torch.int32, device=dev).t(), e, m, 24)
    with pytest.raises(ValueError, match="int32"):
        mont.mont_powmod(b.to(torch.int64), e, m, 24)
    with pytest.raises(ValueError, match="cover"):
        mont.mont_powmod(b, e, m, 64)
    with pytest.raises(ValueError, match="devices"):
        mont.mont_scan(b, e.cpu().reshape(4, 1, 1), m, 24)


# ---- kernels 9 and 10 on every group shape (plans forced) ----

def _rand_mod(rnd, words):
    bits = 32 * words - rnd.randrange(0, 20)
    return rnd.getrandbits(bits) | (1 << (bits - 1)) | 1


# (L, G) with an instance of K = ceil(L / G) words a lane or more
MONT_GROUPS = [(L, G) for L in (32, 64, 96, 192) for G in (4, 8, 16, 32)
               if mont.lane_words(L, G)]


@pytest.mark.parametrize("L,G", MONT_GROUPS)
def test_mont_powmod_kernel_every_group(dev, L, G):
    """Kernel 9 at each G whose instances hold L words, 13 rows (no
    multiple of a block's groups), zero, one, m - 1, and zero and all-ones
    exponents of 70 bits (a window of 3 does not divide them)."""
    K = mont.lane_words(L, G)
    rnd = random.Random(L * 100 + G)
    m = _rand_mod(rnd, L)
    L = mont.words_for_modulus(m)
    bases = [rnd.randrange(m) for _ in range(10)] + [0, 1, m - 1]
    exps = [rnd.getrandbits(70) for _ in range(11)] + [0, (1 << 70) - 1]
    b = _u32(mont.ints_to_words(bases, L)).to(dev)
    e = _u32(mont.pack_exponents(exps, 70)).to(dev)
    for wbits, warps in ((3, 2), (1, 1)):
        got = mont.mont_powmod(b, e, m, 70, plan={"G": G, "K": K, "wbits": wbits,
                                                  "warps": warps})
        assert mont.words_to_ints(got.cpu().numpy()) == [pow(x, y, m)
                                                         for x, y in zip(bases, exps)]
    if L <= 64:
        assert torch.equal(got, mont.mont_powmod_plain(b, e, m, 70))


def test_mont_powmod_kernel_768_words(dev):
    """A batch at 768 words (N^3 of the serving bound's 8192-bit key) on
    powmod_plan's plan, against CPython pow."""
    rnd = random.Random(768)
    m = rnd.getrandbits(24576) | (1 << 24575) | 1
    bases = [rnd.randrange(m) for _ in range(4)] + [m - 1]
    exps = [rnd.getrandbits(100) for _ in range(4)] + [(1 << 100) - 1]
    b = _u32(mont.ints_to_words(bases, 768)).to(dev)
    e = _u32(mont.pack_exponents(exps, 100)).to(dev)
    got = mont.mont_powmod(b, e, m, 100)
    assert mont.words_to_ints(got.cpu().numpy()) == [pow(x, y, m) for x, y in zip(bases, exps)]


@pytest.mark.parametrize("horner", [0, 1])
@pytest.mark.parametrize("L,G", MONT_GROUPS)
def test_mont_scan_kernel_every_group(dev, L, G, horner):
    """Kernel 10 at each G whose instances hold L words, Straus and
    Horner chunks, h not a multiple of the rows a chunk, w = 1, and
    tables in slabs of two chunks (several table and chunk launches)."""
    h, w, e_max, wbits, rc = {32: (11, 1, 24, 5, 3), 64: (13, 5, 24, 6, 4), 96: (7, 3, 60, 4, 2),
                              192: (5, 2, 40, 3, 2)}[L]
    K = mont.lane_words(L, G)
    rnd = random.Random(h * 1000 + L * 10 + G)
    m = _rand_mod(rnd, L)
    L = mont.words_for_modulus(m)
    ebits = [rnd.randrange(1, m) for _ in range(h - 1)] + [m - 1]
    vals = [rnd.getrandbits(e_max) if rnd.random() < 0.8 else 0 for _ in range(h * w)]
    vals[-1] = (1 << e_max) - 1
    b = _u32(mont.ints_to_words(ebits, L)).to(dev)
    e = _u32(mont.pack_exponents(vals, e_max).reshape(h, w, -1)).to(dev)
    plan = {"G": G, "K": K, "wbits": wbits, "rc": rc, "chunks": -(-h // rc), "horner": horner,
            "cols": 32 // G, "slab_chunks": 2}
    got = mont.mont_scan(b, e, m, e_max, plan=plan)
    want = []
    for c in range(w):
        acc = 1
        for r in range(h):
            acc = acc * pow(ebits[r], vals[r * w + c], m) % m
        want.append(acc)
    assert mont.words_to_ints(got.cpu().numpy()) == want
    if L <= 64:
        assert torch.equal(got, mont.mont_scan_plain(b, e, m, e_max))


@pytest.mark.parametrize("shape", ["grid", "level2"])
def test_mont_scan_kernel_at_the_served_windows(dev, shape):
    """Kernel 10 on the window, G and chunk kind that scan_plan picks for
    the 2^20-slot grid (24-bit exponents mod a 2048-bit N^2) and for the
    recursive query's level-2 scan (2048-bit exponents mod a 6144-bit
    N^3), at fewer rows and columns, against CPython pow."""
    rnd = random.Random(2048)
    if shape == "grid":
        h, w, L, e_max = 40, 70, 64, 24
        p = mont.scan_plan(1024, 1024, 64, 24, 132, 232448)
    else:
        h, w, L, e_max = 5, 1, 96, 2048
        p = mont.scan_plan(32, 1, 96, 2048, 132, 232448)
    m = _rand_mod(rnd, L)
    L = mont.words_for_modulus(m)
    rc = min(p["rc"], 3)
    plan = dict(p, rc=rc, chunks=-(-h // rc))
    ebits = [rnd.randrange(1, m) for _ in range(h)]
    vals = [rnd.getrandbits(e_max) for _ in range(h * w)]
    b = _u32(mont.ints_to_words(ebits, L)).to(dev)
    e = _u32(mont.pack_exponents(vals, e_max).reshape(h, w, -1)).to(dev)
    got = mont.words_to_ints(mont.mont_scan(b, e, m, e_max, plan=plan).cpu().numpy())
    for c in range(w):
        acc = 1
        for r in range(h):
            acc = acc * pow(ebits[r], vals[r * w + c], m) % m
        assert got[c] == acc


# ---- the mesh engine over one card named several times ----------------------

MESH_ROWS = (1 << 14) + 700  # depth 8 at 128-bit leaves, 15 compat device levels
MESH_KERNELS = {"stacked_tail": fast_tail_expand_stacked, "packed_scan": packed_scan,
                "compat_stage": compat_stage, "compat_head": compat_head,
                "fast_tail": fast_tail_expand, "fused_scan_expand": fused_scan_expand,
                "masked_xor_scan": masked_xor_scan, "planes_scan": planes_scan}


def _mesh_db():
    db = generate_random_db(MESH_ROWS, 12)
    rng = np.random.default_rng(50)
    db.set_keywords(rng.choice(1 << 32, size=MESH_ROWS, replace=False).astype(np.uint64))
    return db, rng


def _mesh_routes(db, rng, tp):
    """(route, rows, share lists, fast_stacked, kernels its batches launch)
    of every route a tp-way grid takes on the mesh table."""
    md = db.metadata()
    rows = [0, MESH_ROWS - 1] + [int(i) for i in rng.integers(0, MESH_ROWS, 38)]
    kw = db.keywords

    def fast(n):
        return tq.new_index_query_shares_batch(md, rows[:n], 1, fast=True, leaf_bits=128,
                                               rand_bytes=rng.bytes)

    routes = [
        ("fast distinct-key (host prefix)", rows[:12],
         [tq.new_index_query_shares(md, r, 1, fast=True, leaf_bits=128, rand_bytes=rng.bytes)
          for r in rows[:12]], True, {"masked_xor_scan"}),
        ("keyword", rows[:6], tq.new_keyword_query_shares_batch(
            md, [int(kw[r]) for r in rows[:6]], 1, rand_bytes=rng.bytes), True, {"planes_scan"}),
        ("3-party index", rows[:3], [tq.new_index_query_shares(md, r, 1, num_shares=3,
                                                               rand_bytes=rng.bytes)
                                     for r in rows[:3]], True, {"planes_scan"})]
    compat = tq.new_index_query_shares_batch(md, rows, 1, rand_bytes=rng.bytes)
    if tp & (tp - 1):
        return routes + [("compat (host prefix)", rows, compat, True, {"masked_xor_scan"}),
                          ("fast shared-key (host prefix)", rows[:12], fast(12), True,
                           {"masked_xor_scan"})]
    return routes + [
        ("fast root, stacked", rows, fast(40), True, {"stacked_tail", "packed_scan"}),
        ("fast root, per-query tail", rows, fast(40), False, {"fast_tail", "packed_scan"}),
        ("compat root", rows, compat, True, {"compat_head", "compat_stage", "packed_scan"})]


def _one_card_rows(single, shares):
    if shares[0].is_two_party:
        return _rows_of(single.private_secret_shared_query_batch(shares))
    return _rows_of([single.private_secret_shared_query(s) for s in shares])


def _rows_of(results):
    return [bytes(r.shares[0].data) for r in results]


@pytest.mark.parametrize("tp,dp", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (4, 1), (4, 2)])
def test_cuda_mesh_routes_match_one_card(dev, tp, dp):
    """MeshPirServer over ["cuda:0"] * (tp * dp): every route's answers
    equal TorchPirServer's on the card, share by share, recover every row,
    and launch exactly the route's kernels; each shard's table is held
    once on the card however often the grid names it."""
    from pir_tpu_torch.parallel.mesh import MeshPirServer, make_mesh

    db, rng = _mesh_db()
    single = TorchPirServer(db)
    engines = {stacked: MeshPirServer(db, mesh=make_mesh(devices=["cuda:0"] * (tp * dp), dp=dp),
                                      fast_stacked=stacked) for stacked in (True, False)}
    for route, rows, pairs, stacked, kernels in _mesh_routes(db, rng, tp):
        answers = []
        for part in range(len(pairs[0])):
            shares = [p[part] for p in pairs]
            before = {k: f.launches for k, f in MESH_KERNELS.items()}
            got = _rows_of(engines[stacked].private_secret_shared_query_batch(shares))
            torch.cuda.synchronize()
            launched = {k for k, f in MESH_KERNELS.items() if f.launches > before[k]}
            assert launched == kernels, (route, launched)
            assert got == _one_card_rows(single, shares), route
            answers.append([np.frombuffer(a, np.uint8) for a in got])
        for i, r in enumerate(rows):
            rec = np.bitwise_xor.reduce([a[i] for a in answers])
            assert rec.tobytes() == db.data[r].tobytes(), (route, i)
    for eng in engines.values():
        for key, placed in eng._tables.items():
            assert sorted(s for s, _ in placed) == list(range(tp)), key
            assert all(t.device == torch.device("cuda", 0) for t in placed.values())


def test_cuda_mesh_after_updates_matches_one_card(dev):
    """apply_updates on a tp 4 x dp 2 grid over one card patches every
    shard table: the root, compat root, distinct-key and keyword batches
    then equal TorchPirServer's after the same updates."""
    from pir_tpu_torch.parallel.mesh import MeshPirServer, make_mesh

    db, rng = _mesh_db()
    single = TorchPirServer(db)
    eng = MeshPirServer(db, mesh=make_mesh(devices=["cuda:0"] * 8, dp=2))
    for _, _, pairs, stacked, _ in _mesh_routes(db, rng, 4):
        if stacked:
            eng.private_secret_shared_query_batch([p[0] for p in pairs])
    updates = {int(r): rng.bytes(12) for r in rng.integers(0, MESH_ROWS, 300)}
    updates[0] = bytes(range(12))
    eng.apply_updates(updates)
    single.apply_updates(updates)
    for route, _, pairs, stacked, _ in _mesh_routes(db, rng, 4):
        if stacked:
            for part in range(len(pairs[0])):
                shares = [p[part] for p in pairs]
                assert _rows_of(eng.private_secret_shared_query_batch(shares)) == \
                    _one_card_rows(single, shares), route


# ---- the all-torch fast expansion and the per-query fast answers ----------------

@pytest.mark.parametrize("leaf_bits,q", [(None, 35), (128, 35), (128, 8)])
def test_cuda_all_xla_expand_route_matches_pertail(dev, leaf_bits, q):
    """The per-query tail route with all_xla_expand (the whole walk in
    plain torch) on the card: the bytes of the tail-kernel route and of
    the CPU, one packed scan launch (the masked-XOR scan at Q <= 8) and no
    tail kernel launch; every row recovered."""
    from pir_tpu_torch.dpf.device import make_fast_payload_batch, u32_tensor
    from pir_tpu_torch.models.pipeline import fused_fast_root_batch_pertail

    db = generate_random_db(1 << 13, 8)
    gpu = TorchPirServer(db, fast_stacked=False)
    rng = np.random.default_rng(q)
    idxs = [int(i) for i in rng.integers(0, db.db_size, size=q)]
    pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True,
                                            leaf_bits=leaf_bits, rand_bytes=rng.bytes)
    k0 = pairs[0][0].key_fast
    table = gpu._root_table_u8(1, k0.depth, k0.leaf_bits // 128, stacked=False)
    answers = []
    for part in (0, 1):
        pay, layout = make_fast_payload_batch([p[part] for p in pairs])
        before = (packed_scan.launches, masked_xor_scan.launches, fast_tail_expand.launches)
        got = fused_fast_root_batch_pertail(table, u32_tensor(pay, dev), layout,
                                            gpu.tail_levels, all_xla_expand=True)
        torch.cuda.synchronize()
        after = (packed_scan.launches, masked_xor_scan.launches, fast_tail_expand.launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((1, 0, 0) if q > 8
                                                               else (0, 1, 0))
        assert torch.equal(got, fused_fast_root_batch_pertail(
            table, u32_tensor(pay, dev), layout, gpu.tail_levels))
        assert torch.equal(got.cpu(), fused_fast_root_batch_pertail(
            table.cpu(), u32_tensor(pay, "cpu"), layout, gpu.tail_levels,
            all_xla_expand=True))
        answers.append(got.cpu().numpy())
    rec = answers[0] ^ answers[1]
    assert all(rec[i, :8].tobytes() == db.data[r].tobytes() for i, r in enumerate(idxs))


def _per_query_fast(db, idxs, mdn, rng):
    """Both shares of fast queries (128-bit leaves) as per-query payloads:
    [(payloads (Q, total) uint32, layout, perm)] a share."""
    from pir_tpu_torch.dpf import host as thost
    from pir_tpu_torch.dpf.device import make_device_fast_key, pack_fast_payload

    pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True, leaf_bits=128,
                                            rand_bytes=rng.bytes)
    out = []
    for part in (0, 1):
        keys = [make_device_fast_key(thost.server_initialize(p[part].prf_keys,
                                                             p[part].key_fast.depth),
                                     p[part].key_fast, mdn) for p in pairs]
        packed = [pack_fast_payload(k) for k in keys]
        out.append((np.stack([p for p, _ in packed]), packed[0][1], keys[0]))
    return out


def test_cuda_fused_fast_answers_match_cpu(dev):
    """The six per-query fast answers on the card equal their CPU results;
    the masked-XOR variants launch the masked-XOR scan kernel once, the
    others the bit-plane scan kernel once; both shares recover every
    row."""
    from pir_tpu_torch.dpf.device import _fast_leaf_perm, scatter_rows_to_storage_order
    from pir_tpu_torch.dpf.device import u32_tensor
    from pir_tpu_torch.models import pipeline as tpipe
    from pir_tpu_torch.ops.scan import pack_table_u32

    h, slot = 1 << 13, 6
    db = generate_random_db(h, slot)
    rng = np.random.default_rng(17)
    idxs = [0, h - 1, 4321, 77, 5000]
    shares = _per_query_fast(db, idxs, 4, rng)
    dkey = shares[0][2]
    mp, d = dkey.plan.m_padded, dkey.plan.device_levels
    assert d == 4
    words = pack_table_u32(db.data, h, 1)
    swords = scatter_rows_to_storage_order(words, _fast_leaf_perm(d, h, mp), (mp << d) * 128)
    tables = {"words": words.view(np.int32), "u8": words.view(np.uint8),
              "swords": swords.view(np.int32), "su8": swords.view(np.uint8)}
    masked = {"masked_xor_scan": 1, "planes_scan": 0}
    planes = {"masked_xor_scan": 0, "planes_scan": 1}
    funcs = {  # name: (table, natural order, batch, launches)
        "fused_fast_answer": ("words", True, False, masked),
        "fused_fast_answer_batch": ("words", True, True, masked),
        "fused_fast_answer_batch_mxu": ("u8", True, True, planes),
        "fused_fast_answer_batch_preplane": ("u8", True, True, planes),
        "fused_fast_answer_batch_storage": ("su8", False, True, planes),
        "fused_fast_answer_storage": ("swords", False, False, masked),
    }
    kernels = {"masked_xor_scan": masked_xor_scan, "planes_scan": planes_scan}
    for name, (tab, natural, batch, launches) in funcs.items():
        fn = getattr(tpipe, name)
        rows = []
        for pays, layout, key in shares:
            outs = []
            for device in (dev, "cpu"):
                t = torch.from_numpy(np.ascontiguousarray(tables[tab])).to(device)
                perm = torch.from_numpy(key.perm).to(device)
                before = {k: f.launches for k, f in kernels.items()}
                if batch:
                    p = u32_tensor(pays, device)
                    got = fn(t, p, perm, layout) if natural else fn(t, p, layout)
                    n_calls = 1
                else:
                    got = torch.stack([
                        fn(t, u32_tensor(r, device), perm, layout) if natural
                        else fn(t, u32_tensor(r, device), layout) for r in pays])
                    n_calls = len(pays)
                if device == dev:
                    torch.cuda.synchronize()
                    assert {k: f.launches - before[k] for k, f in kernels.items()} == {
                        k: n * n_calls for k, n in launches.items()}, name
                outs.append(got.cpu())
            assert torch.equal(outs[0], outs[1]), name
            rows.append(outs[0].numpy().view(np.uint8).reshape(len(idxs), -1)[:, :slot])
        rec = rows[0] ^ rows[1]
        assert all(rec[i].tobytes() == db.data[r].tobytes() for i, r in enumerate(idxs)), name


def test_cuda_fast_routes_below_the_root_match_cpu_server(dev):
    """Fast keys of depth 4 with device levels (min_device_nodes 2): a
    single (the storage-order word table) and a batch of 3 (the per-query
    batch path) on the card equal the CPU server's bytes, one masked-XOR
    scan launch each, and recover."""
    db = generate_random_db(2048, 3)
    gpu = TorchPirServer(db, min_device_nodes=2)
    cpu = TorchPirServer(db, device="cpu", min_device_nodes=2)
    rng = np.random.default_rng(29)
    idxs = [0, 2047, 1000]
    pairs = tq.new_index_query_shares_batch(db.metadata(), idxs, 1, fast=True, leaf_bits=128,
                                            rand_bytes=rng.bytes)
    assert pairs[0][0].key_fast.depth == 4
    for idx, pair in zip(idxs, pairs):
        res = []
        for s in pair:
            before = masked_xor_scan.launches
            res.append(gpu.private_secret_shared_query(s))
            assert masked_xor_scan.launches == before + 1
            assert res[-1].shares[0].data == cpu.private_secret_shared_query(s).shares[0].data
        assert bytes(tq.recover(res)[0].data) == db.data[idx].tobytes()
    assert any(k[0] == "storage words" for k in gpu._tables)
    before = masked_xor_scan.launches
    _check_servers(gpu, cpu, db, idxs, pairs)
    assert masked_xor_scan.launches == before + 2
