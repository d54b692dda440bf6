"""A numpy model of kernel 8's wgmma product chain (csrc/overlap_probe.cu),
lane by lane, held against the plain version (mxu_chain).

The kernel has no host build, so its index math runs only on the card.
This model replays it at the kernel's own geometry, vectorised over the
64 blocks (4 clusters of 16): the fill of each block's shared memory
(the A fragments of a and of a + 1 in fragment order, b's bulk and
critical slices K-major with the 128-byte swizzle), the A registers each
lane loads by its rows' bits, the wgmma operands (A in the m64nNk32
register layout, B read through the descriptor: start address, stride
offset, 128-byte swizzle) over the block's K slice, the critical tile's
column-0 bits (two ballots a warp), the one-hop exchange of those words
into every peer's slot and the XOR each reader takes, the bulk's partial
sums and the epilogue that adds the 16 K slices over distributed shared
memory. Shared memory starts as garbage, so a read of a word no thread
stored shows as a wrong result. The products run in torch (one thread,
tests/torch_threads.py), exact in float32 (|partial| < 2^23). The
constants are read from the source, so a change of tiling there fails
here first.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pir_tpu_torch import benchmarks_overlap as ov
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = (Path(__file__).resolve().parents[1] / "pir_tpu_torch" / "csrc"
       / "overlap_probe.cu").read_text()
U32 = np.uint32


def _const(name):
    return re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1).split("//")[0].strip()


CLUSTER, NGROUPS, SLOTS = int(_const("kCluster")), int(_const("kNGroups")), int(_const("kSlots"))
BULK_N, CRIT_N = ov.N // NGROUPS, int(_const("kCritN"))
K_SLICE = ov.K // CLUSTER
K_STEPS = K_SLICE // 32
BLOCKS = (ov.M // 64) * NGROUPS * CLUSTER
FRAG_U4 = 4 * K_STEPS * 4 * 32  # uint4 entries of the A fragments (4 variants)

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
REG4, BYTE4 = np.arange(4), np.arange(4)
# PTX ISA, wgmma m64nNk32 .s8 with A in registers: warp w of the group owns
# rows 16 w + ..; a lane's register i holds 4 k bytes of one row
A_ROW = G[:, None, None] + 8 * (REG4 % 2)[None, :, None] + 0 * BYTE4  # (lane, reg, byte)
A_COL = 4 * T[:, None, None] + BYTE4[None, None, :] + 16 * (REG4 // 2)[None, :, None]
D_ROW = G[:, None] + 8 * (REG4 // 2)  # (lane, q) of each n8 block j: d[4 j + q]
D_COL = 2 * T[:, None] + REG4 % 2


def test_model_constants_are_the_kernels():
    assert "mma.sync" not in SRC  # every product is a wgmma
    assert CLUSTER == ov.CLUSTER == 16 and NGROUPS == 2 and SLOTS == 4
    assert _const("kBulkN") == "kN / kNGroups" and CRIT_N == 8
    assert _const("kKSlice") == "kK / kCluster" and K_STEPS == ov.CRIT_STEPS == 8
    assert _const("kBlocks") == "kMTiles * kNGroups * kCluster" and BLOCKS == ov.PROBE_BLOCKS
    assert _const("kVWords") == "64 * 512 / kBlocks" and int(_const("kIntThreads")) == 128
    assert int(_const("kSplitThreads")) == 128
    assert int(_const("kMmaThreads")) == 256
    assert "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8" in SRC
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in SRC
    assert '#include "packed_planes.cuh"' in SRC and "using pir_planes::plane_offset;" in SRC
    # the fills, the loads by the bits, the ballot, the slots, the epilogue
    assert "((w & 0x7F7F7F7Fu) + 0x01010101u) ^ (w & 0x80808080u)" in SRC
    assert "p + 8 * kK * (i & 1) + 16 * (i >> 1)" in SRC
    assert ("frag[(v * kKSteps + ks) * 128 + w * 32 + ln] =\n"
            "            make_uint4(r[v & 1][0], r[v >> 1][1], r[v & 1][2], r[v >> 1][3]);") in SRC
    assert "(k / 128) * (kBulkN * 128) + plane_offset(n, k % 128)" in SRC
    assert "(k / 128) * (kCritN * 128) + plane_offset(n, k % 128)" in SRC
    assert "frag + (((bits >> (4 * (lane / 4))) & 3) * kKSteps * 4 + w) * 32 + lane;" in SRC
    assert "const uint4 x = p[ks * 4 * 32];" in SRC
    assert "a[ks][0] = x.x;\n    a[ks][1] = x.y;\n    a[ks][2] = x.z;\n    a[ks][3] = x.w;" in SRC
    assert "(__ballot_sync(0xffffffffu, col0 && (d[2] & 1)) << 1)" in SRC
    assert "reinterpret_cast<uint32_t*>(&tl.mine)[w] = word;" in SRC
    assert "const uint32_t peer = 4 * w + (lane & 3);" in SRC and "if (lane < kCluster / 4)" in SRC
    assert "const uint32_t to_slot = in_rank(smem_u32(&tl.slot[0][rank]), peer);" in SRC
    assert "const uint32_t to_full = in_rank(smem_u32(&tl.full[0]), peer);" in SRC
    assert ("st_async(to_slot + s * sizeof(tl.slot[0]), tl.mine, to_full + s * sizeof(tl.full[0]));"
            in SRC)
    assert "return desc0 + (((ks / 4) * (n_rows * 128) + 32 * (ks % 4)) >> 4);" in SRC
    assert "uint4 slot[kSlots][kCluster];" in SRC
    assert "constexpr uint32_t kSlotBytes = kCluster * 16;" in SRC
    assert ("lane < kCluster ? reinterpret_cast<const uint32_t*>(tl.slot[s])[4 * lane + w] : 0u;"
            in SRC)
    assert "return __reduce_xor_sync(0xffffffffu, x);" in SRC
    assert "const int s = it % kSlots;" in SRC and "const int s = (it - 1) % kSlots;" in SRC
    assert "mbar_init(smem_u32(&tl.full[s]), 1);" in SRC
    assert ("part[(16 * w + g + 8 * (q / 2)) * kBulkN + 8 * j + 2 * t + (q & 1)] = "
            "acc[4 * j + q];") in SRC
    assert "const int o = tid + kMmaThreads * e;" in SRC
    assert "const int r = 4 * static_cast<int>(rank) + o / kBulkN, col = o % kBulkN;" in SRC
    assert "mo[(row0 + r) * kN + col0 + col] = sum;" in SRC
    assert "row0 = 64 * (c / kNGroups), col0 = kBulkN * (c % kNGroups);" in SRC
    assert "ks > 0);" in SRC  # each round's first product overwrites (scale-d 0)


def plane_offset(n, k):
    """packed_planes.cuh's plane_offset: byte (n, k) of a 128-byte-swizzled
    K-major tile (k < 128)."""
    return (n >> 3) * 1024 + (n & 7) * 128 + ((((k >> 4) ^ n) & 7) << 4) + (k & 15)


def step_addr(base, n_rows, ks):
    """The start address step_desc gives k32 step ks of a slice at base."""
    return base + (ks // 4) * (n_rows * 128) + 32 * (ks % 4)


def desc_b_offsets(start, n_cols):
    """The bytes a wgmma reads for B (32 x n_cols, K-major) through
    desc_sw128(start), as the PTX ISA defines them: row n of the canonical
    128-byte-swizzle layout at start + (n / 8) 1024 + (n % 8) 128, k-chunk
    c (16 bytes) at + 16 c, then address bits 4-6 XORed with bits 7-9.
    -> (32, n_cols) offsets from a 1024-aligned base."""
    n = np.arange(n_cols)
    k = np.arange(32)[:, None]
    logical = start + (n >> 3) * 1024 + (n & 7) * 128 + (k >> 4) * 16 + (k & 15)
    return logical ^ (((logical >> 7) & 7) << 4)


@pytest.mark.parametrize("n_rows", [BULK_N, CRIT_N])
def test_b_slices_are_what_the_descriptors_read(n_rows):
    """Byte (n, k) of a K slice, stored at (k / 128) n_rows 128 +
    plane_offset(n, k % 128), is the byte the descriptor of k step k / 32
    reads at (k % 32, n), for every k of the slice."""
    for ks in range(K_STEPS):
        offs = desc_b_offsets(step_addr(0, n_rows, ks), n_rows)
        k = 32 * ks + np.arange(32)[:, None]
        n = np.arange(n_rows)
        assert (offs == (k // 128) * (n_rows * 128) + plane_offset(n, k % 128)).all()


def test_v_words_each_owned_once():
    """Every placement covers the 32768 words of v once: A alone (kVpuBlocks
    blocks of kIntThreads threads), C split (the 64 blocks, kSplitThreads
    threads), each thread words i0 + threads e of its block's; C in one
    body (the bulk warpgroup's 128 threads, words i + 128 e)."""
    assert "x[e] = src[i0 + kThreads * e];" in SRC
    assert "int_chain<kVpuWords, kIntThreads>(v, vo, threadIdx.x, iters);" in SRC
    assert "int_chain<kVWords, kSplitThreads>(v, vo, tid - kMmaThreads, iters);" in SRC
    assert "x[e] = v[blockIdx.x * kVWords + i + 128 * e];" in SRC
    assert "const int i = tid - 128;" in SRC and _const("kBodyElems") == "kVWords / 128"
    assert _const("kVpuWords") == "64 * 512 / kVpuBlocks"
    owners = []
    for blocks, threads in ((int(_const("kVpuBlocks")), int(_const("kIntThreads"))),
                            (BLOCKS, int(_const("kSplitThreads"))), (BLOCKS, 128)):
        words = 64 * 512 // blocks
        blk = np.arange(blocks)[:, None, None]
        owners.append(blk * words + np.arange(threads)[None, :, None]
                      + threads * np.arange(words // threads)[None, None, :])
    for own in owners:
        assert np.array_equal(np.sort(own.ravel()), np.arange(64 * 512))


def inc_bytes(w):
    return ((w & U32(0x7F7F7F7F)) + U32(0x01010101)) ^ (w & U32(0x80808080))


def test_inc_bytes_is_the_int8_add_that_wraps():
    x = np.arange(256, dtype=np.uint8)
    w = x.astype(U32) * U32(0x01010101)
    want = ((x.astype(np.int16) + 1 + 128) % 256 - 128).astype(np.int8).view(np.uint8)
    assert (inc_bytes(w) == want.astype(U32) * U32(0x01010101)).all()


class Blocks:
    """The 64 blocks' shared memory after the fill: A fragments (uint32
    quadruples, 4 variants), b's bulk and critical slices (bytes); block
    16 c + r is rank r of cluster c. Everything starts as garbage."""

    def __init__(self, a, b, garbage):
        self.cl = np.arange(BLOCKS) // CLUSTER
        self.rank = np.arange(BLOCKS) % CLUSTER
        self.row0 = 64 * (self.cl // NGROUPS)
        self.col0 = BULK_N * (self.cl % NGROUPS)
        self.k0 = K_SLICE * self.rank
        self.frag = garbage.integers(0, 1 << 32, (BLOCKS, 4 * FRAG_U4), dtype=U32)
        self.bulk_b = garbage.integers(0, 256, (BLOCKS, K_SLICE * BULK_N), dtype=np.uint8)
        self.crit_b = garbage.integers(0, 256, (BLOCKS, K_SLICE * CRIT_N), dtype=np.uint8)
        self.part = garbage.integers(-(1 << 31), 1 << 31, (BLOCKS, 64 * BULK_N), dtype=np.int64)
        # [slot][sender rank][its 4 warps' words]
        self.slot = garbage.integers(0, 1 << 32, (BLOCKS, SLOTS, CLUSTER, 4), dtype=U32)
        a_words = np.ascontiguousarray(a).view("<u4")  # (M, K / 4)
        e = np.arange(FRAG_U4 // 4)
        ln, w, ks = e % 32, (e // 32) % 4, e // 128
        row = self.row0[:, None] + 16 * w + ln // 4
        k = self.k0[:, None] + 32 * ks + 4 * (ln % 4)
        # [+ 1][row g k lo, row g + 8 k lo, row g k hi, row g + 8 k hi]
        r0 = [a_words[row + 8 * (i & 1), (k + 16 * (i >> 1)) // 4] for i in range(4)]
        r = [r0, [inc_bytes(x) for x in r0]]
        for v in range(4):
            idx = (v * K_STEPS + ks) * 128 + w * 32 + ln
            for i in range(4):
                self.frag[:, 4 * idx + i] = r[(v & 1) if i % 2 == 0 else (v >> 1)][i]
        bu = b.view(np.uint8)
        for dst, n_cols, col0 in ((self.bulk_b, BULK_N, self.col0), (self.crit_b, CRIT_N, 0)):
            e = np.arange(K_SLICE * n_cols)
            n, k = e % n_cols, e // n_cols
            dst[:, (k // 128) * (n_cols * 128) + plane_offset(n, k % 128)] = \
                bu[self.k0[:, None] + k, np.asarray(col0).reshape(-1, 1) + n]


def load_a(blk, bits):
    """Each lane's A registers of the round, (block, warp, lane, ks, reg)
    uint32: the variant its rows' bits (block, warp) pick, one 16-byte
    load a k step."""
    w = np.arange(4)[None, :, None]
    lane = LANE[None, None, :]
    var = (bits[:, :, None] >> (U32(4) * G.astype(U32))) & U32(3)
    base = (var.astype(np.int64) * K_STEPS * 4 + w) * 32 + lane  # uint4 index
    idx = base[..., None] + np.arange(K_STEPS) * 128
    nb = np.arange(BLOCKS)[:, None, None, None]
    return np.stack([blk.frag[nb, 4 * idx + i] for i in range(4)], -1)


def a_matrix(regs):
    """The (block, 64, K_SLICE) s8 A operand the lanes' registers hold."""
    by = np.ascontiguousarray(regs).view(np.int8).reshape(*regs.shape, 4)  # little-endian bytes
    out = np.zeros((BLOCKS, 64, K_SLICE), np.int8)
    w = np.arange(4)[:, None, None, None, None]
    ks = np.arange(K_STEPS)[None, None, :, None, None]
    rows = 16 * w + A_ROW[None, :, None, :, :]
    cols = 32 * ks + A_COL[None, :, None, :, :]
    rows, cols = np.broadcast_arrays(rows, cols)
    out[:, rows, cols] = by
    return out


def b_matrix(region, n_cols):
    """The (block, K_SLICE, n_cols) s8 B operand the descriptors read."""
    offs = np.concatenate([desc_b_offsets(step_addr(0, n_cols, ks), n_cols)
                           for ks in range(K_STEPS)])
    return region[:, offs].view(np.int8)


def product(am, bm):
    return (torch.from_numpy(am.astype(np.float32)) @ torch.from_numpy(bm.astype(np.float32))
            ).numpy().astype(np.int64)


def lane_regs(d, n8_blocks):
    """Each lane's accumulators d[4 j + q] of a (block, 64, 8 n8_blocks)
    sum: (block, warp, lane, 4 n8_blocks)."""
    w = np.arange(4)[:, None, None, None]
    j = np.arange(n8_blocks)[None, None, :, None]
    rows = 16 * w + D_ROW[None, :, None, :]
    cols = 8 * j + D_COL[None, :, None, :]
    return d[:, rows, cols].reshape(BLOCKS, 4, 32, 4 * n8_blocks)


def model_mxu(a, b, iters, seed, flip=False):
    """overlap_kernel<kMxu>'s products, exchanges and epilogue; `flip`
    flips block 0's warp-0 bit of row 0 in every read of a slot."""
    blk = Blocks(a, b, np.random.default_rng(seed))
    bits = np.zeros((BLOCKS, 4), U32)
    bm_bulk, bm_crit = b_matrix(blk.bulk_b, BULK_N), b_matrix(blk.crit_b, CRIT_N)
    acc = np.zeros((BLOCKS, 64, BULK_N), np.int64)
    for it in range(iters):
        if it > 0:  # every reader XORs word w of the 16 senders' vectors
            s = (it - 1) % SLOTS
            bits = np.bitwise_xor.reduce(blk.slot[:, s], axis=1)  # (block, warp)
            bits[0, 0] ^= U32(flip)
        am = a_matrix(load_a(blk, bits))
        acc = product(am, bm_bulk)
        if it + 1 == iters:
            break
        d = lane_regs(product(am, bm_crit), 1)  # (block, warp, lane, 4)
        col0 = T == 0
        lane = LANE.astype(np.uint64)
        ballot0 = ((col0 & ((d[..., 0] & 1) == 1)).astype(np.uint64) << lane).sum(-1)
        ballot2 = ((col0 & ((d[..., 2] & 1) == 1)).astype(np.uint64) << lane).sum(-1)
        mine = (ballot0 | ballot2 << 1).astype(U32)  # (block, warp): tl.mine
        s = it % SLOTS
        for w in range(4):  # lane q of warp w sends the vector to block 4 w + q
            for q in range(CLUSTER // 4):
                dst = blk.cl * CLUSTER + 4 * w + q
                blk.slot[dst, s, blk.rank] = mine
    # the bulk's partial sums by lane, then block r adds rows 4 r .. 4 r + 3
    regs = lane_regs(acc, BULK_N // 8)
    w, g, t = np.arange(4)[:, None, None], G[None, :, None], T[None, :, None]
    j, q = np.arange(BULK_N // 2)[None, None, :] // 4, np.arange(BULK_N // 2)[None, None, :] % 4
    idx = (16 * w + g + 8 * (q // 2)) * BULK_N + 8 * j + 2 * t + (q & 1)  # (warp, lane, 4 j + q)
    blk.part[np.arange(BLOCKS)[:, None, None, None], idx] = regs
    out = np.full((ov.M, ov.N), -1, np.int64)
    o = np.arange(4 * BULK_N)  # tid + 256 e
    r = 4 * blk.rank[:, None] + o // BULK_N
    col = o % BULK_N
    peers = blk.cl[:, None, None] * CLUSTER + np.arange(CLUSTER)
    total = blk.part[peers, (r * BULK_N + col)[:, :, None]].sum(-1)
    total = (total + (1 << 31)) % (1 << 32) - (1 << 31)  # the int32 adds
    out[blk.row0[:, None] + r, blk.col0[:, None] + col] = total
    return out


def _inputs(seed, edge):
    _, a, b = ov.make_inputs(seed)
    a, b = a.numpy().copy(), b.numpy().copy()
    if edge:
        a[::3, ::5] = 127
        a[1::3, ::7] = -128
        b[:, 0] = 2 * (b[:, 0] // 2)
        b[0, 0] = 1
        a[::2, 0] = 1  # these rows' column-0 parity flips every round
    return a, b


@pytest.mark.parametrize("iters", [1, 2, 7])
@pytest.mark.parametrize("edge", [False, True], ids=["seeded", "edge"])
def test_model_equals_mxu_chain(iters, edge):
    a, b = _inputs(iters + 3, edge)
    want = ov.mxu_chain(torch.from_numpy(a), torch.from_numpy(b), iters).numpy()
    got = model_mxu(a, b, iters, seed=iters)
    assert np.array_equal(got, want)
    if edge and iters > 1:
        bits = [ov.mxu_chain(torch.from_numpy(a), torch.from_numpy(b), t)[::2, 0] & 1
                for t in (iters - 1, iters)]
        assert not torch.equal(*bits)


def test_model_sees_a_wrong_bit():
    """The model is sharp: one flipped bit of a sent word changes the
    result (the reader's row picks the other fragments)."""
    a, b = _inputs(9, False)
    want = ov.mxu_chain(torch.from_numpy(a), torch.from_numpy(b), 2).numpy()
    assert np.array_equal(model_mxu(a, b, 2, seed=2), want)
    assert not np.array_equal(model_mxu(a, b, 2, seed=2, flip=True), want)
