"""A numpy model of the packed-words bit-plane tile (csrc/packed_planes.cuh)
as kernel 2 (csrc/packed_scan.cu), kernel 5's scan items
(csrc/fused_scan_expand.cu) and kernel 6 (csrc/planes_scan.cu) run it,
lane by lane, held against the plain versions
(ops/packed_scan.packed_scan_plain, ops/matmul_scan.mxu_batched_scan).

The kernels have no host build, so their index math runs only on the card:
the launch grid and its row chunks (kernel 5: the spread of scan items
among tail items, chunk-major), kernel 6's pack pre-pass (bit 0 of each
selection byte into the tile's words, 16-byte or byte loads, zeros past
the rows), the cp.async stages (raw table words as [column word][row]
with rows of 132 words, the selection words as [word row][query], zeros
past the edges) in a ring of 4 slots, the expansion of a stage into bit
planes (a 16-byte read of 4 rows, the 4 x 4 byte transpose by
__byte_perm, planes masked in place, stored K-major with the 128-byte
swizzle into one of two plane buffers), the A registers spread from the
packed words (a nibble to 4 bytes), the wgmma operands (A in the
m16n8k32 register layout, warp w of a group owning rows 16 w..; B read
through the descriptor: start address, stride offset, 128-byte swizzle),
the accumulator layout, and the epilogue's plane bits, lane shuffle and
atomicXor; each for the 128-query tile (one set of planes) and the
small-batch tile (kSets = 2: 64 queries, two sets of planes, warpgroup g
on the columns of set g). This model replays each of them with numpy,
vectorised over the 256 threads of a block and over groups of blocks,
at the shapes of the card tests (tests/test_torch_cuda.py); the products
run in torch (one thread, tests/torch_threads.py), whose matmul does not
contend for the host's cores as a threaded BLAS does beside other
workers. Shared memory starts as garbage, so a read of a word no thread
stored shows as a wrong byte. Change the model with the kernels' tiling
and run it here first.
"""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pir_tpu_torch.ops.matmul_scan import mxu_batched_scan
from pir_tpu_torch.ops.packed_scan import packed_scan_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parents[1] / "pir_tpu_torch" / "csrc"

THREADS, QB, STAGE_ROWS, STAGES, RAW_STRIDE = 256, 128, 128, 4, 132
STAGE_WORD_ROWS = STAGE_ROWS // 32
MAX_CHUNK_ROWS = 1 << 24
COLS = 32  # byte columns a block: N = 8 planes x 32
PLANE_BYTES = 8 * COLS * STAGE_ROWS  # one set of planes of a stage
TARGET_BLOCKS, MAX_GRID_YZ = 32 * 132, 65535  # packed_scan.cu
CHUNK_WORD_ROWS = 512  # fused_scan_expand.cu
PLANES_TARGET_BLOCKS, SMALL_BATCH = 8 * 132, 64  # planes_scan.cu

TID = np.arange(THREADS)
WARP, LANE = TID // 32, TID % 32
LANE32 = np.arange(32)
G, T = LANE32 // 4, LANE32 % 4  # fragment group, thread in group
U32 = np.uint32


def _consts(path):
    src = (CSRC / path).read_text()
    return src, lambda name: re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);",
                                       src).group(1).split("//")[0].strip()


def test_model_constants_are_the_kernels():
    src, const = _consts("packed_planes.cuh")
    assert int(const("kThreads")) == THREADS and int(const("kQueriesPerBlock")) == QB
    assert int(const("kStageRows")) == STAGE_ROWS and int(const("kStages")) == STAGES
    assert const("kRawStride") == "kStageRows + 4" and const("kMaxChunkRows") == "1LL << 24"
    assert int(const("kCols")) == COLS and const("kColWords") == "kCols / 4"
    assert "__byte_perm(w0, w1, 0x5140)" in src and "__byte_perm(lo01, lo23, 0x7632)" in src
    assert "((u & 0xFu) * 0x00204081u) & 0x01010101u" in src
    assert "0x01010101u << p" in src and "& (1u << p)" in src
    assert "(n >> 3) * 1024 + (n & 7) * 128 + ((((k >> 4) ^ n) & 7) << 4) + (k & 15)" in src
    assert "static_cast<uint64_t>(1024 >> 4) << 32" in src  # stride offset
    assert "static_cast<uint64_t>(1) << 62" in src  # 128-byte swizzle
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in src
    assert "desc_sw128(pl + 32 * ks)" in src and "4 * lane);" in src
    assert "first && ks == 0 ? 0 : 1" in src  # the first product of a chunk: scale-d 0
    # the small-batch tile: queries, column words and plane sets by kSets
    assert "static constexpr int kQueries = kQueriesPerBlock / kSets;" in src
    assert "static constexpr int kColWords = kSets * pir_planes::kColWords;" in src
    assert "const int cw = warp + kColWords * set;" in src
    assert "(kSets == 1 ? 64 * (warp / 4) : 0) + lane / 4" in src  # the A rows
    assert "kSets == 2 ? (warp / 4) * kPlaneBytes : 0" in src  # warpgroup g's planes
    assert "(kSets == 2 ? kColWords * (warp / 4) : 0)" in src  # and columns
    assert "static_cast<int>((r_end + 31) / 32)" in src  # a partial last word row
    src, const = _consts("packed_scan.cu")
    assert int(const("kMaxGridYZ")) == MAX_GRID_YZ
    assert const("kTargetBlocks") == "32 * 132" and '#include "packed_planes.cuh"' in src
    src, const = _consts("fused_scan_expand.cu")
    assert int(const("kChunkWordRows")) == CHUNK_WORD_ROWS
    assert '#include "packed_planes.cuh"' in src
    src, const = _consts("planes_scan.cu")
    assert const("kTargetBlocks") == "8 * 132" and '#include "packed_planes.cuh"' in src
    assert "((x & 0x01010101u) * 0x01020408u) >> 24" in src
    assert "q <= kSmallBatch ? launch_scan<2>" in src and "mma.sync" not in src
    assert not (CSRC / "packed_scan.cuh").exists()


def byte_perm(x, y, s):
    """__byte_perm(x, y, s): byte i of the result is byte (s >> 4 i) & 7
    of the 8 bytes y:x (x the low word)."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, U32)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)).astype(U32) << U32(8 * i)
    return out


def transpose4x4(w0, w1, w2, w3):
    """The tile's transpose4x4, selector for selector."""
    lo01, lo23 = byte_perm(w0, w1, 0x5140), byte_perm(w2, w3, 0x5140)
    hi01, hi23 = byte_perm(w0, w1, 0x7362), byte_perm(w2, w3, 0x7362)
    return (byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632))


def spread_nibble(u):
    """spread_nibble: bits 0..3 of u -> bytes 0..3 of 0 / 1 (u32 product)."""
    return ((u & U32(0xF)) * U32(0x00204081)) & U32(0x01010101)


def test_spread_nibble_puts_each_bit_in_its_byte():
    u = np.arange(1 << 8, dtype=U32) << U32(20) | np.arange(1 << 8, dtype=U32)  # high bits set
    want = sum(((u >> U32(j)) & U32(1)) << U32(8 * j) for j in range(4))
    assert (spread_nibble(u) == want).all()


def s8_bytes(words):
    """The 4 bytes of each u32 as s8 values, byte 0 first (little-endian)."""
    return np.ascontiguousarray(words, "<u4").view(np.int8).reshape(*words.shape, 4)


def test_plane_bit_survives_the_s8_sum():
    """Bytes 2^p (p = 7: -128 as s8) sum to a number whose bit p is the
    count's parity, also when the int32 sum wraps."""
    rng = np.random.default_rng(7)
    for p in range(8):
        n = rng.integers(0, 1 << 25, 64)
        val = np.int64(np.int8(np.uint8(1 << p)))
        s = (n * val + (1 << 31)) % (1 << 32) - (1 << 31)  # the int32 sum, wrapped
        assert ((s >> p) & 1 == n & 1).all()


def plane_offset(n, k):
    """plane_offset: byte of plane row n (of 128 bytes) and row k."""
    return (n >> 3) * 1024 + (n & 7) * 128 + ((((k >> 4) ^ n) & 7) << 4) + (k & 15)


def desc_sw128(saddr):
    """desc_sw128's 64-bit descriptor."""
    return ((saddr >> 4) & 0x3FFF) | 1 << 16 | (1024 >> 4) << 32 | 1 << 62


def desc_b_offsets(desc):
    """The bytes a wgmma reads for B (32 x N, K-major) through a descriptor,
    as the PTX ISA defines them: row n of the canonical 128-byte-swizzle
    layout at start + (n / 8) SBO + (n % 8) 128, k-chunk c (16 bytes) at
    + 16 c, then address bits 4-6 XORed with bits 7-9. -> (32, N) offsets."""
    assert desc >> 62 == 1  # 128-byte swizzle
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    n = np.arange(8 * COLS)
    k = np.arange(32)[:, None]
    logical = start + (n >> 3) * sbo + (n & 7) * 128 + (k >> 4) * 16 + (k & 15)
    return logical ^ (((logical >> 7) & 7) << 4)


def test_plane_layout_is_the_descriptors():
    """Every plane byte a thread stores is the byte the descriptor's read
    of the same (n, k) finds, for each k32 step of a stage."""
    for ks in range(STAGE_WORD_ROWS):
        offs = desc_b_offsets(desc_sw128(32 * ks))
        n = np.arange(8 * COLS)
        k = 32 * ks + np.arange(32)[:, None]
        assert (offs == plane_offset(n, k)).all()


# PTX ISA, mma.m16n8k32 / wgmma m64nNk32 with .s8 A in registers: a lane's
# (g, t) registers in warp w % 4 of its group cover rows 16 (w % 4) + ...
REG4, BYTE4 = np.arange(4), np.arange(4)
A_ROW = G[:, None, None] + 8 * (REG4 % 2)[None, :, None] + 0 * BYTE4  # (32, reg, byte)
A_COL = 4 * T[:, None, None] + BYTE4[None, None, :] + 16 * (REG4 // 2)[None, :, None]
D_ROW = G[:, None] + 8 * (REG4 // 2)  # (32, i) of each n8 block j: d[4 j + i]
D_COL = 2 * T[:, None] + REG4 % 2


def test_fragment_layouts_cover_each_element_once():
    a = np.zeros((16, 32), int)
    np.add.at(a, (A_ROW, A_COL), 1)
    d = np.zeros((16, 8), int)
    np.add.at(d, (D_ROW, D_COL), 1)
    assert (a == 1).all() and (d == 1).all()


class Smem:
    """A group of blocks' dynamic shared memory (from the 1024-aligned
    base), garbage at first, and its regions, for `sets` sets of planes."""

    def __init__(self, nb, garbage, sets):
        self.sets = sets
        self.qb = QB // sets
        self.colw = sets * COLS // 4
        self.plane_bytes = sets * PLANE_BYTES  # a stage's planes
        self.raw_words = self.colw * RAW_STRIDE
        self.words_stage = STAGE_WORD_ROWS * self.qb
        self.raw0 = 2 * self.plane_bytes // 4  # in words
        self.wsh0 = self.raw0 + STAGES * self.raw_words
        size = self.wsh0 + STAGES * self.words_stage
        self.w32 = garbage.integers(0, 1 << 32, (nb, size), U32)
        self.b8 = self.w32.view(np.uint8)


def issue_stage(sm, tw, words, r0, w_end, col_w0, q0, live, slot):
    """issue_stage of the live blocks: the cp.async copies of a stage's
    raw table words and selection words, zeros where the kernel masks."""
    h, bw = tw.shape
    q = words.shape[1]
    nb = np.flatnonzero(live)[:, None, None]
    r0, w_end, col_w0, q0 = (x[live][:, None, None] for x in (r0, w_end, col_w0, q0))
    idx = TID[:, None] + THREADS * np.arange(STAGE_ROWS * sm.colw // THREADS)
    r, cw = idx // sm.colw, idx % sm.colw
    row, col = r0 + r, col_w0 + cw
    ok = (row < h) & (col < bw)
    val = np.where(ok, tw[np.minimum(row, h - 1), np.minimum(col, bw - 1)], 0).astype(U32)
    sm.w32[nb, sm.raw0 + slot * sm.raw_words + cw * RAW_STRIDE + r] = val
    idx = TID[:, None] + THREADS * np.arange(sm.words_stage // THREADS)
    wr, qq = idx // sm.qb, idx % sm.qb
    w, qi = r0 // 32 + wr, q0 + qq
    ok = (w < w_end) & (qi < q)
    val = np.where(ok, words[np.minimum(w, words.shape[0] - 1), np.minimum(qi, q - 1)],
                   0).astype(U32)
    sm.w32[nb, sm.wsh0 + slot * sm.words_stage + wr * sm.qb + qq] = val


def expand_stage(sm, slot, par, live):
    """expand_stage of the live blocks: the stage's planes into buffer par
    (warp w expanding column word w + 8 set into set `set`), and every
    lane's A registers (block, warp, ks, lane, reg)."""
    nb = np.flatnonzero(live)[:, None]
    for st in range(sm.sets):
        cw = WARP + COLS // 4 * st  # the warp's column word
        v = sm.w32[nb[:, :, None], sm.raw0 + slot * sm.raw_words
                   + (cw * RAW_STRIDE + 4 * LANE)[:, None] + np.arange(4)]  # the 16-byte read
        x = transpose4x4(v[..., 0], v[..., 1], v[..., 2], v[..., 3])
        for p in range(8):
            mask = U32(0x01010101) << U32(p)
            for b in range(4):
                off = par * sm.plane_bytes + st * PLANE_BYTES \
                    + plane_offset(COLS * p + 4 * WARP + b, 4 * LANE)
                sm.w32[nb, off // 4] = x[b] & mask
    # the lane's query rows qr, qr + 8
    qr = 16 * (WARP % 4) + (64 * (WARP // 4) if sm.sets == 1 else 0) + TID % 32 // 4
    ks = np.arange(STAGE_WORD_ROWS)[:, None]
    base = sm.wsh0 + slot * sm.words_stage + ks * sm.qb
    shift = (4 * (TID % 4)).astype(U32)
    lo = sm.w32[nb[:, :, None], base + qr] >> shift  # (block, ks, thread)
    hi = sm.w32[nb[:, :, None], base + qr + 8] >> shift
    a = np.stack([spread_nibble(lo), spread_nibble(hi), spread_nibble(lo >> U32(16)),
                  spread_nibble(hi >> U32(16))], -1)
    return a.reshape(len(nb), STAGE_WORD_ROWS, 8, 32, 4).transpose(0, 2, 1, 3, 4)


def _flat_of(rows, cols, n_cols):
    inv = np.empty(rows.size, np.int64)
    inv[(rows * n_cols + cols).ravel()] = np.arange(rows.size)
    return inv


A_GATHER = _flat_of(A_ROW, A_COL, 32)  # (16 x 32) from (lane, reg, byte)
# the bytes of B a wgmma reads for k32 step ks of a set of planes at
# offset 0: (ks, 32, N)
B_OFFS = np.stack([desc_b_offsets(desc_sw128(32 * ks)) for ks in range(STAGE_WORD_ROWS)])


def wgmma_stage(sm, par, a, d, live):
    """The stage's 4 wgmma of each warpgroup: A (64 x 32) from its 4 warps'
    registers, B (32 x N) read through desc_sw128(planes + par + set + 32
    ks), set = the warpgroup's planes (kSets = 2) or the one set; d (block,
    group, 64, N) += A B, exact in float32 (|sum| <= 128 rows x 128)."""
    lv = np.flatnonzero(live)
    n_live = len(lv)
    am = s8_bytes(a).reshape(n_live, 8, STAGE_WORD_ROWS, -1)[..., A_GATHER]
    am = am.reshape(n_live, 2, 4, STAGE_WORD_ROWS, 16, 32).transpose(0, 1, 3, 2, 4, 5)
    am = am.reshape(n_live, 2, STAGE_WORD_ROWS, 64, 32)  # (block, group, ks, m, k)
    bsm = sm.b8 if n_live == len(live) else sm.b8[lv]
    sets = [par * sm.plane_bytes + g * PLANE_BYTES * (sm.sets == 2) for g in range(2)]
    bm = np.stack([bsm[:, off + B_OFFS] for off in sets], 1).view(np.int8)  # (b, g, ks, k, n)
    a2 = am.transpose(0, 1, 3, 2, 4).reshape(n_live, 2, 64, STAGE_ROWS).astype(np.float32)
    b2 = bm.reshape(n_live, 2, STAGE_ROWS, 8 * COLS).astype(np.float32)
    prod = (torch.from_numpy(a2) @ torch.from_numpy(b2)).numpy()
    d[lv] += prod.astype(np.int64)


def epilogue(d, out, q0, col_w0, sets):
    """Each lane's accumulators d[4 j + i] from the group's (64 x N) sum,
    bit p of plane p's, 8 planes a byte, two columns a lane, the
    neighbour's two by __shfl_xor_sync(1), one atomicXor a word; warpgroup
    g on queries 64 g .. (one set of planes) or on column words 8 g ..
    (two sets)."""
    assert np.abs(d).max() < 1 << 31  # the int32 accumulators do not wrap
    groups = COLS // 8
    wg, wq = WARP[::32] // 4, WARP[::32] % 4  # (warp,)
    j = groups * np.arange(8)[:, None] + np.arange(groups)  # (plane, column block)
    q_wg = 64 * wg if sets == 1 else 0 * wg
    cw_wg = COLS // 4 * wg if sets == 2 else 0 * wg
    for half in range(2):
        row = 16 * wq[:, None] + G + 8 * half  # (warp, lane)
        words = []
        for e in range(2):  # columns 2 t, 2 t + 1 of each column block
            col = 8 * j[..., None] + 2 * T + e  # (plane, cb, lane)
            acc = d[:, wg[:, None, None, None], row[:, None, None, :], col[None]]
            bit = (np.int64(1) << np.arange(8))[:, None, None]
            words.append((acc & bit).sum(2))  # (block, warp, cb, lane): OR of the planes
        v = (words[0] | words[1] << 8).astype(U32)
        word = v | v[..., LANE32 ^ 1] << U32(16)
        qi = q0[:, None, None, None] + q_wg[:, None, None] + 16 * wq[:, None, None] + G \
            + 8 * half
        cw = col_w0[:, None, None, None] + cw_wg[:, None, None] \
            + (8 * np.arange(groups)[:, None] + 2 * T) // 4
        qi, cw = np.broadcast_to(qi, word.shape), np.broadcast_to(cw, word.shape)
        keep = (T % 2 == 0) & (qi < out.shape[0]) & (cw < out.shape[1]) & (word != 0)
        np.bitwise_xor.at(out, (qi[keep], cw[keep]), word[keep])


GROUP = 64  # blocks the model runs side by side


def scan_blocks(tw, words, out, col_w0, q0, r_begin, r_end, garbage, sets=1):
    """scan_chunk<sets> of each block (one entry a block in col_w0, q0,
    r_begin, r_end), in the kernel's order: stages 0..2 issued, stage 0
    expanded, stage 3 issued; then for each stage s its products, the
    expansion of stage s + 1 and the copies of stage s + 4."""
    for g0 in range(0, len(q0), GROUP):
        sl = slice(g0, g0 + GROUP)
        cw0, qq0, rb, re_ = col_w0[sl], q0[sl], r_begin[sl], r_end[sl]
        nb = len(qq0)
        sm = Smem(nb, garbage, sets)
        n_stages = (re_ - rb + STAGE_ROWS - 1) // STAGE_ROWS
        assert (n_stages > 0).all()  # no block of any kernel has an empty chunk
        w_end = (re_ + 31) // 32

        def issue(s):
            issue_stage(sm, tw, words, rb + s * STAGE_ROWS, w_end, cw0, qq0, s < n_stages,
                        s % STAGES)

        d = np.zeros((nb, 2, 64, 8 * COLS), np.int64)
        for s in range(STAGES - 1):
            issue(s)
        a = expand_stage(sm, 0, 0, np.ones(nb, bool))
        issue(STAGES - 1)
        for s in range(int(n_stages.max())):
            live = s < n_stages
            wgmma_stage(sm, s % 2, a, d, live)  # a: stage s's, of the live blocks
            more = s + 1 < n_stages
            if more.any():
                a = expand_stage(sm, (s + 1) % STAGES, (s + 1) % 2, more)
                issue(s + STAGES)
        epilogue(d, out, qq0, cw0, sets)


def chunk_rows_for(tiles, h, target_blocks):
    """packed_planes.cuh's chunk_rows_for: rows a chunk of whole stages."""
    stages = -(-h // STAGE_ROWS)
    want = min(max(target_blocks // tiles, 1), stages)
    per_chunk = -(-stages // want)
    if -(-stages // per_chunk) > MAX_GRID_YZ:
        per_chunk = -(-stages // MAX_GRID_YZ)
    return min(per_chunk, MAX_CHUNK_ROWS // STAGE_ROWS) * STAGE_ROWS


def launch_grid(h, bw, q):
    """packed_scan.cu's pir_packed_scan: (query tiles, column tiles, row
    chunks, rows a chunk)."""
    q_tiles = -(-q // QB)
    col_tiles = -(-bw // (COLS // 4))
    assert col_tiles <= MAX_GRID_YZ
    chunk_rows = chunk_rows_for(q_tiles * col_tiles, h, TARGET_BLOCKS)
    return q_tiles, col_tiles, -(-h // chunk_rows), chunk_rows


def planes_launch_grid(h, bw, q):
    """planes_scan.cu's launch_scan: (sets, query tiles, column tiles, row
    chunks, rows a chunk); the small-batch tile for q <= 64."""
    sets = 2 if q <= SMALL_BATCH else 1
    q_tiles = -(-q // (QB // sets))
    col_tiles = -(-bw // (sets * COLS // 4))
    assert col_tiles <= MAX_GRID_YZ
    chunk_rows = chunk_rows_for(q_tiles * col_tiles, h, PLANES_TARGET_BLOCKS)
    return sets, q_tiles, col_tiles, -(-h // chunk_rows), chunk_rows


def test_launch_grid_fills_the_card_and_caps_the_chunk():
    """The 1 GiB table: Q = 1024, 256 tiles split 16 ways over the rows;
    Q = 4096, 1024 tiles split 4 ways; a chunk never exceeds 2^24 rows.
    Kernel 6 on it: Q = 64, 16 small-batch tiles of 64 byte columns split
    66 ways; Q = 1024, 256 tiles split 4 ways."""
    assert launch_grid(1 << 20, 256, 1024) == (8, 32, 16, 1 << 16)
    assert launch_grid(1 << 20, 256, 4096) == (32, 32, 4, 1 << 18)
    assert launch_grid(1 << 26, 256, 65536) == (512, 32, 4, MAX_CHUNK_ROWS)
    assert planes_launch_grid(1 << 20, 256, 64) == (2, 1, 16, 66, 125 * 128)
    assert planes_launch_grid(1 << 20, 256, 1024) == (1, 8, 32, 4, 1 << 18)
    assert planes_launch_grid(1 << 20, 256, 65)[:3] == (1, 1, 32)


def operands(h, b, q, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (h, b), dtype=np.uint8)
    words = rng.integers(0, 1 << 32, (h // 32, q), dtype=np.uint64).astype(U32)
    return table, words


def model_packed_scan(table_u8, words, seed=0):
    """pir_packed_scan on (H, B) uint8 and (H / 32, Q) words -> (Q, B)."""
    h, b = table_u8.shape
    q, bw = words.shape[1], b // 4
    tw = table_u8.view("<u4").reshape(h, bw)
    q_tiles, col_tiles, chunks, chunk_rows = launch_grid(h, bw, q)
    bz, by, bx = (a.ravel() for a in np.meshgrid(np.arange(chunks), np.arange(col_tiles),
                                                 np.arange(q_tiles), indexing="ij"))
    out = np.zeros((q, bw), U32)
    r_begin = bz * chunk_rows
    scan_blocks(tw, words, out, by * COLS // 4, bx * QB, r_begin,
                np.minimum(h, r_begin + chunk_rows), np.random.default_rng(seed))
    return out.view(np.uint8).reshape(q, b)


def model_fused_scan_items(table_u8, words, n_tail, seed=0):
    """fused_scan_expand.cu's scan items among n_tail tail items: block i
    is a scan item when the even spread of the scan items steps at i;
    items chunk-major, query tiles fastest. -> answers (Q, B)."""
    h, b = table_u8.shape
    q, bw = words.shape[1], b // 4
    tw = table_u8.view("<u4").reshape(h, bw)
    col_tiles = -(-bw // (COLS // 4))
    q_tiles = -(-q // QB)
    chunks = -(-(h // 32) // CHUNK_WORD_ROWS)
    n_scan = col_tiles * q_tiles * chunks if q else 0
    i = np.arange(n_scan + n_tail)
    before = i * n_scan // max(len(i), 1)
    is_scan = (i + 1) * n_scan // max(len(i), 1) > before
    assert (before[is_scan] == np.arange(n_scan)).all()  # each scan item once, in order
    assert ((i - before)[~is_scan] == np.arange(n_tail)).all()  # and each tail item
    tiles = max(col_tiles * q_tiles, 1)
    chunk, tile = before[is_scan] // tiles, before[is_scan] % tiles
    out = np.zeros((q, bw), U32)
    r_begin = chunk * CHUNK_WORD_ROWS * 32
    scan_blocks(tw, words, out, (tile // q_tiles) * COLS // 4, (tile % q_tiles) * QB,
                r_begin, np.minimum(h, r_begin + CHUNK_WORD_ROWS * 32), np.random.default_rng(seed))
    return out.view(np.uint8).reshape(q, b)


def pack_words(bits, vec):
    """planes_scan.cu's pack_kernel, every thread at once: word w q + qi
    (queries fastest) from bytes 32 w .. 32 w + 31 of query qi, bit 0 of
    each, by the pack4 multiply (two 16-byte loads when vec and the word's
    rows are all below h, else byte loads, none past h)."""
    q, h = bits.shape
    n_w = -(-h // 32)
    i = np.arange(n_w * q)
    w, qi = i // q, i % q
    row = 32 * w[:, None] + np.arange(32)  # (thread, byte)
    inside = row < h
    byte = np.where(inside, bits[qi[:, None], np.minimum(row, h - 1)], 0).astype(U32)
    x = byte.reshape(-1, 8, 4) @ (U32(1) << (U32(8) * np.arange(4, dtype=U32)))  # LE words
    nib = (((x & U32(0x01010101)) * U32(0x01020408)) >> U32(24)) & U32(0xF)
    by_words = (nib << (U32(4) * np.arange(8, dtype=U32))).sum(1, dtype=U32)
    by_bytes = ((byte & U32(1)) << np.arange(32, dtype=U32)).sum(1, dtype=U32)
    full = 32 * w + 32 <= h
    assert (by_words == by_bytes).all()  # both load paths give the same word
    return np.where(vec & full, by_words, by_bytes).reshape(n_w, q)


def model_planes_scan(table_u8, bits, seed=0):
    """pir_planes_scan on (H, B) uint8 and (Q, H) bytes -> (Q, B): the
    pack pre-pass, then the tile of planes_launch_grid."""
    h, b = table_u8.shape
    q, bw = bits.shape[0], b // 4
    words = pack_words(bits, h % 16 == 0)
    tw = table_u8.view("<u4").reshape(h, bw)
    sets, q_tiles, col_tiles, chunks, chunk_rows = planes_launch_grid(h, bw, q)
    bz, by, bx = (a.ravel() for a in np.meshgrid(np.arange(chunks), np.arange(col_tiles),
                                                 np.arange(q_tiles), indexing="ij"))
    out = np.zeros((q, bw), U32)
    r_begin = bz * chunk_rows
    scan_blocks(tw, words, out, by * sets * COLS // 4, bx * (QB // sets), r_begin,
                np.minimum(h, r_begin + chunk_rows), np.random.default_rng(seed), sets)
    return out.view(np.uint8).reshape(q, b)


def plain(table, words):
    return packed_scan_plain(torch.from_numpy(table),
                             torch.from_numpy(words.view(np.int32))).numpy()


# the card tests' shapes (tests/test_torch_cuda.py): Q = 1, 37, 1000 and
# > 4096; rows not a multiple of a stage or a chunk, and 2^16 + 32 rows in
# 513 chunks; B = 8, 64, 520, 1024
PACKED_SHAPES = [(8192, 1024, 64), (4096, 8, 37), (2048, 520, 3), (4096, 1024, 1),
                 (2080, 64, 1000), (1024, 8, 4200), ((1 << 16) + 32, 8, 37)]
# (h, b, q, tail items): the card tests' fused shapes but (2^16, 520, 70),
# whose 2^16 rows and B = 520 the others cover at a tenth of the model's time
FUSED_SHAPES = [(1 << 15, 64, 37, 5), (4096, 8, 3, 9), (4096, 16, 0, 3), (1 << 15, 16, 40, 0),
                (20512, 1024, 1, 3), (4128, 8, 1000, 2), ((1 << 17) + 32, 8, 3, 2),
                (1024, 8, 4200, 2), (4128, 520, 37, 3)]
# kernel 6's card shapes: the small-batch tile at q = 1, 13, 17, 33, 63
# and 64, the 128-query tile at q = 65, 130 and 1024; rows not a multiple
# of 32 (1000: byte loads; 1040: 16-byte loads but a half last word) or of
# a stage; B % 16 != 0 (12, 68, 36, 4, 520)
PLANES_SHAPES = [(4096, 1024, 64), (1000, 12, 1), (4099, 4, 13), (8192, 68, 33),
                 (2048, 80, 17), (65536, 256, 130), (2080, 36, 63), (1040, 520, 65),
                 (2048, 64, 1024), (1008, 8, 64)]


@pytest.mark.parametrize("h,b,q", PACKED_SHAPES)
def test_lane_model_matches_plain_at_the_card_shapes(h, b, q):
    table, words = operands(h, b, q, h + b + q)
    assert (model_packed_scan(table, words) == plain(table, words)).all()


@pytest.mark.parametrize("h,b,q,n_tail", FUSED_SHAPES)
def test_lane_model_fused_scan_items_match_plain(h, b, q, n_tail):
    table, words = operands(h, b, q, h + q + n_tail)
    assert (model_fused_scan_items(table, words, n_tail) == plain(table, words)).all()


@pytest.mark.parametrize("h,b,q", PLANES_SHAPES)
def test_lane_model_planes_scan_matches_plain(h, b, q):
    rng = np.random.default_rng(h + b + q)
    table = rng.integers(0, 256, (h, b), dtype=np.uint8)
    bits = rng.integers(0, 2, (q, h), dtype=np.uint8)
    want = mxu_batched_scan(torch.from_numpy(table), torch.from_numpy(bits)).numpy()
    assert (model_planes_scan(table, bits) == want).all()


@pytest.mark.parametrize("h,vec", [(1000, False), (1040, True), (4096, True)])
def test_pack_prepass_takes_bit_0_of_each_byte(h, vec):
    """Bytes of any value: bit j of word w is bit 0 of row 32 w + j's
    byte, as the plain version's product parity sees it; zero past h."""
    rng = np.random.default_rng(h)
    bits = rng.integers(0, 256, (5, h), dtype=np.uint8)
    words = pack_words(bits, vec)
    padded = np.zeros((5, 32 * words.shape[0]), np.uint8)
    padded[:, :h] = bits & 1
    want = (padded.reshape(5, -1, 32).astype(U32) << np.arange(32, dtype=U32)).sum(-1, dtype=U32)
    assert (words == want.T).all()


def test_a_change_to_the_tile_rebuilds_both_kernels(tmp_path, monkeypatch):
    """_build names each library by a hash of its source and every header,
    so an edit of packed_planes.cuh renames (rebuilds) kernels 2, 5 and 6."""
    from pir_tpu_torch import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("packed_scan", "fused_scan_expand", "planes_scan")
    before = {name: _build._lib_path(name) for name in names}
    header = csrc / "packed_planes.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._lib_path(name) for name in before}
    assert all(before[n] != after[n] for n in before)
