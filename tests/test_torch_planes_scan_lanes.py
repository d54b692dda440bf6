"""A numpy model of csrc/planes_scan.cu (kernel 6), lane by lane, held
against the plain version (ops/matmul_scan.mxu_batched_scan).

The kernel has no host build, so its index math runs only on the card:
the launch grid and its row chunks, the tile staging (16-byte or narrower
loads, the 4 x 4 byte transpose by __byte_perm, shared-memory rows of 68
words), the mma.m16n8k32 s8 fragment layouts of the PTX ISA and the
epilogue's lane shuffle and atomicXor. This model replays each of them
with numpy, vectorised over the 256 threads of a block, at the shapes of
the card tests (tests/test_torch_cuda.py). Shared memory starts as
garbage, so a fragment read of a word no thread stored shows as a wrong
byte. Change the model with the kernel's tiling and run it here first.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pir_tpu_torch.ops.matmul_scan import mxu_batched_scan
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = Path(__file__).resolve().parents[1] / "pir_tpu_torch" / "csrc" / "planes_scan.cu"

WARPS, THREADS, COLS_PER_WARP = 8, 256, 8
COLS_PER_BLOCK = WARPS * COLS_PER_WARP  # bytes
TILE_ROWS = 256
TILE_WORDS = TILE_ROWS // 4
STRIDE = TILE_WORDS + 4
TARGET_BLOCKS = 8 * 132
MAX_GRID_YZ = 65535

TID = np.arange(THREADS)
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # fragment group, thread in group


def test_model_constants_are_the_kernels():
    src = SOURCE.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kWarps")) == WARPS and int(const("kColsPerWarp")) == COLS_PER_WARP
    assert int(const("kTileRows")) == TILE_ROWS and int(const("kMaxGridYZ")) == MAX_GRID_YZ
    assert const("kThreads") == "32 * kWarps" and const("kStride").startswith("kTileWords + 4")
    assert const("kTargetBlocks").startswith("8 * 132")
    assert "__byte_perm(w0, w1, 0x5140)" in src and "__byte_perm(lo01, lo23, 0x7632)" in src


def byte_perm(x, y, s):
    """__byte_perm(x, y, s): byte i of the result is byte (s >> 4 i) & 7
    of the 8 bytes y:x (x the low word)."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint32)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)).astype(np.uint32) << np.uint32(8 * i)
    return out


def transpose4x4(w0, w1, w2, w3):
    """The kernel's transpose4x4, selector for selector."""
    lo01, lo23 = byte_perm(w0, w1, 0x5140), byte_perm(w2, w3, 0x5140)
    hi01, hi23 = byte_perm(w0, w1, 0x7362), byte_perm(w2, w3, 0x7362)
    return (byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632))


def launch_grid(h, bw, q, mf):
    """launch<MF>: (column tiles, query tiles, row chunks, rows a chunk)."""
    col_tiles = -(-4 * bw // COLS_PER_BLOCK)
    q_tiles = -(-q // (mf * 16))
    tiles = -(-h // TILE_ROWS)
    want = min(max(TARGET_BLOCKS // (col_tiles * q_tiles), 1), tiles)
    per_chunk = -(-tiles // want)
    if -(-tiles // per_chunk) > MAX_GRID_YZ:
        per_chunk = -(-tiles // MAX_GRID_YZ)
    return col_tiles, q_tiles, -(-tiles // per_chunk), per_chunk * TILE_ROWS


def load_tile(tw, bits, r0, col_w0, q0, mf, vec_t, vec_b):
    """load_tile: each thread's 4 rows x 4 table words and MF 16-byte
    pieces of the bits (as 4 words), zero where the kernel masks."""
    h, bw = tw.shape
    q = bits.shape[0]
    kw, c16 = TID % TILE_WORDS, TID // TILE_WORDS
    cw = col_w0 + 4 * c16
    r = r0 + 4 * kw[:, None] + np.arange(4)  # (256, 4): row i
    col = cw[:, None] + np.arange(4)  # (256, 4): word j
    if vec_t:  # one 16-byte load a row: the wrapper's B % 16 == 0 keeps it in the row
        ok = (r < h)[:, :, None] & (cw < bw)[:, None, None] & np.ones(4, bool)
        assert (col[:, None, :].repeat(4, 1)[ok] < bw).all()
    else:
        ok = (r < h)[:, :, None] & (col < bw)[:, None, :]
    table = np.where(ok, tw[np.minimum(r, h - 1)[:, :, None], np.minimum(col, bw - 1)[:, None, :]],
                     0).astype(np.uint32)  # (256, row i, word j)
    idx = TID[:, None] + THREADS * np.arange(mf)  # (256, MF)
    qi = q0 + idx // 16
    rb = r0 + 16 * (idx % 16)
    rr = rb[:, :, None] + np.arange(16)  # (256, MF, 16) the piece's rows
    if vec_b:  # one 16-byte load: the wrapper's H % 16 == 0 keeps it in the row
        ok = ((qi < q) & (rb < h))[:, :, None] & np.ones(16, bool)
        assert (rr[ok] < h).all()
    else:
        ok = (qi < q)[:, :, None] & (rr < h)
    piece = np.where(ok, bits[np.minimum(qi, q - 1)[:, :, None], np.minimum(rr, h - 1)],
                     0).astype(np.uint32)
    words = (piece.reshape(THREADS, mf, 4, 4) << (8 * np.arange(4, dtype=np.uint32))).sum(
        -1, dtype=np.uint32)  # word e: bytes of rows 4 e .. 4 e + 3
    return table, idx, words


def store_tile(table, idx, words, sh_table, sh_bits):
    """store_tile: the transposed table words and the bits into shared
    memory."""
    kw, c16 = TID % TILE_WORDS, TID // TILE_WORDS
    for j in range(4):
        o = transpose4x4(table[:, 0, j], table[:, 1, j], table[:, 2, j], table[:, 3, j])
        for b in range(4):
            sh_table[16 * c16 + 4 * j + b, kw] = o[b]
    sh_bits[(idx // 16)[:, :, None], 4 * (idx % 16)[:, :, None] + np.arange(4)] = words


# PTX ISA, mma.m16n8k32 with .s8 operands: a lane's (g, t) registers
REG4, BYTE4 = np.arange(4), np.arange(4)
A_ROW = G[:, None, None] + 8 * (REG4 % 2)[None, :, None] + 0 * BYTE4  # (32, reg, byte)
A_COL = 4 * T[:, None, None] + BYTE4[None, None, :] + 16 * (REG4 // 2)[None, :, None]
B_ROW = 4 * T[:, None, None] + BYTE4[None, None, :] + 16 * np.arange(2)[None, :, None]  # k
B_COL = G[:, None, None] + 0 * B_ROW  # n
D_ROW = G[:, None] + 8 * (REG4 // 2)  # (32, accumulator i)
D_COL = 2 * T[:, None] + REG4 % 2


def test_fragment_layouts_cover_each_element_once():
    a = np.zeros((16, 32), int)
    np.add.at(a, (A_ROW, A_COL), 1)
    b = np.zeros((32, 8), int)
    np.add.at(b, (B_ROW, B_COL), 1)
    d = np.zeros((16, 8), int)
    np.add.at(d, (D_ROW, D_COL), 1)
    assert (a == 1).all() and (b == 1).all() and (d == 1).all()


def tile_products(sh_table, sh_bits, mf):
    """The 8 k32 steps of one tile: every lane's A and B fragments from
    shared memory, the 8 bit planes of B, and the mma products, returned
    as each lane's accumulators (MF, warp, plane, lane, i)."""
    ks = np.arange(TILE_ROWS // 32)[:, None]
    w = 8 * ks + T  # (ks, lane): word of rows 32 ks + 4 t .. + 3
    f = np.arange(mf)[:, None, None]
    a_reg = np.stack([sh_bits[16 * f + G, w], sh_bits[16 * f + G + 8, w],
                      sh_bits[16 * f + G, w + 4], sh_bits[16 * f + G + 8, w + 4]], -1)
    a = np.zeros((mf, 8, 16, 32), np.float32)  # (MF, ks, m, k)
    a[:, :, A_ROW, A_COL] = (a_reg[..., None] >> (8 * BYTE4.astype(np.uint32))) & 0xFF
    col = COLS_PER_WARP * np.arange(WARPS)[:, None, None] + G  # (warp, 1, lane): n0 + g
    x = np.stack([sh_table[col, w], sh_table[col, w + 4]], -1)  # (warp, ks, lane, reg)
    planes = (x[:, :, :, None, :] >> np.arange(8, dtype=np.uint32)[:, None]) & 0x01010101
    b = np.zeros((WARPS, 8, 8, 32, 8), np.float32)  # (warp, ks, plane, k, n)
    b[:, :, :, B_ROW, B_COL] = ((planes[..., None] >> (8 * BYTE4.astype(np.uint32))) & 0xFF
                                ).transpose(0, 1, 3, 2, 4, 5)
    # sum over the 8 k32 steps of (16 x 32) x (32 x 8), exact in float32
    d = (a.transpose(0, 2, 1, 3).reshape(mf * 16, 8 * 32)
         @ b.transpose(1, 3, 0, 2, 4).reshape(8 * 32, WARPS * 8 * 8))
    d = d.reshape(mf, 16, WARPS, 8, 8).transpose(0, 2, 3, 1, 4)  # (MF, warp, plane, m, n)
    return d[:, :, :, D_ROW, D_COL].astype(np.int64)


def epilogue(acc, out, q0, col_w0):
    """Each accumulator's parity, 8 planes a byte, two columns a lane,
    the neighbour's two by __shfl_xor_sync(1), one atomicXor a word."""
    mf = acc.shape[0]
    assert acc.max() < 1 << 31  # the int32 accumulators stay exact
    par = (acc & 1) << np.arange(8)[:, None, None]  # (MF, warp, plane, lane, i)
    for half in range(2):
        lo = par[..., 2 * half].sum(2)  # (MF, warp, lane)
        hi = par[..., 2 * half + 1].sum(2)
        v = (lo | hi << 8).astype(np.uint32)
        word = v | v[..., LANE ^ 1] << np.uint32(16)
        qi = q0 + 16 * np.arange(mf)[:, None, None] + G + 8 * half
        col_w = col_w0 + (COLS_PER_WARP * np.arange(WARPS)[:, None] + 2 * T) // 4
        col_w = np.broadcast_to(col_w, word.shape)
        qi = np.broadcast_to(qi, word.shape)
        keep = (T % 2 == 0) & (qi < out.shape[0]) & (col_w < out.shape[1]) & (word != 0)
        np.bitwise_xor.at(out, (qi[keep], col_w[keep]), word[keep])


def model_scan(table_u8, bits, vec_t, vec_b, seed=0):
    """pir_planes_scan on (H, B) uint8 and (Q, H) bits -> (Q, B) uint8."""
    h, b = table_u8.shape
    q, bw = bits.shape[0], b // 4
    tw = table_u8.view("<u4").reshape(h, bw)
    mf = 1 if q <= 16 else 2 if q <= 32 else 4
    col_tiles, q_tiles, chunks, chunk_rows = launch_grid(h, bw, q, mf)
    out = np.zeros((q, bw), np.uint32)
    garbage = np.random.default_rng(seed)
    for bx in range(col_tiles):
        for by in range(q_tiles):
            for bz in range(chunks):
                col_w0, q0 = bx * COLS_PER_BLOCK // 4, by * mf * 16
                r_begin = bz * chunk_rows
                sh_table = garbage.integers(0, 1 << 32, (COLS_PER_BLOCK, STRIDE), np.uint32)
                sh_bits = garbage.integers(0, 1 << 32, (mf * 16, STRIDE), np.uint32)
                acc = np.zeros((mf, WARPS, 8, 32, 4), np.int64)
                for r0 in range(r_begin, min(h, r_begin + chunk_rows), TILE_ROWS):
                    store_tile(*load_tile(tw, bits, r0, col_w0, q0, mf, vec_t, vec_b),
                               sh_table, sh_bits)
                    acc += tile_products(sh_table, sh_bits, mf)
                epilogue(acc, out, q0, col_w0)
    return out.view(np.uint8).reshape(q, b)


@pytest.mark.parametrize("h,b,q", [
    (4096, 1024, 64),   # the card tests' shapes (tests/test_torch_cuda.py)
    (1000, 12, 1),
    (4099, 4, 13),
    (8192, 68, 33),
    (2048, 80, 17),
    (65536, 256, 130),
])
def test_lane_model_matches_plain_at_the_card_shapes(h, b, q):
    """As the wrapper launches it: 16-byte loads where B % 16 == 0 (the
    table) and H % 16 == 0 (the bits)."""
    rng = np.random.default_rng(h + b + q)
    table = rng.integers(0, 256, (h, b), dtype=np.uint8)
    bits = rng.integers(0, 2, (q, h), dtype=np.uint8)
    got = model_scan(table, bits, vec_t=b % 16 == 0, vec_b=h % 16 == 0)
    want = mxu_batched_scan(torch.from_numpy(table), torch.from_numpy(bits)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("h,b,q", [(4096, 64, 5), (528, 16, 40)])
def test_lane_model_narrow_loads_match_plain(h, b, q):
    """The 4-byte table loads and byte loads of the bits on shapes that
    would allow 16-byte ones (a misaligned pointer takes them)."""
    rng = np.random.default_rng(h * q)
    table = rng.integers(0, 256, (h, b), dtype=np.uint8)
    bits = rng.integers(0, 2, (q, h), dtype=np.uint8)
    want = mxu_batched_scan(torch.from_numpy(table), torch.from_numpy(bits)).numpy()
    assert (model_scan(table, bits, vec_t=False, vec_b=False) == want).all()
