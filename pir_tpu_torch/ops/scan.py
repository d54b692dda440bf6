"""Plain torch references for the XOR scan (counterpart of
``pir_tpu/ops/matmul_scan.py`` and ``pir_tpu/ops/scan.py``).

The 2-server PIR answer share is ``XOR over rows r with bit[r] = 1 of
row r``. These functions compute it the straightforward way — mask the
rows, fold them with XOR — and are the plain versions that the packed
scan kernel (``ops/packed_scan.py``) and the masked-XOR scan kernel
(``ops/xor_scan.py``) are held against.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_rows_u8(table_u8: np.ndarray, block: int) -> np.ndarray:
    """Zero rows appended up to a multiple of `block` (XOR-neutral)."""
    h = table_u8.shape[0]
    pad = (-h) % block
    if not pad:
        return table_u8
    return np.concatenate(
        [table_u8, np.zeros((pad, table_u8.shape[1]), dtype=np.uint8)]
    )


def pad_cols_u8(table_u8: np.ndarray, multiple: int = 4) -> np.ndarray:
    """Zero bytes appended to each row up to a multiple of `multiple`
    bytes, so a kernel reads every row as whole 4-byte words. Answers
    are sliced back to the row's own bytes."""
    pad = (-table_u8.shape[1]) % multiple
    if not pad:
        return table_u8
    return np.pad(table_u8, ((0, 0), (0, pad)))


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of x along `dim` (dimension kept, size 1), by halving folds."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        y = x.narrow(dim, 0, h) ^ x.narrow(dim, h, h)
        if n % 2:
            y.narrow(dim, 0, 1).bitwise_xor_(x.narrow(dim, n - 1, 1))
        x = y
    return x


def _word_table(table_u8: torch.Tensor) -> torch.Tensor:
    """(H, B) uint8 -> (H, ceil(B/4)) int32 little-endian words."""
    h, b = table_u8.shape
    pad = (-b) % 4
    if pad:
        table_u8 = torch.cat(
            [table_u8, table_u8.new_zeros((h, pad))], dim=1)
    return table_u8.contiguous().view(torch.int32)


def masked_xor_scan(table: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """table (H, C) int32 words, bits (H,) {0,1} -> (C,) int32: the XOR of
    the rows whose bit is set (each row masked by 0 - bit)."""
    return masked_xor_scan_batched(table, bits[None])[0]


def masked_xor_scan_batched(table: torch.Tensor, bits: torch.Tensor,
                            max_elems: int = 1 << 27) -> torch.Tensor:
    """table (H, C) int32 words, bits (Q, H) {0,1} -> (Q, C) int32.

    Works in (query, row) chunks of at most `max_elems` masked words so
    large tables stay within memory.
    """
    h, c = table.shape
    q = bits.shape[0]
    out = torch.zeros((q, c), dtype=torch.int32, device=table.device)
    qc = max(1, min(q, 256))
    rc = max(1, min(h, max_elems // (qc * max(1, c))))
    for q0 in range(0, q, qc):
        acc = out[q0:q0 + qc]
        for r0 in range(0, h, rc):
            mask = -bits[q0:q0 + qc, r0:r0 + rc].to(torch.int32)
            acc ^= xor_reduce(table[None, r0:r0 + rc] & mask[:, :, None], 1)[:, 0]
    return out


def batched_xor_scan(table_u8: torch.Tensor, bits: torch.Tensor,
                     max_elems: int = 1 << 27) -> torch.Tensor:
    """table (H, B) uint8, bits (Q, H) {0,1} -> (Q, B) uint8: row q is the
    XOR of the table rows r with bits[q, r] = 1."""
    words = masked_xor_scan_batched(_word_table(table_u8), bits, max_elems)
    return words.view(torch.uint8)[:, :table_u8.shape[1]]


def pack_table_u32(data: np.ndarray, height: int, group_size: int) -> np.ndarray:
    """(db_size, slot_bytes) uint8 -> (height, group_size * words) uint32.

    Rows cover slots [r*G, (r+1)*G); each slot is zero-padded to a whole
    number of little-endian uint32 words so slot boundaries stay aligned.
    """
    _, slot_bytes = data.shape
    words = max(1, -(-slot_bytes // 4))
    arr = np.zeros((height, group_size, words * 4), dtype=np.uint8)
    used = height * group_size
    arr[:, :, :slot_bytes] = data[:used].reshape(height, group_size, slot_bytes)
    return arr.view("<u4").reshape(height, group_size * words)


def pack_rows_u32(data: np.ndarray, rows: np.ndarray, group_size: int,
                  slot_bytes: int) -> np.ndarray:
    """pack_table_u32's layout of just the given grid rows: the values
    ``TorchPirServer.apply_updates`` scatters over a cached word table."""
    h = data.shape[0] // group_size
    picked = data[: h * group_size].reshape(h, group_size, slot_bytes)[rows]
    return pack_table_u32(picked.reshape(-1, slot_bytes), len(rows), group_size)


def unpack_result_u32(res: np.ndarray, group_size: int, slot_bytes: int) -> np.ndarray:
    """(G*words,) uint32 -> (G, slot_bytes) uint8."""
    words = max(1, -(-slot_bytes // 4))
    b = np.ascontiguousarray(
        np.asarray(res, dtype="<u4").reshape(group_size, words)
    ).view(np.uint8)
    return b.reshape(group_size, words * 4)[:, :slot_bytes]
