"""Batched XOR scan as bit-plane products, in plain torch (counterpart of
``pir_tpu/ops/matmul_scan.py``).

The XOR of the selected rows is, bit by bit, the parity of a sum: split
the table into its 8 bit planes, multiply the (Q, H) selection bits by
each plane and take every sum mod 2 (``mxu_batched_scan``). This is the
TPU kernel's own arithmetic (``pir_tpu/ops/pallas_scan.py:
mxu_batched_scan_pallas``), so it is the plain version the bit-plane
scan kernel (``ops/planes_scan.py``) is held against, and a check on
the masked-XOR references (``ops/scan.py``) that does not share their
arithmetic. Zero rows never change the XOR: tables pad with
``ops.scan.pad_rows_u8``.
"""

from __future__ import annotations

import torch

# rows of one float32 product: its sums count at most this many ones, so
# they stay exact integers while it is at most 2^24
BLOCK_ROWS = 1 << 13


def make_plane_table(table_u8: torch.Tensor) -> torch.Tensor:
    """(H, B) uint8 -> (H, 8B) uint8 bit planes in {0, 1}; column
    byte * 8 + bit, the layout of ``pir_tpu``'s make_plane_table."""
    h, b = table_u8.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=table_u8.device)
    return ((table_u8[:, :, None] >> shifts) & 1).reshape(h, b * 8)


def _check_exact_fp32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plane products need exact float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 must be off")


def _recombine(parity: torch.Tensor) -> torch.Tensor:
    """(Q, 8B) plane parities, column byte * 8 + bit -> (Q, B) uint8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=parity.device)
    q, b8 = parity.shape
    return (parity.reshape(q, b8 // 8, 8) << shifts).sum(-1, dtype=torch.uint8)


def _block_parity(bits: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """One float32 product of a block's bits (Q, rows) and its planes
    (rows, 8B) -> (Q, 8B) uint8 parities."""
    acc = bits.to(torch.float32) @ planes.to(torch.float32)
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def mxu_batched_scan(table_u8: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """table (H, B) uint8, bits (Q, H) {0, 1} -> (Q, B) uint8 XOR scan.

    Per block of BLOCK_ROWS rows one float32 product of the bits with the
    block's plane table (Q, BLOCK_ROWS) x (BLOCK_ROWS, 8B): each sum is
    exact, and its parity is the block's plane bit. The blocks' parities
    XOR together, and the 8 plane bits of each byte recombine into the
    answer. Any H."""
    _check_exact_fp32(table_u8.device)
    h, b = table_u8.shape
    parity = torch.zeros((bits.shape[0], 8 * b), dtype=torch.uint8, device=table_u8.device)
    for r0 in range(0, h, BLOCK_ROWS):
        parity ^= _block_parity(bits[:, r0:r0 + BLOCK_ROWS],
                                make_plane_table(table_u8[r0:r0 + BLOCK_ROWS]))
    return _recombine(parity)


def mxu_preplane_scan(planes: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The same scan against a plane table built once (pir_tpu's
    mxu_preplane_scan): planes (H, 8B) in {0, 1} (make_plane_table, uint8,
    or pir_tpu's int8), bits (Q, H) {0, 1} -> (Q, B) uint8. The server
    keeps no plane table: the bit-plane scan kernel (ops/planes_scan.py)
    packs its own from the bytes."""
    _check_exact_fp32(planes.device)
    h, b8 = planes.shape
    parity = torch.zeros((bits.shape[0], b8), dtype=torch.uint8, device=planes.device)
    for r0 in range(0, h, BLOCK_ROWS):
        parity ^= _block_parity(bits[:, r0:r0 + BLOCK_ROWS], planes[r0:r0 + BLOCK_ROWS])
    return _recombine(parity)
