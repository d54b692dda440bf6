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


def mxu_batched_scan(table_u8: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """table (H, B) uint8, bits (Q, H) {0, 1} -> (Q, B) uint8 XOR scan.

    Per block of BLOCK_ROWS rows one float32 product of the bits with the
    block's plane table (Q, BLOCK_ROWS) x (BLOCK_ROWS, 8B): each sum is
    exact, and its parity is the block's plane bit. The blocks' parities
    XOR together, and the 8 plane bits of each byte recombine into the
    answer. Any H."""
    _check_exact_fp32(table_u8.device)
    block = BLOCK_ROWS
    h, b = table_u8.shape
    q = bits.shape[0]
    parity = torch.zeros((q, 8 * b), dtype=torch.uint8, device=table_u8.device)
    for r0 in range(0, h, block):
        planes = make_plane_table(table_u8[r0:r0 + block]).to(torch.float32)
        acc = bits[:, r0:r0 + block].to(torch.float32) @ planes  # (Q, 8B)
        parity ^= (acc.to(torch.int32) & 1).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=table_u8.device)
    return (parity.reshape(q, b, 8) << shifts).sum(-1, dtype=torch.uint8)
