"""Packed-bits batched XOR scan: CUDA kernel wrapper and its plain version
(counterpart of ``pir_tpu/ops/pallas_scan.py:mxu_batched_scan_packed_pallas``).

``packed_scan(table_u8, words_t)``: table (H, B) uint8 and selection words
(H // 32, Q) int32, word w bit j of column q selecting row 32w + j ->
(Q, B) uint8, each row the XOR of the table rows its query selects.
On a CUDA tensor the wrapper launches ``csrc/packed_scan.cu`` (int8
tensor-core products of the selection bits, spread from the packed words,
with the table's bit planes, each taken mod 2; rows split over blocks and
XORed into zeroed answers); on a CPU tensor it runs ``packed_scan_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .scan import batched_xor_scan

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_MAX_GRID_Y = 65535 * 32  # row bytes: 32 per block of the launch grid's y
_MAX_INT = (1 << 31) - 1


def unpack_words_t(words_t: torch.Tensor) -> torch.Tensor:
    """(H // 32, Q) int32 -> (Q, H) uint8 bits {0,1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=words_t.device)
    bits = (words_t.t()[:, :, None] >> shifts) & 1  # (Q, H/32, 32)
    return bits.reshape(words_t.shape[1], -1).to(torch.uint8)


def packed_scan_plain(table_u8: torch.Tensor, words_t: torch.Tensor,
                      q_chunk: int = 256) -> torch.Tensor:
    """Plain torch version: unpack the bits, mask and XOR-fold the rows."""
    outs = [batched_xor_scan(table_u8, unpack_words_t(words_t[:, q0:q0 + q_chunk]))
            for q0 in range(0, words_t.shape[1], q_chunk)]
    return torch.cat(outs, dim=0) if outs else table_u8.new_zeros((0, table_u8.shape[1]))


def check_operands(table_u8: torch.Tensor, words_t: torch.Tensor) -> None:
    """Raise unless table and words have the dtypes, shapes and device of
    one scan."""
    if table_u8.dtype != torch.uint8 or table_u8.dim() != 2:
        raise ValueError("table must be a 2-D uint8 tensor")
    if words_t.dtype != torch.int32 or words_t.dim() != 2:
        raise ValueError("selection words must be a 2-D int32 tensor")
    h, _ = table_u8.shape
    if h % 32 or words_t.shape[0] != h // 32:
        raise ValueError(f"words {tuple(words_t.shape)} do not cover {h} rows")
    if table_u8.device != words_t.device:
        raise ValueError("table and words are on different devices")


def check_kernel_operands(table_u8: torch.Tensor, words_t: torch.Tensor) -> None:
    """Raise unless a CUDA kernel can read the table as aligned 4-byte
    words and the words as they lie (the table builders pad rows to a
    multiple of 4 bytes)."""
    if table_u8.shape[1] % 4 or not table_u8.is_contiguous() or table_u8.data_ptr() % 4:
        raise ValueError("the kernel reads rows as aligned 4-byte words: "
                         "contiguous table with B % 4 == 0")
    if not words_t.is_contiguous():
        raise ValueError("selection words must be contiguous")


def packed_scan(table_u8: torch.Tensor, words_t: torch.Tensor) -> torch.Tensor:
    """(H, B) uint8 table, (H // 32, Q) int32 words -> (Q, B) uint8."""
    check_operands(table_u8, words_t)
    if table_u8.device.type == "cpu":
        return packed_scan_plain(table_u8, words_t)
    if table_u8.device.type != "cuda":
        raise ValueError(f"no packed scan for device {table_u8.device}")
    check_kernel_operands(table_u8, words_t)
    h, b = table_u8.shape
    q = words_t.shape[1]
    if b > _MAX_GRID_Y or q > _MAX_INT:
        raise ValueError(f"rows of {b} bytes or {q} queries exceed one launch")
    out = torch.zeros((q, b), dtype=torch.uint8, device=table_u8.device)
    if not (q and h and b):
        return out
    fn = _build.load("packed_scan").pir_packed_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(table_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table_u8.data_ptr(), words_t.data_ptr(), out.data_ptr(),
                 h, b // 4, q, stream)
    _build.check(err, "packed_scan")
    _build.count_launch(packed_scan)
    return out


packed_scan.launches = 0
