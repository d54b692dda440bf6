"""Masked-XOR scan of a word table: CUDA kernel wrapper and its plain
version (counterpart of ``pir_tpu/ops/pallas_scan.py:masked_xor_scan_pallas``,
the hand-scheduled form of ``pir_tpu/ops/scan.py:masked_xor_scan[_batched]``).

``masked_xor_scan(table_words, bits)``: table (H, C) int32 words and
selection bits (H,) or (Q, H) uint8 in {0, 1} -> (C,) or (Q, C) int32,
each the XOR of the rows its query selects. It serves single queries and
small batches: the table is read once for up to ``MAX_Q`` queries. On a
CUDA tensor the wrapper launches ``csrc/masked_xor_scan.cu``, once per
``MAX_Q`` queries; on a CPU tensor it runs ``masked_xor_scan_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import scan

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
MAX_Q = 8  # queries a launch (the kernel's registers); more run in slices


def masked_xor_scan_plain(table_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Plain torch version: mask the rows and fold them with XOR."""
    if bits.dim() == 1:
        return scan.masked_xor_scan(table_words, bits)
    return scan.masked_xor_scan_batched(table_words, bits)


def check_operands(table_words: torch.Tensor, bits: torch.Tensor) -> None:
    """Raise unless table and bits have the dtypes, shapes and device of
    one scan."""
    if table_words.dtype != torch.int32 or table_words.dim() != 2:
        raise ValueError("table must be a 2-D int32 tensor of words")
    if bits.dtype != torch.uint8 or bits.dim() not in (1, 2):
        raise ValueError("selection bits must be a 1-D or 2-D uint8 tensor")
    if bits.shape[-1] != table_words.shape[0]:
        raise ValueError(f"bits {tuple(bits.shape)} do not cover {table_words.shape[0]} rows")
    if table_words.device != bits.device:
        raise ValueError("table and bits are on different devices")


def masked_xor_scan(table_words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(H, C) int32 table, (H,) or (Q, H) uint8 bits -> (C,) or (Q, C) int32."""
    check_operands(table_words, bits)
    if table_words.device.type == "cpu":
        return masked_xor_scan_plain(table_words, bits)
    if table_words.device.type != "cuda":
        raise ValueError(f"no masked-XOR scan for device {table_words.device}")
    if not table_words.is_contiguous() or not bits.is_contiguous():
        raise ValueError("the kernel reads table and bits as they lie: both must be contiguous")
    h, c = table_words.shape
    bits_q = bits.reshape(-1, h)
    q = bits_q.shape[0]
    out = torch.zeros((q, c), dtype=torch.int32, device=table_words.device)
    if h and c and q:
        vec = 4 if c % 4 == 0 and table_words.data_ptr() % 16 == 0 else 1
        fn = _build.load("masked_xor_scan").pir_masked_xor_scan
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        with torch.cuda.device(table_words.device):
            stream = torch.cuda.current_stream().cuda_stream
            for q0 in range(0, q, MAX_Q):
                err = fn(table_words.data_ptr(), bits_q[q0].data_ptr(), out[q0].data_ptr(),
                         h, c, min(MAX_Q, q - q0), vec, stream)
                _build.check(err, "masked_xor_scan")
                _build.count_launch(masked_xor_scan)
    return out[0] if bits.dim() == 1 else out


masked_xor_scan.launches = 0
