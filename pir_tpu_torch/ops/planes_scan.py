"""Bit-plane batched XOR scan: the CUDA kernel's wrapper
(counterpart of ``pir_tpu/ops/pallas_scan.py:mxu_batched_scan_pallas``).

``planes_scan(table_u8, bits)``: table (H, B) uint8 and selection bits
(Q, H) uint8 in {0, 1} -> (Q, B) uint8, row q the XOR of the table rows
query q selects. Keyword batches scan with it (``server.py``,
``TorchPirServer._keyword_query_batch``). On a CUDA tensor the wrapper
launches ``csrc/planes_scan.cu``: a pre-pass packs bit 0 of each byte into
(ceil(H / 32), Q) selection words, then ``wgmma`` int8 products of the
selection bits with the table's bit planes, each taken mod 2, run on the
packed scan's tile (64-query blocks for Q <= 64). On a CPU tensor it runs
``ops.matmul_scan.mxu_batched_scan``, the same arithmetic in float32.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .matmul_scan import mxu_batched_scan

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MAX_ROW_BYTES = 65535 * 32  # row bytes: 32 per block of the launch grid's y, at most
_MAX_INT = (1 << 31) - 1


def check_operands(table_u8: torch.Tensor, bits: torch.Tensor) -> None:
    """Raise unless table and bits have the dtypes, shapes and device of
    one scan."""
    if table_u8.dtype != torch.uint8 or table_u8.dim() != 2:
        raise ValueError("table must be a 2-D uint8 tensor")
    if bits.dtype != torch.uint8 or bits.dim() != 2:
        raise ValueError("selection bits must be a 2-D uint8 tensor")
    if bits.shape[1] != table_u8.shape[0]:
        raise ValueError(f"bits {tuple(bits.shape)} do not cover {table_u8.shape[0]} rows")
    if table_u8.device != bits.device:
        raise ValueError("table and bits are on different devices")


def planes_scan(table_u8: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(H, B) uint8 table, (Q, H) uint8 bits -> (Q, B) uint8."""
    check_operands(table_u8, bits)
    if table_u8.device.type == "cpu":
        return mxu_batched_scan(table_u8, bits)
    if table_u8.device.type != "cuda":
        raise ValueError(f"no bit-plane scan for device {table_u8.device}")
    h, b = table_u8.shape
    q = bits.shape[0]
    if b % 4 or not table_u8.is_contiguous() or table_u8.data_ptr() % 4:
        raise ValueError("the kernel reads rows as aligned 4-byte words: "
                         "contiguous table with B % 4 == 0")
    if not bits.is_contiguous():
        raise ValueError("selection bits must be contiguous")
    if q > _MAX_INT or h > _MAX_INT or b > _MAX_ROW_BYTES:
        raise ValueError(f"{q} queries x {h} rows of {b} bytes exceed one launch")
    out = torch.zeros((q, b), dtype=torch.uint8, device=table_u8.device)
    if not (q and h and b):
        return out
    words = torch.empty(((h + 31) // 32, q), dtype=torch.int32, device=table_u8.device)
    vec_bits = h % 16 == 0 and bits.data_ptr() % 16 == 0
    fn = _build.load("planes_scan").pir_planes_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(table_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table_u8.data_ptr(), bits.data_ptr(), words.data_ptr(), out.data_ptr(), h,
                 b // 4, q, int(vec_bits), stream)
    _build.check(err, "planes_scan")
    _build.count_launch(planes_scan)
    return out


planes_scan.launches = 0
