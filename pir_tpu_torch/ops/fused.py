"""Fused scan + per-query tail: CUDA kernel wrapper and its plain version
(counterpart of ``pir_tpu/ops/pallas_fused.py:fused_scan_expand_pallas``).

``fused_scan_expand(table_u8, words_t, seeds, t, cw_s, cw_tl, cw_tr, rk,
fcw, rk_leaf, levels=L)`` returns ``(packed_scan(table_u8, words_t),
fast_tail_expand(seeds, ..., levels=L))``: the answers (Q, B) uint8 of
batch i's selection words (H // 32, Q) and the tail words (QE, 8, 16,
NW0 << L) of batch i+1, whose operands are the per-query tail's for
batch-shared keys (rk (11,8,3,16,1), rk_leaf (11,8,16,1)) and 128-bit
leaves (fcw (QE,8,16,1)). On a CUDA tensor the wrapper launches
``csrc/fused_scan_expand.cu``, both in one kernel; on a CPU tensor it runs
``fused_scan_expand_plain``. Unlike the TPU kernel it needs no geometry
(``fused_geometry``): any Q, QE and table shape the two halves take.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import fast_tail, packed_scan as ps

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fused_scan_expand_plain(table_u8, words_t, seeds, t, cw_s, cw_tl, cw_tr, rk, fcw,
                            rk_leaf, *, levels: int):
    """Plain torch version: the packed scan's and the per-query tail's."""
    return (ps.packed_scan_plain(table_u8, words_t),
            fast_tail.fast_tail_expand_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                                             levels=levels))


def fused_scan_expand(table_u8, words_t, seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                      *, levels: int):
    """-> (answers (Q, B) uint8, tail words (QE, 8, 16, NW0 << levels) int32)."""
    ps.check_operands(table_u8, words_t)
    tail_ops = (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf)
    fast_tail.check_operands(*tail_ops, levels)
    if rk.dim() != 5 or fcw.dim() != 4:
        raise ValueError("the fused kernel takes batch-shared keys and 128-bit leaves")
    if seeds.device != table_u8.device:
        raise ValueError("scan and tail operands are on different devices")
    if table_u8.device.type == "cpu":
        return fused_scan_expand_plain(table_u8, words_t, *tail_ops, levels=levels)
    if table_u8.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {table_u8.device}")
    ps.check_kernel_operands(table_u8, words_t)
    if not all(x.is_contiguous() for x in tail_ops):
        raise ValueError("per-query tail operands must be contiguous")
    h, b = table_u8.shape
    q = words_t.shape[1]
    qe, _, _, nw0 = seeds.shape
    out = torch.zeros((q, b), dtype=torch.uint8, device=table_u8.device)
    tail_out = torch.empty((qe, 8, 16, nw0 << levels), dtype=torch.int32, device=seeds.device)
    fn = _build.load("fused_scan_expand").pir_fused_scan_expand
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(table_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table_u8.data_ptr(), words_t.data_ptr(), *(x.data_ptr() for x in tail_ops),
                 out.data_ptr(), tail_out.data_ptr(), h, b // 4, q, qe, nw0, levels, stream)
    _build.check(err, "fused_scan_expand")
    _build.count_launch(fused_scan_expand)
    return out, tail_out


fused_scan_expand.launches = 0
