"""The stacked root-start fast answer pipeline (counterpart of
``stacked_fast_geometry`` and ``fused_fast_root_batch_stacked_fn`` in
``pir_tpu/models/pipeline.py``).

One batch of fast-mode payloads against the chunk-major storage table:
head walk (plain torch, ``dpf/device.py``) -> stacked tail kernel
(``ops/expand.py``) -> packed scan kernel (``ops/packed_scan.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dpf.device import (
    FastRootLayout,
    expand_root_head_grouped,
    regroup_rk_stacked,
    unpack_fast_root_payload,
    unpack_fast_root_payload_lanes_rk,
)
from ..ops.expand import fast_tail_expand_stacked
from ..ops.packed_scan import packed_scan

# queries per stacked step at most; the table's storage order follows
# from it, so table build and dispatch share this one constant
STACKED_K_MAX = 32


def stacked_fast_geometry(depth: int, n_blk: int) -> tuple[int, int]:
    """(k queries per step, tail levels) for the stacked fast tail.

    k is the largest power of two <= STACKED_K_MAX keeping k * flat_rows
    selection bits per step within k_max << 20; the head/tail split then
    targets W = k * NW0 = 128 lane words.
    """
    flat_rows = (128 * n_blk) << depth
    k = max(1, min(STACKED_K_MAX, (STACKED_K_MAX << 20) // flat_rows))
    k = 1 << (k.bit_length() - 1)
    head = min(depth, 5 + max(0, (128 // k).bit_length() - 1))
    return k, depth - head


def stacked_head(payloads: torch.Tensor, layout: FastRootLayout):
    """Head walk + regroup: (Q, total) int32 payloads, Q a multiple of k ->
    the stacked tail operands (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf)."""
    k, tail = stacked_fast_geometry(layout.depth, layout.leaf_blocks)
    head_levels = layout.depth - tail
    nw0 = max(1, (1 << head_levels) // 32)
    if layout.shared_rk:
        rk, rk_leaf = unpack_fast_root_payload(payloads[0], layout)[6:]
        rk_head = rk
    else:
        rk_head, rkl_lanes = unpack_fast_root_payload_lanes_rk(payloads, layout)
        rk = regroup_rk_stacked(rk_head, k, nw0)
        rk_leaf = regroup_rk_stacked(rkl_lanes, k, nw0)
    seeds, t, cw_s, cw_tl, cw_tr, fcw = expand_root_head_grouped(
        payloads, layout, rk_head, head_levels, k)
    return seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf


def stacked_words_t(packed: torch.Tensor, k: int, rows: int) -> torch.Tensor:
    """Tail output (S, 8, BN, 16, W) -> the scan's selection words
    (rows // 32, S * k): row-word index ((bit*BN + chunk)*16 + byte)*NW0
    + w of query s*k + j (lane j*NW0 + w), zero words past the flat bits."""
    s_n, _, bn, _, w = packed.shape
    nw0 = w // k
    words = packed.reshape(s_n, 8, bn, 16, k, nw0).permute(1, 2, 3, 5, 0, 4)
    words = words.reshape(-1, s_n * k)
    if rows // 32 > words.shape[0]:
        words = torch.cat([words, words.new_zeros(rows // 32 - words.shape[0], s_n * k)])
    return words.contiguous()


def fused_fast_root_batch_stacked(table_u8: torch.Tensor, payloads: torch.Tensor,
                                  layout: FastRootLayout) -> torch.Tensor:
    """Root-start batched fast answers through the stacked tail kernel:
    table (flat_pad, B) uint8 in the stacked storage order, payloads
    (Q, total) int32 -> (Q, B) uint8 answer shares.

    Serves both key styles against the same table: batch-shared keys
    (layout.shared_rk, one round-key mask set) and distinct-key batches
    (per-query keys regrouped per step and lane word).
    """
    k, tail = stacked_fast_geometry(layout.depth, layout.leaf_blocks)
    q = payloads.shape[0]
    qp = -(-q // k) * k
    if qp != q:  # pad to the step group; sliced back before return
        payloads = torch.cat([payloads, payloads[:1].expand(qp - q, -1)])
    ops = stacked_head(payloads, layout)
    packed = fast_tail_expand_stacked(*ops, tail=tail, n_blk=layout.leaf_blocks)
    words_t = stacked_words_t(packed, k, table_u8.shape[0])
    return packed_scan(table_u8, words_t)[:q]


def payload_tensor(payload: np.ndarray, device) -> torch.Tensor:
    """(Q, total) uint32 host payload -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(payload).view(np.int32)).to(device)
