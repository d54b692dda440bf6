"""The answer pipelines (counterpart of the per-query functions
``expand_bits_planes`` ... ``fused_answer_batch_fn``,
``_expand_planes_loop``, ``fused_fast_bits_fn`` and the six
``fused_fast_answer*_fn``, and of the root-start batch paths
``stacked_fast_geometry``, ``fused_fast_root_batch_stacked_fn``,
``fused_fast_root_batch_pallas_fn`` (its ``all_xla_expand`` switch too),
``fused_fast_overlap_step_fn`` and ``fused_compat_root_batch_pallas_fn``
in ``pir_tpu/models/pipeline.py``; its ``_compat_skip_walk`` lives in
``ops/compat_head.py``).

Single queries and small batches (per-query key payloads): breadth-first
expansion from the host prefix (plain torch, ``dpf/device.py``) -> leaf
bits gathered into natural row order -> masked-XOR scan kernel
(``ops/xor_scan.py``) against the natural-order word table. The fast
answers (``fused_fast_answer*``) scan the natural table's words or bytes,
or, with no gather, a table whose rows were scattered once into the
expansion's storage order, with the masked-XOR scan kernel or the
bit-plane scan kernel (``ops/planes_scan.py``).

Fast keys, against the chunk-major storage table: head walk (plain
torch, ``dpf/device.py``) -> stacked tail kernel (``ops/expand.py``) ->
packed scan kernel (``ops/packed_scan.py``), or for at most MIN_BATCH
queries the masked-XOR scan kernel on the same table.

Fast keys, against the classic bit-reversed storage table (the server's
``fast_stacked=False``): head walk with Q in lanes -> per-query tail
kernel (``ops/fast_tail.py``) -> the same packed scan; or, one batch
ahead in the serving stream, the fused scan + tail kernel
(``ops/fused.py``) that scans batch i while expanding batch i+1. With
``all_xla_expand`` the whole walk and leaf PRG run in plain torch with Q
in lanes instead of the head walk and the tail kernel (batch-shared keys).

Reference-exact (compat) keys, against the cascade's storage table:
head-walk kernel (``ops/compat_head.py``) -> compat-stage kernel once per stage
(``ops/compat_stage.py``) -> the same packed scan kernel. On a table of
5 device levels, too shallow for a stage (pir_tpu's
``fused_compat_root_batch_fn``): the whole walk in plain torch -> the
bit-plane scan kernel (``ops/planes_scan.py``) against the bit-reversed
raw table.

Each root-start head also starts at a row shard's subtree root
(``shard=(index, levels)``): the mesh engine (``parallel/mesh.py``) runs
these pipelines shard by shard.
"""

from __future__ import annotations

import functools

import torch

from ..dpf.device import (
    CompatRootLayout,
    FastPayloadLayout,
    FastRootLayout,
    PayloadLayout,
    _leaf_select_bits,
    _leaf_stage,
    _level_step,
    _rk_bit_first,
    _unpack_bits,
    expand_fast_root_lanes_full,
    fast_leaf_bits_flat,
    fast_leaf_bits_flat_batch,
    expand_planes_from_root,
    expand_root_head_grouped,
    expand_root_head_lanes,
    regroup_rk_stacked,
    unpack_compat_root_payload,
    unpack_fast_payload,
    unpack_fast_root_payload,
    unpack_fast_root_payload_lanes_rk,
    unpack_key_payload,
)
from ..ops.compat_head import compat_head as walk_compat_head
from ..ops.compat_head import compat_skip_walk
from ..ops.compat_stage import compat_stage
from ..ops.expand import fast_tail_expand_stacked
from ..ops.fast_tail import fast_tail_expand
from ..ops.fused import fused_scan_expand
from ..ops.packed_scan import packed_scan, unpack_words_t
from ..ops.planes_scan import planes_scan
from ..ops.xor_scan import masked_xor_scan
from ..utils.metrics import span

# queries per stacked step at most; the table's storage order follows
# from it, so table build and dispatch share this one constant
STACKED_K_MAX = 32
# fast batches of at most this many queries (the server pads smaller ones
# up to it) scan with the masked-XOR scan kernel, which reads the table
# once for them all, instead of the packed scan (the JAX package's
# mxu_batch_threshold, below which TpuPirServer prefers its VPU scan)
MIN_BATCH = 8


def expand_bits_planes(seeds, t_plane, cw_seed_masks, cw_tl, cw_tr, rk_masks, fcw_mask,
                       perm, *, d_levels: int) -> torch.Tensor:
    """Breadth-first expansion of packed seed planes into selection bits:
    seeds (8,16,NW0), t_plane (NW0,), cw_* (d,...), perm (rows,) int64 ->
    (rows,) uint8 natural-order bits. The same walk takes a batch with
    queries on the second axis (``_queries_in_lanes``) -> (Q, rows)."""
    seeds, t_plane = _expand_planes_loop(seeds, t_plane, cw_seed_masks, cw_tl, cw_tr, rk_masks,
                                         d_levels)
    return _leaf_stage(seeds, t_plane, fcw_mask, perm)


def answer_query(table, seeds, t_plane, cw_seed_masks, cw_tl, cw_tr, rk_masks, fcw_mask, perm,
                 *, d_levels: int) -> torch.Tensor:
    """Full single-shard answer: expand + masked-XOR scan (ops/xor_scan.py).
    table (H, C) int32 words -> answer share (C,) int32, or (Q, C) for a
    batch in the ``_queries_in_lanes`` layout."""
    bits = expand_bits_planes(seeds, t_plane, cw_seed_masks, cw_tl, cw_tr, rk_masks, fcw_mask,
                              perm, d_levels=d_levels)
    return masked_xor_scan(table, bits)


def make_answer_fn(d_levels: int):
    """answer_query with the level count bound (the JAX package's jittable
    flagship forward; here a plain partial)."""
    return functools.partial(answer_query, d_levels=d_levels)


def fused_answer(table: torch.Tensor, payload: torch.Tensor, perm: torch.Tensor,
                 layout: PayloadLayout) -> torch.Tensor:
    """One compat answer from one packed key payload (pir_tpu's
    fused_answer_fn(layout), with no jit cache): table (H, C) int32,
    payload (total,) int32, perm (H,) int64 -> (C,) int32."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk = unpack_key_payload(payload, layout)
    return answer_query(table, seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, perm,
                        d_levels=layout.d_levels)


def fused_bits(payload: torch.Tensor, perm: torch.Tensor, layout: PayloadLayout) -> torch.Tensor:
    """Compat expansion from one payload (pir_tpu's fused_bits_fn(layout),
    with no jit cache) -> (rows,) uint8 bits."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk = unpack_key_payload(payload, layout)
    return expand_bits_planes(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, perm,
                              d_levels=layout.d_levels)


def _queries_in_lanes(seeds, t, cw_s, cw_tl, cw_tr, fcw, rk):
    """Unpacked payload rows with a leading Q axis -> the layout the
    per-level ops broadcast over: seeds (8,Q,16,NW0), t (Q,NW0), cw_s
    (d,8,Q,16,1), cw_tl / cw_tr (d,Q,1), fcw (Q,1), rk (11,8,3,Q,16,1)."""
    return (seeds.transpose(0, 1), t, cw_s.permute(1, 2, 0, 3, 4), cw_tl.t()[..., None],
            cw_tr.t()[..., None], fcw[:, None], _rk_bit_first(rk))


def fused_answer_batch(table: torch.Tensor, payloads: torch.Tensor, perm: torch.Tensor,
                       layout: PayloadLayout) -> torch.Tensor:
    """Compat answers of a batch of payloads (Q, total) -> (Q, C) int32
    (pir_tpu's fused_answer_batch_fn(layout): its vmap is the Q axis of
    ``_queries_in_lanes``; one expansion walks every query, one scan
    reads the table for them all)."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk = _queries_in_lanes(
        *unpack_key_payload(payloads, layout))
    return answer_query(table, seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, perm,
                        d_levels=layout.d_levels)


def _expand_planes_loop(seeds, t_plane, cw_s, cw_tl, cw_tr, rk, d_levels: int):
    for i in range(d_levels):
        seeds, t_plane = _level_step(seeds, t_plane, cw_s[i], cw_tl[i], cw_tr[i], rk)
    return seeds, t_plane


def _fast_bits_flat(payload: torch.Tensor, layout: FastPayloadLayout) -> torch.Tensor:
    """Fast-mode expansion from one payload (total,) -> (flat,) uint8 bits
    in storage order (dpf.device.fast_leaf_bits_flat)."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk, rk_leaf = unpack_fast_payload(payload, layout)
    seeds, t = _expand_planes_loop(seeds, t, cw_s, cw_tl, cw_tr, rk, layout.d_levels)
    return fast_leaf_bits_flat(seeds, t, fcw, rk_leaf)


def fused_fast_bits(payload: torch.Tensor, perm: torch.Tensor,
                    layout: FastPayloadLayout) -> torch.Tensor:
    """Fast-mode expansion from one payload (pir_tpu's
    fused_fast_bits_fn(layout), with no jit cache) -> (height,) uint8 bits."""
    return _fast_bits_flat(payload, layout)[perm]


def _fast_bits_flat_batch(payloads: torch.Tensor, layout: FastPayloadLayout) -> torch.Tensor:
    """Fast-mode expansion of a batch of per-query payloads (Q, total) ->
    (Q, flat) uint8 bits in storage order, each row fast_leaf_bits_flat's
    (pir_tpu vmaps the per-query walk; here the queries ride the walk's
    second axis, as in fused_answer_batch)."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk, rk_leaf = unpack_fast_payload(payloads, layout)
    seeds, t = _expand_planes_loop(seeds.transpose(0, 1), t, cw_s.permute(1, 2, 0, 3, 4),
                                   cw_tl.t()[..., None], cw_tr.t()[..., None],
                                   _rk_bit_first(rk), layout.d_levels)
    return fast_leaf_bits_flat_batch(seeds, t, fcw, rk_leaf)


def _pad_bits(bits: torch.Tensor, rows: int) -> torch.Tensor:
    """(Q, n) bits -> (Q, rows) with zero bits for the XOR-neutral padded
    table rows past n."""
    if rows > bits.shape[1]:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[0], rows - bits.shape[1])], dim=1)
    return bits.contiguous()


def fused_fast_answer(table: torch.Tensor, payload: torch.Tensor, perm: torch.Tensor,
                      layout: FastPayloadLayout) -> torch.Tensor:
    """One fast answer from one payload (pir_tpu's fused_fast_answer_fn):
    the natural-order word table (H, C) int32, payload (total,) int32, perm
    (H,) int64 -> (C,) int32 through the masked-XOR scan kernel."""
    return masked_xor_scan(table, fused_fast_bits(payload, perm, layout))


def fused_fast_answer_batch(table: torch.Tensor, payloads: torch.Tensor, perm: torch.Tensor,
                            layout: FastPayloadLayout) -> torch.Tensor:
    """Fast answers of a batch of payloads (pir_tpu's
    fused_fast_answer_batch_fn): the natural-order word table (H, C)
    int32, payloads (Q, total) -> (Q, C) int32; one expansion walks every
    query, one masked-XOR scan launch reads the table for each 8 queries."""
    return masked_xor_scan(table, _fast_bits_flat_batch(payloads, layout)[:, perm])


def fused_fast_answer_batch_mxu(table_u8: torch.Tensor, payloads: torch.Tensor,
                                perm: torch.Tensor, layout: FastPayloadLayout) -> torch.Tensor:
    """Fast answers of a batch through the bit-plane scan kernel (pir_tpu's
    fused_fast_answer_batch_mxu_fn): the natural-order table (H_pad, B)
    uint8, B % 4 == 0 (the word table's bytes), payloads (Q, total) ->
    (Q, B) uint8; bits of the padded rows are zero."""
    bits = _fast_bits_flat_batch(payloads, layout)[:, perm]
    return planes_scan(table_u8, _pad_bits(bits, table_u8.shape[0]))


def fused_fast_answer_batch_preplane(table_u8: torch.Tensor, payloads: torch.Tensor,
                                     perm: torch.Tensor,
                                     layout: FastPayloadLayout) -> torch.Tensor:
    """pir_tpu's fused_fast_answer_batch_preplane_fn, which takes a bit-plane
    table built once (ops.matmul_scan.make_plane_table, 8x the table's
    bytes). The bit-plane scan kernel packs its planes itself in its
    pre-pass, so the port keeps no plane table on the card: this takes the
    natural-order uint8 table, as fused_fast_answer_batch_mxu, whose
    bytes it returns."""
    return fused_fast_answer_batch_mxu(table_u8, payloads, perm, layout)


def fused_fast_answer_batch_storage(table_u8: torch.Tensor, payloads: torch.Tensor,
                                    layout: FastPayloadLayout) -> torch.Tensor:
    """Fast answers of a batch with no gather (pir_tpu's
    fused_fast_answer_batch_storage_fn): the table's rows scattered once into
    the expansion's storage order (dpf.device.scatter_rows_to_storage_order
    with dpf.device._fast_leaf_perm), payloads (Q, total) -> (Q, B) uint8
    through the bit-plane scan kernel. pir_tpu takes that table as bit
    planes; the kernel packs its own, so this takes the (flat_pad, B)
    uint8 table, B % 4 == 0."""
    bits = _fast_bits_flat_batch(payloads, layout)
    return planes_scan(table_u8, _pad_bits(bits, table_u8.shape[0]))


def fused_fast_answer_storage(table: torch.Tensor, payload: torch.Tensor,
                              layout: FastPayloadLayout) -> torch.Tensor:
    """One fast answer with no gather (pir_tpu's fused_fast_answer_storage_fn):
    the (flat, C) int32 word table in the expansion's storage order
    (dpf.device._fast_leaf_perm), payload (total,) -> (C,) int32 through
    the masked-XOR scan kernel."""
    return masked_xor_scan(table, _fast_bits_flat(payload, layout))


def small_batch_scan(table_u8: torch.Tensor, words_t: torch.Tensor) -> torch.Tensor:
    """The packed scan's function for at most MIN_BATCH queries, through
    the masked-XOR scan kernel: table (H, B) uint8 with B % 4 == 0 (the
    storage tables' padded rows), read as (H, B/4) words in place, and
    selection words (H // 32, Q) -> (Q, B) uint8."""
    words = masked_xor_scan(table_u8.view(torch.int32), unpack_words_t(words_t))
    return words.view(torch.uint8)


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


def stacked_head(payloads: torch.Tensor, layout: FastRootLayout, shard=None):
    """Head walk + regroup: (Q, total) int32 payloads, Q a multiple of k ->
    the stacked tail operands (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf).
    With shard = (index, levels) the walk starts at that row shard's
    subtree root (dpf.device.shard_prefix_walk) and the geometry is the
    subtree's: stacked_fast_geometry(depth - levels, n_blk)."""
    with span("pir.head"):
        depth = layout.depth - (shard[1] if shard else 0)
        k, tail = stacked_fast_geometry(depth, layout.leaf_blocks)
        head_levels = depth - tail
        nw0 = max(1, (1 << head_levels) // 32)
        if layout.shared_rk:
            rk, rk_leaf = unpack_fast_root_payload(payloads[0], layout)[6:]
            rk_head = rk
        else:
            rk_head, rkl_lanes = unpack_fast_root_payload_lanes_rk(payloads, layout)
            rk = regroup_rk_stacked(rk_head, k, nw0)
            rk_leaf = regroup_rk_stacked(rkl_lanes, k, nw0)
        seeds, t, cw_s, cw_tl, cw_tr, fcw = expand_root_head_grouped(
            payloads, layout, rk_head, head_levels, k, shard)
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
                                  layout: FastRootLayout, shard=None) -> torch.Tensor:
    """Root-start batched fast answers through the stacked tail kernel:
    table (flat_pad, B) uint8 in the stacked storage order, payloads
    (Q, total) int32 -> (Q, B) uint8 answer shares.

    Serves both key styles against the same table: batch-shared keys
    (layout.shared_rk, one round-key mask set) and distinct-key batches
    (per-query keys regrouped per step and lane word). With shard =
    (index, levels), the partial answers of that row shard's subtree
    against its slice of the table (stacked_head).
    """
    k, tail = stacked_fast_geometry(layout.depth - (shard[1] if shard else 0),
                                    layout.leaf_blocks)
    q = payloads.shape[0]
    qp = -(-q // k) * k
    if qp != q:  # pad to the step group; sliced back before return
        payloads = torch.cat([payloads, payloads[:1].expand(qp - q, -1)])
    ops = stacked_head(payloads, layout, shard)
    with span("pir.expand"):
        packed = fast_tail_expand_stacked(*ops, tail=tail, n_blk=layout.leaf_blocks)
    with span("pir.scan"):
        words_t = stacked_words_t(packed, k, table_u8.shape[0])
        if q <= MIN_BATCH:
            return small_batch_scan(table_u8, words_t[:, :q])
        return packed_scan(table_u8, words_t)[:q]


def pertail_head(payloads: torch.Tensor, layout: FastRootLayout, tail_levels: int,
                 shard=None):
    """Head walk with Q in lanes for the per-query tail: (Q, total) int32
    payloads -> the tail operands (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw,
    rk_leaf) and the tail's level count, max(0, min(tail_levels, depth -
    5)). Batch-shared keys give one round-key mask set (from payload row
    0); distinct keys per-query masks, and the head walks every query's
    own keys in one batched pass. With shard = (index, levels) the walk
    starts at that row shard's subtree root and depth is the subtree's,
    depth - levels (dpf.device.shard_prefix_walk)."""
    with span("pir.head"):
        depth = layout.depth - (shard[1] if shard else 0)
        tail = max(0, min(tail_levels, depth - 5))
        if layout.shared_rk:
            rk, rk_leaf = unpack_fast_root_payload(payloads[0], layout)[6:]
            rk_head = rk
        else:  # lanes (11,8,3,16,Q) for the head; (Q,...,1) per query for the tail
            rk_head, rkl = unpack_fast_root_payload_lanes_rk(payloads, layout)
            rk = rk_head.permute(4, 0, 1, 2, 3)[..., None].contiguous()
            rk_leaf = rkl.permute(3, 0, 1, 2)[..., None].contiguous()
        seeds, t, cw_s, cw_tl, cw_tr, fcw = expand_root_head_lanes(
            payloads, layout, rk_head, depth - tail, shard)
        return (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf), tail


def pertail_words_t(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-query tail output (Q, 8, 16, L) -> the scan's selection words
    (rows // 32, Q): a query's words in output order, zero words for the
    XOR-neutral padded table rows past the flat bits."""
    q = packed.shape[0]
    words = packed.reshape(q, -1)
    if rows // 32 > words.shape[1]:
        words = torch.cat([words, words.new_zeros(q, rows // 32 - words.shape[1])], dim=1)
    return words.t().contiguous()


def fused_fast_root_batch_pertail(table_u8: torch.Tensor, payloads: torch.Tensor,
                                  layout: FastRootLayout, tail_levels: int,
                                  shard=None, all_xla_expand: bool = False) -> torch.Tensor:
    """Root-start batched fast answers through the per-query tail kernel:
    table (flat_pad, B) uint8 in the classic storage order
    (dpf.device._fast_leaf_perm_root), payloads (Q, total) int32 -> (Q, B)
    uint8 answer shares. Serves both key styles and every leaf width. The
    scan takes the whole batch in one launch (the JAX package slices Q for
    the TPU's VMEM; the bytes are the same). shard as in pertail_head.

    all_xla_expand (batch-shared keys of the whole table only; pir_tpu's
    switch of that name): the whole expansion, tree walk and leaf PRG, runs
    in plain torch with Q in lanes (dpf.device.expand_fast_root_lanes_full)
    in place of the head walk and the tail kernel; the same words, the
    same scan. No server path sets it."""
    if all_xla_expand:
        if not layout.shared_rk:
            raise ValueError("all_xla_expand needs the batch-shared key layout")
        if shard is not None:
            raise ValueError("all_xla_expand walks the whole tree: no shard")
        rk, rk_leaf = unpack_fast_root_payload(payloads[0], layout)[6:]
        packed = expand_fast_root_lanes_full(payloads, layout, rk, rk_leaf)
    else:
        ops, tail = pertail_head(payloads, layout, tail_levels, shard)
        with span("pir.expand"):
            packed = fast_tail_expand(*ops, levels=tail)
    with span("pir.scan"):
        words_t = pertail_words_t(packed, table_u8.shape[0])
        if payloads.shape[0] <= MIN_BATCH:
            return small_batch_scan(table_u8, words_t)
        return packed_scan(table_u8, words_t)


def check_overlap_layout(layout: FastRootLayout) -> None:
    """Raise unless the fused overlap step serves this layout."""
    if not layout.shared_rk:
        raise ValueError("overlap serving needs the batch-shared key layout")
    if layout.leaf_blocks > 1:
        raise ValueError("overlap serving does not support wide-leaf keys")


def fused_fast_overlap_step(table_u8: torch.Tensor, words_prev_t: torch.Tensor,
                            payloads: torch.Tensor, layout: FastRootLayout,
                            tail_levels: int):
    """Steady-state overlap step: scan batch i's selection words while
    expanding batch i+1, in one kernel (ops/fused.py). Needs batch-shared
    keys and 128-bit leaves.

    table (flat_pad, B) uint8 in the classic storage order, words_prev_t
    (flat_pad // 32, Q) int32, payloads (Q, total) int32 ->
    (out_prev (Q, B) uint8, words_next_t (flat_pad // 32, Q) int32).
    Feed words_next_t back as the next call's words_prev_t; the first call
    takes zeros (its answers are discarded) and the last batch drains with
    a zero payload (its tail words are discarded). Unlike the JAX step
    (``fused_geometry``), no table or batch shape is refused for want of
    a tiling.
    """
    check_overlap_layout(layout)
    ops, tail = pertail_head(payloads, layout, tail_levels)
    out_prev, packed = fused_scan_expand(table_u8, words_prev_t, *ops, levels=tail)
    return out_prev, pertail_words_t(packed, table_u8.shape[0])


def compat_head(payloads: torch.Tensor, layout: CompatRootLayout, w: int, shard=None):
    """Unpack, skip walk and root-start head of 5 + log2(w) levels for a
    batch of compat payloads (Q, total) -> the first stage's operands and
    the rest: seeds (Q,8,1,16,w), t (Q,1,1,w), then cw_s (Q,d',8,16,1),
    cw_tl / cw_tr (Q,d') for the stage levels, rk (Q,11,8,3,16,1), fcw (Q,).
    With shard = (index, levels) the skip walk is followed by the walk
    down to that row shard's subtree, and the head starts there. The walk
    is one launch of the head kernel (ops/compat_head.py)."""
    with span("pir.head"):
        seeds, t, cw_s, cw_tl, cw_tr, fcw, rk = unpack_compat_root_payload(payloads, layout)
        seeds, t = walk_compat_head(seeds.contiguous(), t.contiguous(), cw_s,
                                    cw_tl.contiguous(), cw_tr.contiguous(), rk,
                                    skip=layout.skip, w=w, shard=shard)
        lv = layout.skip + (shard[1] if shard is not None else 0) + 5 + w.bit_length() - 1
        return (seeds, t, cw_s[:, lv:].contiguous(), cw_tl[:, lv:].contiguous(),
                cw_tr[:, lv:].contiguous(), rk, fcw.contiguous())


def compat_stages(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, tails) -> torch.Tensor:
    """The stage cascade for one slice of queries -> (Q, 2^device_bits / 32)
    selection words; the last stage emits bits."""
    off = 0
    for si, tl in enumerate(tails):
        last = si == len(tails) - 1
        res = compat_stage(seeds, t, cw_s[:, off:off + tl].contiguous(),
                           cw_tl[:, off:off + tl].contiguous(),
                           cw_tr[:, off:off + tl].contiguous(), rk, fcw,
                           tail=tl, emit_bits=last)
        if not last:
            seeds, t = res
        off += tl
    return res.reshape(res.shape[0], -1)


def fused_compat_root_batch(table_u8: torch.Tensor, payloads: torch.Tensor,
                            layout: CompatRootLayout, w: int, tails: tuple[int, ...],
                            q_chunk: int, shard=None) -> torch.Tensor:
    """Root-start batched compat answers: table (flat_pad, B) uint8 in the
    cascade's storage order (dpf.device._compat_perm for `w`, `tails`),
    payloads (Q, total) int32 -> (Q, B) uint8 answer shares.

    The head walks the whole batch at once (its launch count does not
    grow with Q); the stage cascade runs in slices of at most `q_chunk`
    queries, which bounds its seed planes (4 MiB a query after the
    second stage on the 1 GiB table) and changes no output byte. With
    shard = (index, levels), the partial answers of that row shard's
    subtree (compat_head) against its slice of the table.
    """
    q = payloads.shape[0]
    ops = compat_head(payloads, layout, w, shard)
    with span("pir.expand"):
        words = torch.cat([compat_stages(*(x[q0:q0 + q_chunk] for x in ops), tails)
                           for q0 in range(0, q, q_chunk)])
    with span("pir.scan"):
        rows = table_u8.shape[0]
        if rows // 32 > words.shape[1]:  # zero bits for the XOR-neutral padded rows
            words = torch.cat([words, words.new_zeros(q, rows // 32 - words.shape[1])], dim=1)
        return packed_scan(table_u8, words.t().contiguous())


def fused_compat_preplane_batch(table_u8: torch.Tensor, payloads: torch.Tensor,
                                layout: CompatRootLayout) -> torch.Tensor:
    """Root-start batched compat answers on a table too shallow for the
    stage cascade (pir_tpu's fused_compat_root_batch_fn): the skip walk,
    then every device level from the root in plain torch, leaf i at bit i
    (the bit-reversed row order), then the bit-plane scan kernel
    (ops/planes_scan.py) in place of pir_tpu's plane-table product.
    table (2^device_bits, B) uint8 with row r at bit_reverse(r)
    (dpf.device._compat_leaf_perm_root), payloads (Q, total) int32 ->
    (Q, B) uint8."""
    nbd, sk = layout.device_bits, layout.skip
    seeds, t, cw_s, cw_tl, cw_tr, fcw, rk = unpack_compat_root_payload(payloads, layout)
    seeds, t = compat_skip_walk(seeds, t, cw_s, cw_tl, cw_tr, rk, sk)
    seeds, t = expand_planes_from_root(seeds, t, cw_s[:, sk:], cw_tl[:, sk:], cw_tr[:, sk:],
                                       rk, nbd)
    packed = _leaf_select_bits(seeds.transpose(0, 1), t, fcw[:, None])  # (Q, NW)
    # below 5 levels the leaves are one word's low lanes
    return planes_scan(table_u8, _unpack_bits(packed)[:, :1 << nbd].contiguous())
