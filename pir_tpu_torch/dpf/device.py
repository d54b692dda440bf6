"""Root-start DPF expansion on the device (counterpart of the fast and
compat root-start subsets of ``pir_tpu/dpf/device.py``).

The host packs each query's key material into one row of 32-bit words
(``make_fast_payload_batch``); the device unpacks it into plane masks and
walks the top ``head`` tree levels with the queries in lanes
(``expand_root_head_grouped``), bitsliced AES in plain torch ops. The
result is regrouped for the stacked tail kernel (``ops/expand.py``),
whose output words are the scan's selection bits in a chunk-major
storage order; ``_fast_leaf_perm_root_stacked`` scatters table rows into
that same order. For the per-query tail kernel (``ops/fast_tail.py``)
the same walk ends in ``expand_root_head_lanes`` (one query a row, both
key styles), and ``_fast_leaf_perm_root`` is the classic bit-reversed
storage order its output words select.

Reference-exact (compat) keys walk the whole tree: the host packs them
with ``make_compat_payload_batch``, the device walks the head with
``expand_planes_from_root`` (batched over a leading query axis), and the
compat-stage cascade (``ops/compat_stage.py``) walks the rest in stages
planned by ``compat_stage_plan``; ``_compat_perm`` is the matching
storage order of the table rows.

Device tensors hold the bit pattern of the JAX package's uint32 words as
``torch.int32``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .aes_host import key_schedule_batch
from .bitslice import aes_encrypt_planes

_FULL = np.uint32(0xFFFFFFFF)


# --------------------------------------------------------------------------
# Plane-level building blocks
# --------------------------------------------------------------------------

def _prf_triple(seeds: torch.Tensor, rk_masks: torch.Tensor) -> torch.Tensor:
    """Bitsliced MMO PRG: seeds (8,...,16,NW) -> out (8,3,...,16,NW);
    rk_masks (11,8,3,...,16,1|NW) broadcast against the middle axes."""
    x = seeds[:, None]
    return aes_encrypt_planes(x, rk_masks) ^ x


def _children(out, t_plane, cw_seed_mask, cw_tl, cw_tr):
    """Split PRF output into corrected (sL, tL, sR, tR).

    out: (8,3,...,16,NW); t_plane: (...,NW) packed parent t bits;
    cw_seed_mask: (8,...,16,NW|1) 0/-1 masks; cw_tl/cw_tr: 0/-1 masks
    broadcast against t_plane. Layout: sL = block0[0:16], tL = block1
    byte0, sR = block1 bytes 1..15 ++ block2 byte0, tR = block2 byte1.
    """
    s_l = out[:, 0]
    t_l = out[0, 1, ..., 0, :]
    s_r = torch.cat([out[:, 1, ..., 1:16, :], out[:, 2, ..., 0:1, :]], dim=-2)
    t_r = out[0, 2, ..., 1, :]
    corr = t_plane.unsqueeze(-2).unsqueeze(0) & cw_seed_mask
    return s_l ^ corr, t_l ^ (t_plane & cw_tl), s_r ^ corr, t_r ^ (t_plane & cw_tr)


def _leaf_ctr_masks(n_blk: int) -> np.ndarray:
    """(8, n_blk, 16, 1) uint32 full-word masks of LE64(b) bit planes.

    Wide-leaf CTR extension: block b's AES input is seed ^ LE64(b); in
    the plane layout that XOR is a constant mask at (bit j, block b,
    byte i) = bit j of byte i of LE64(b)."""
    ctr = np.zeros((n_blk, 16), np.uint8)
    for b in range(n_blk):
        ctr[b, :8] = np.frombuffer(b.to_bytes(8, "little"), np.uint8)
    bits = ((ctr[None] >> np.arange(8, dtype=np.uint8)[:, None, None]) & 1)
    return (bits.astype(np.uint32) * _FULL)[..., None]


def scatter_rows_to_storage_order(rows: np.ndarray, perm: np.ndarray,
                                  flat_size: int) -> np.ndarray:
    """Permute table rows so storage-order bits scan them directly.

    rows (H, C); perm (H,) natural row -> flat bit position. Positions not
    covering a real row are zero (XOR-neutral). Returns (flat_size, C).
    """
    out = np.zeros((flat_size, rows.shape[1]), dtype=rows.dtype)
    out[perm] = rows
    return out


# --------------------------------------------------------------------------
# Bit-packed root-start payloads
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FastRootLayout:
    """Bit-packed root-start payload: 16-byte blocks as 4 words, t-bit
    vectors as one word; plane masks are expanded on the device."""

    depth: int
    height: int
    # every share in the batch carries the same PRF keys: one round-key
    # mask set serves the whole batch
    shared_rk: bool = False
    # leaf width in 128-bit PRG blocks (FastKey2P.leaf_bits // 128)
    leaf_blocks: int = 1

    @property
    def sizes(self):
        d = self.depth
        # s_init, t_init, cw blocks, cw_tl bits, cw_tr bits, final CW,
        # tree round keys (3 x 11 x 16B), leaf round keys (11 x 16B)
        return (4, 1, 4 * d, 1, 1, 4 * self.leaf_blocks, 132, 44)

    @property
    def total(self):
        return sum(self.sizes)


def _u32_view(a: np.ndarray) -> np.ndarray:
    """(..., 16k) uint8 -> (..., 4k) little-endian uint32."""
    return np.ascontiguousarray(a).view("<u4")


def make_fast_payload_batch(
    shares, shared_rk: bool | None = None
) -> tuple[np.ndarray, FastRootLayout]:
    """Vectorised bit-packed payload builder for fast-mode query shares:
    (Q, layout.total) uint32.

    shared_rk=None detects whether every share carries the same PRF
    keys; callers that already know (or must force the non-shared
    layout, e.g. a chunk tail padded by tiling one query) pass it in.
    """
    q_n = len(shares)
    k0 = shares[0].key_fast
    depth = k0.depth
    if shared_rk is None:
        prf0 = tuple(bytes(k.bytes) for k in shares[0].prf_keys)
        shared_rk = all(
            tuple(bytes(k.bytes) for k in s.prf_keys) == prf0 for s in shares
        )
    layout = FastRootLayout(depth, k0.height, shared_rk, k0.leaf_bits // 128)

    payload = np.zeros((q_n, layout.total), dtype=np.uint32)
    offs = np.cumsum((0,) + layout.sizes)

    s_init = np.stack([np.frombuffer(s.key_fast.s_init, np.uint8) for s in shares])
    payload[:, offs[0]:offs[1]] = _u32_view(s_init)
    payload[:, offs[1]] = np.array(
        [_FULL if s.key_fast.t_init else 0 for s in shares], np.uint32
    )

    if depth:
        cw = np.stack([
            np.frombuffer(b"".join(s.key_fast.cw), np.uint8).reshape(depth, 18)
            for s in shares
        ])  # (Q, d, 18)
        payload[:, offs[2]:offs[3]] = _u32_view(
            np.ascontiguousarray(cw[:, :, :16])
        ).reshape(q_n, depth * 4)
        lvl = np.arange(depth, dtype=np.uint32)
        payload[:, offs[3]] = (
            (cw[:, :, 16] & 1).astype(np.uint32) << lvl
        ).sum(axis=1, dtype=np.uint32)
        payload[:, offs[4]] = (
            (cw[:, :, 17] & 1).astype(np.uint32) << lvl
        ).sum(axis=1, dtype=np.uint32)

    fcw = np.stack([np.frombuffer(s.key_fast.final_cw_block, np.uint8) for s in shares])
    payload[:, offs[5]:offs[6]] = _u32_view(fcw)

    all_keys = np.stack([
        np.frombuffer(k.bytes, np.uint8) for s in shares for k in s.prf_keys
    ])  # (4Q, 16)
    rks = key_schedule_batch(all_keys).reshape(q_n, 4, 11, 16)
    payload[:, offs[6]:offs[7]] = _u32_view(
        np.ascontiguousarray(rks[:, :3])
    ).reshape(q_n, 132)
    payload[:, offs[7]:offs[8]] = _u32_view(
        np.ascontiguousarray(rks[:, 3])
    ).reshape(q_n, 44)
    return payload, layout


# (bit, byte) -> shift into the 4-word little-endian packing of a block
_BLOCK_SHIFTS = ((np.arange(16) % 4) * 8 + np.arange(8)[:, None]).astype(np.int32)
_BLOCK_WORD = (np.arange(16) // 4).astype(np.int64)


def _unpack_block_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., 4) packed 16-byte blocks -> (..., 8, 16) bits {0,1}."""
    w = words[..., torch.from_numpy(_BLOCK_WORD).to(words.device)]  # (..., 16)
    shifts = torch.from_numpy(_BLOCK_SHIFTS).to(words.device)
    return (w[..., None, :] >> shifts) & 1


def _unpack_block_masks(words: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 8, 16) masks 0/-1."""
    return -_unpack_block_bits(words)


def _bit_masks(words: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) words -> (n, ...) masks 0/-1 from their low n bits."""
    lvl = torch.arange(n, dtype=torch.int32, device=words.device)
    lvl = lvl.reshape((n,) + (1,) * words.dim())
    return -((words[None] >> lvl) & 1)


def unpack_fast_root_payload(payload: torch.Tensor, layout: FastRootLayout):
    """One payload row (total,) -> seeds (8,16,1) bit values, t_init (1,),
    cw_s (d,8,16,1), cw_tl / cw_tr (d,), fcw (8,16,1) or (8,n_blk,16,1),
    rk (11,8,3,16,1), rk_leaf (11,8,16,1)."""
    d = layout.depth
    offs = np.cumsum((0,) + layout.sizes)
    seg = [payload[offs[i]:offs[i + 1]] for i in range(len(layout.sizes))]
    seeds = _unpack_block_bits(seg[0])[..., None]
    t_init = seg[1]
    cw_s = _unpack_block_masks(seg[2].reshape(d, 4))[..., None]
    cw_tl = _bit_masks(seg[3][0], d)
    cw_tr = _bit_masks(seg[4][0], d)
    if layout.leaf_blocks > 1:  # wide leaf: (8, n_blk, 16, 1)
        fcw = _unpack_block_masks(seg[5].reshape(layout.leaf_blocks, 4)
                                  ).permute(1, 0, 2)[..., None]
    else:
        fcw = _unpack_block_masks(seg[5])[..., None]  # (8,16,1)
    rk_tree = _unpack_block_masks(seg[6].reshape(3, 11, 4))  # (3,11,8,16)
    rk = rk_tree.permute(1, 2, 0, 3)[..., None].contiguous()  # (11,8,3,16,1)
    rk_leaf = _unpack_block_masks(seg[7].reshape(11, 4))[..., None].contiguous()
    return seeds, t_init, cw_s, cw_tl, cw_tr, fcw, rk, rk_leaf


def unpack_fast_root_payload_lanes(payloads: torch.Tensor, layout: FastRootLayout):
    """Batched unpack with the QUERY axis in lanes: payloads (Q, total) ->
    seeds (8,16,Q) bit values, t_init (Q,) mask words, cw_s (d,8,16,Q)
    masks, cw_tl / cw_tr (d,Q) masks, fcw (Q,8,16) or (Q,8,n_blk,16)."""
    d = layout.depth
    q_n = payloads.shape[0]
    offs = np.cumsum((0,) + layout.sizes)
    seg = [payloads[:, offs[i]:offs[i + 1]] for i in range(len(layout.sizes))]
    seeds = _unpack_block_bits(seg[0]).permute(1, 2, 0)  # (8,16,Q)
    t_init = seg[1][:, 0]
    cw = _unpack_block_masks(seg[2].reshape(q_n, d, 4))  # (Q,d,8,16)
    cw_s = cw.permute(1, 2, 3, 0)  # (d,8,16,Q)
    cw_tl = _bit_masks(seg[3][:, 0], d)
    cw_tr = _bit_masks(seg[4][:, 0], d)
    if layout.leaf_blocks > 1:  # wide leaf: (Q, 8, n_blk, 16)
        fcw = _unpack_block_masks(
            seg[5].reshape(q_n, layout.leaf_blocks, 4)).permute(0, 2, 1, 3)
    else:
        fcw = _unpack_block_masks(seg[5])  # (Q,8,16)
    return seeds, t_init, cw_s, cw_tl, cw_tr, fcw


def unpack_fast_root_payload_lanes_rk(payloads: torch.Tensor, layout: FastRootLayout):
    """Per-query round-key masks with Q in lanes (distinct-key batches):
    payloads (Q, total) -> rk (11,8,3,16,Q), rk_leaf (11,8,16,Q)."""
    q_n = payloads.shape[0]
    offs = np.cumsum((0,) + layout.sizes)
    rk_tree = _unpack_block_masks(
        payloads[:, offs[6]:offs[7]].reshape(q_n, 3, 11, 4))  # (Q,3,11,8,16)
    rk = rk_tree.permute(2, 3, 1, 4, 0)  # (11,8,3,16,Q)
    rkl = _unpack_block_masks(
        payloads[:, offs[7]:offs[8]].reshape(q_n, 11, 4)).permute(1, 2, 3, 0)
    return rk, rkl


def _expand_root_level_lanes(seeds, t_plane, cw_seed_mask, cw_tl, cw_tr,
                             rk_masks, i: int, w: int):
    """One root-expansion level over a flattened (word, query) lane axis.

    seeds (8,16,W*Q) / t_plane (W*Q,) hold W = max(1, 2^i // 32) packed
    words per query, word-major (flat index w*Q + q, so per-query masks
    tile along the flat axis). cw_seed_mask (8,16,Q), cw_tl/cw_tr (Q,).
    rk_masks is (11,8,3,16,1) batch-shared, or (11,8,3,16,Q) per query.
    """
    if w > 1:
        cw_seed_mask = cw_seed_mask.repeat(1, 1, w)
        cw_tl = cw_tl.repeat(w)
        cw_tr = cw_tr.repeat(w)
        if rk_masks.shape[-1] != 1:
            rk_masks = rk_masks.repeat(1, 1, 1, 1, w)
    out = _prf_triple(seeds, rk_masks)
    s_l, t_l, s_r, t_r = _children(out, t_plane, cw_seed_mask, cw_tl, cw_tr)
    if i < 5:
        # levels 0..4 hold 2^i live nodes in the low bits of one word;
        # children land at +2^i within the word
        lo = (1 << (1 << i)) - 1
        shift = 1 << i
        return (s_l & lo) | ((s_r & lo) << shift), (t_l & lo) | ((t_r & lo) << shift)
    # [L words, R words] along the flat axis keeps word-major order
    return torch.cat([s_l, s_r], dim=-1), torch.cat([t_l, t_r], dim=-1)


def regroup_rk_stacked(rk: torch.Tensor, k: int, nw0: int) -> torch.Tensor:
    """Per-query lane-major masks (..., Q) -> per-step (S, ..., W) for the
    stacked tail kernel, W = k * nw0, lane = j*NW0 + w (each query's
    masks repeated across its nw0 lane words)."""
    q_n = rk.shape[-1]
    s_n = q_n // k
    lead = rk.shape[:-1]
    r = rk.reshape(*lead, s_n, k, 1).expand(*lead, s_n, k, nw0)
    r = r.reshape(*lead, s_n, k * nw0)
    return r.movedim(-2, 0).contiguous()


def regroup_head_stacked(seeds, t, cw_s_tail, cw_tl_tail, cw_tr_tail, fcw,
                         k: int, nw0: int, n_blk: int):
    """Regroup post-head word-major lane arrays for the stacked tail
    kernel: k queries per step, lane-packed query-major (lane = j*NW0 + w).

    seeds (8,16,NW0*Q) / t (NW0*Q,) word-major, cw_*_tail sliced to the
    tail levels ((tail,8,16,Q) / (tail,Q)), fcw (Q,8,16) or (Q,8,n_blk,16).
    Returns seeds (S,8,1,16,W), t (S,1,1,W), cw_s (S,tail,8,16,W),
    cw_tl/cw_tr (S,tail,1,W), fcw (S,8,n_blk,16,W), all contiguous,
    with S = Q // k and W = k * NW0. Q must be a multiple of k.
    """
    q_n = fcw.shape[0]
    if q_n % k:
        raise ValueError(f"batch {q_n} not a multiple of group {k}")
    s_n = q_n // k
    wl = k * nw0
    seeds = seeds.reshape(8, 16, nw0, s_n, k).permute(3, 0, 1, 4, 2)
    seeds = seeds.reshape(s_n, 8, 1, 16, wl)
    t = t.reshape(nw0, s_n, k).permute(1, 2, 0).reshape(s_n, 1, 1, wl)
    tail = cw_s_tail.shape[0]
    cw_t = cw_s_tail.reshape(tail, 8, 16, s_n, k, 1).expand(tail, 8, 16, s_n, k, nw0)
    cw_t = cw_t.reshape(tail, 8, 16, s_n, wl).permute(3, 0, 1, 2, 4)

    def _tbits(cw):
        c = cw.reshape(tail, s_n, k, 1).expand(tail, s_n, k, nw0)
        return c.reshape(tail, s_n, 1, wl).permute(1, 0, 2, 3)

    if n_blk > 1:  # (Q, 8, n_blk, 16)
        fg = fcw.reshape(s_n, k, 8, n_blk, 16).permute(0, 2, 3, 4, 1)
    else:  # (Q, 8, 16)
        fg = fcw.reshape(s_n, k, 8, 16).permute(0, 2, 3, 1)[:, :, None]
    fg = fg[..., None].expand(s_n, 8, n_blk, 16, k, nw0).reshape(s_n, 8, n_blk, 16, wl)
    return tuple(x.contiguous() for x in (
        seeds, t, cw_t, _tbits(cw_tl_tail), _tbits(cw_tr_tail), fg))


def _walk_head_lanes(payloads: torch.Tensor, layout: FastRootLayout,
                     rk_masks: torch.Tensor, head_levels: int):
    """Unpack with Q in lanes and walk the top `head_levels` levels ->
    seeds (8,16,NW0*Q) / t (NW0*Q,) word-major, and the unpacked cw_s
    (d,8,16,Q), cw_tl / cw_tr (d,Q), fcw. rk_masks is the (11,8,3,16,1)
    shared or (11,8,3,16,Q) per-query round-key masks."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw = unpack_fast_root_payload_lanes(payloads, layout)
    for i in range(head_levels):
        w = max(1, (1 << i) // 32)
        seeds, t = _expand_root_level_lanes(
            seeds, t, cw_s[i], cw_tl[i], cw_tr[i], rk_masks, i, w)
    return seeds, t, cw_s, cw_tl, cw_tr, fcw


def expand_root_head_grouped(payloads: torch.Tensor, layout: FastRootLayout,
                             rk_masks: torch.Tensor, head_levels: int, k: int):
    """Root head walk with Q in lanes, regrouped for the stacked tail
    kernel (regroup_head_stacked). rk_masks is the head's (11,8,3,16,1)
    shared or (11,8,3,16,Q) per-query round-key masks."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw = _walk_head_lanes(payloads, layout, rk_masks,
                                                         head_levels)
    nw0 = max(1, (1 << head_levels) // 32)
    return regroup_head_stacked(
        seeds, t, cw_s[head_levels:], cw_tl[head_levels:],
        cw_tr[head_levels:], fcw, k, nw0, layout.leaf_blocks)


def expand_root_head_lanes(payloads: torch.Tensor, layout: FastRootLayout,
                           rk_masks: torch.Tensor, head_levels: int):
    """Root head walk with Q in lanes, returning the per-query tail
    kernel's operands (ops/fast_tail.py): seeds (Q,8,16,NW0), t (Q,1,NW0),
    cw_s (Q,tail,8,16,1), cw_tl / cw_tr (Q,tail), fcw (Q,8,16,1) or
    (Q,8,n_blk,16,1), with NW0 = max(1, 2^head_levels // 32) and tail =
    depth - head_levels. rk_masks is the (11,8,3,16,1) batch-shared or
    the (11,8,3,16,Q) per-query round-key masks: the same walk serves
    distinct-key batches, batched over Q."""
    q_n = payloads.shape[0]
    seeds, t, cw_s, cw_tl, cw_tr, fcw = _walk_head_lanes(payloads, layout, rk_masks,
                                                         head_levels)
    nw0 = max(1, (1 << head_levels) // 32)
    seeds = seeds.reshape(8, 16, nw0, q_n).permute(3, 0, 1, 2)
    t = t.reshape(nw0, q_n).t()[:, None, :]
    cw_s_tail = cw_s[head_levels:].permute(3, 0, 1, 2)[..., None]
    return tuple(x.contiguous() for x in (
        seeds, t, cw_s_tail, cw_tl[head_levels:].t(), cw_tr[head_levels:].t(), fcw[..., None]))


@functools.lru_cache(maxsize=64)
def _fast_leaf_perm_root(depth: int, height: int, n_blk: int = 1) -> np.ndarray:
    """Natural row -> flat bit index for the per-query tail's classic
    storage order:

      flat = ((bit*16 + byte)*n_blk + blk) * 2^depth + bit_reverse(leaf, depth)

    where each leaf covers 128*n_blk rows (blk = CTR block within the
    leaf, block-major along lanes, as the per-query tail emits them).
    Lane concatenation puts each new level in the most significant lane
    bit, hence the bit-reversed leaf index."""
    r = np.arange(height, dtype=np.int64)
    leaf = r // (128 * n_blk)
    within = r % (128 * n_blk)
    blk = within >> 7
    wb = within & 127
    byte_i = wb >> 3
    bit_k = wb & 7
    rev = np.zeros_like(leaf)
    for b in range(depth):
        rev |= ((leaf >> b) & 1) << (depth - 1 - b)
    return ((bit_k * 16 + byte_i) * n_blk + blk) * (1 << depth) + rev


def _fast_leaf_perm_root_stacked(depth: int, height: int, n_blk: int,
                                 tail: int) -> np.ndarray:
    """Natural row -> flat bit index for the stacked root-start path.

    The stacked tail kernel doubles branches on a leading chunk axis
    (new_chunk = parent*2 + branch, MSB-first walk), so a leaf's chunk
    index is its low `tail` bits verbatim while the head part keeps the
    lane-doubling bit reversal over the top `head` bits:

      flat = ((bit*2^tail*n_blk + (leaf mod 2^tail)*n_blk + blk) * 16
              + byte) * 2^head + bit_reverse(leaf >> tail, head)
    """
    head = depth - tail
    r = np.arange(height, dtype=np.int64)
    leaf = r // (128 * n_blk)
    within = r % (128 * n_blk)
    blk = within >> 7
    wb = within & 127
    byte_i = wb >> 3
    bit_k = wb & 7
    top = leaf >> tail
    c = leaf & ((1 << tail) - 1)
    rev = np.zeros_like(top)
    for b in range(head):
        rev |= ((top >> b) & 1) << (head - 1 - b)
    return (((bit_k << tail) * n_blk + c * n_blk + blk) * 16
            + byte_i) * (1 << head) + rev


# --------------------------------------------------------------------------
# Reference-exact (compat) root-start path
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CompatRootLayout:
    """Bit-packed root-start payload for reference-exact (compat) keys
    (same packing as FastRootLayout).

    ``skip``: leading tree levels whose RIGHT subtree covers no row. The
    reference's ``num_bits = log2(h)+1`` rule (query.go:61) doubles the
    domain for power-of-two heights, so the root's right half is dead;
    the device walks `skip` levels keeping only the left child before
    the root-start expansion of the remaining ``num_bits - skip`` levels.
    """

    num_bits: int
    height: int
    skip: int = 0

    @property
    def device_bits(self) -> int:
        return self.num_bits - self.skip

    @property
    def sizes(self):
        d = self.num_bits
        # s_init, t_init, cw blocks, cw_tl bits, cw_tr bits, final-CW
        # parity mask, tree round keys (3 x 11 x 16B)
        return (4, 1, 4 * d, 1, 1, 1, 132)

    @property
    def total(self):
        return sum(self.sizes)

    @property
    def flat_bits(self):
        return 1 << self.device_bits


def unpack_compat_root_payload(payloads: torch.Tensor, layout: CompatRootLayout):
    """Payload rows (Q, total) -> seeds (Q,8,16,1) bit values, t (Q,1)
    mask words, cw_s (Q,d,8,16,1), cw_tl / cw_tr (Q,d) and fcw (Q,) masks,
    rk (Q,11,8,3,16,1) round-key masks."""
    d = layout.num_bits
    q_n = payloads.shape[0]
    offs = np.cumsum((0,) + layout.sizes)
    seg = [payloads[:, offs[i]:offs[i + 1]] for i in range(len(layout.sizes))]
    seeds = _unpack_block_bits(seg[0])[..., None]
    cw_s = _unpack_block_masks(seg[2].reshape(q_n, d, 4))[..., None]
    cw_tl = _bit_masks(seg[3][:, 0], d).t()
    cw_tr = _bit_masks(seg[4][:, 0], d).t()
    rk_tree = _unpack_block_masks(seg[6].reshape(q_n, 3, 11, 4))  # (Q,3,11,8,16)
    rk = rk_tree.permute(0, 2, 3, 1, 4)[..., None].contiguous()
    return seeds, seg[1], cw_s, cw_tl, cw_tr, seg[5][:, 0], rk


def compat_skip_levels(num_bits: int, height: int) -> int:
    """Leading levels whose right subtree lies entirely outside [0, height):
    non-zero exactly when height <= 2^(num_bits-1), i.e. for power-of-two
    heights under the reference's log2(h)+1 domain rule (query.go:61)."""
    skip = 0
    while num_bits - skip > 1 and height <= (1 << (num_bits - skip - 1)):
        skip += 1
    return skip


def compat_stage_plan(device_bits: int, w: int = 128,
                      max_tail: int = 3) -> tuple[int, tuple[int, ...]]:
    """Cascade plan: (split, tails). The head walks `split` = 5 + log2(w)
    levels (ending at one chunk of `w` lane words); compat stage k then
    walks tails[k] <= max_tail levels. Needs device_bits > split."""
    split = 5 + int(np.log2(w))
    if 1 << (split - 5) != w:
        raise ValueError(f"lane width {w} is not a power of two")
    rem = device_bits - split
    if rem <= 0:
        raise ValueError(f"{device_bits} device levels leave no stage after the "
                         f"{split}-level head")
    tails = []
    while rem > 0:
        t = min(max_tail, rem)
        tails.append(t)
        rem -= t
    return split, tuple(tails)


@functools.lru_cache(maxsize=64)
def _compat_perm(device_bits: int, height: int, w: int,
                 tails: tuple[int, ...]) -> np.ndarray:
    """Natural row -> flat bit index for the compat stage cascade.

    Replays the storage order of the stacked-chunk walk: in-word bits =
    the first 5 levels (bit-reversed), lane word = head levels 6..split
    (concat order, latest level most significant), chunk index = the
    stages' branch bits appended MSB-first per stage.
    """
    split = 5 + int(np.log2(w))
    r = np.arange(height, dtype=np.int64)
    # rev bit (i-1) = branch at level i (MSB-first path bits of r)
    rev = np.zeros_like(r)
    for b in range(device_bits):
        rev |= ((r >> b) & 1) << (device_bits - 1 - b)
    bitpos = rev & 31
    word = (rev >> 5) & (w - 1)
    chunk = np.zeros_like(r)
    lvl = split
    for t in tails:
        b_bits = np.zeros_like(r)
        for jj in range(t):  # the stage's first level ends up most significant
            b_bits = (b_bits << 1) | ((rev >> (lvl + jj)) & 1)
        chunk = (chunk << t) | b_bits
        lvl += t
    if lvl != device_bits:
        raise ValueError(f"stages {tails} after a {split}-level head do not "
                         f"cover {device_bits} levels")
    return (chunk * w + word) * 32 + bitpos


def make_compat_payload_batch(
    shares, height: int | None = None
) -> tuple[np.ndarray, CompatRootLayout]:
    """Vectorised bit-packed payload builder for compat shares:
    (Q, layout.total) uint32. With `height`, dead leading levels are
    marked for the device's left-child skip (CompatRootLayout.skip); the
    payload itself is the same."""
    q_n = len(shares)
    k0 = shares[0].key_two_party
    num_bits = len(k0.cw)
    skip = compat_skip_levels(num_bits, height) if height else 0
    layout = CompatRootLayout(num_bits, 0, skip)

    payload = np.zeros((q_n, layout.total), dtype=np.uint32)
    offs = np.cumsum((0,) + layout.sizes)
    s_init = np.stack([np.frombuffer(s.key_two_party.s_init, np.uint8) for s in shares])
    payload[:, offs[0]:offs[1]] = _u32_view(s_init)
    payload[:, offs[1]] = np.array(
        [_FULL if s.key_two_party.t_init else 0 for s in shares], np.uint32)
    cw = np.stack([
        np.frombuffer(b"".join(s.key_two_party.cw), np.uint8).reshape(num_bits, 18)
        for s in shares
    ])
    payload[:, offs[2]:offs[3]] = _u32_view(
        np.ascontiguousarray(cw[:, :, :16])).reshape(q_n, num_bits * 4)
    lvl = np.arange(num_bits, dtype=np.uint32)
    payload[:, offs[3]] = ((cw[:, :, 16] & 1).astype(np.uint32) << lvl).sum(
        axis=1, dtype=np.uint32)
    payload[:, offs[4]] = ((cw[:, :, 17] & 1).astype(np.uint32) << lvl).sum(
        axis=1, dtype=np.uint32)
    payload[:, offs[5]] = np.array(
        [_FULL if (s.key_two_party.final_cw & 1) else 0 for s in shares], np.uint32)
    all_keys = np.stack([
        np.frombuffer(k.bytes, np.uint8) for s in shares for k in s.prf_keys[:3]
    ])
    rks = key_schedule_batch(all_keys).reshape(q_n, 3, 11, 16)
    payload[:, offs[6]:offs[7]] = _u32_view(np.ascontiguousarray(rks)).reshape(q_n, 132)
    return payload, layout


# Root-start expansion with the queries on a leading axis. Levels 0..4
# hold 2^i live nodes in the LOW BITS of one 32-bit word per plane; the
# doubling step is s' = (sL & lo) | ((sR & lo) << 2^i), children landing
# at +2^i within the word. From level 5 on the word axis doubles by
# concatenation. Leaf storage position is then bit_reverse(leaf, depth).
# Internally the planes are bit-first, (8, Q, 16, NW), so the shared
# _prf_triple / _children broadcast over the query axis.

def _rk_bit_first(rk: torch.Tensor) -> torch.Tensor:
    """Per-query round-key masks (Q,11,8,3,16,1) -> (11,8,3,Q,16,1)."""
    return rk.permute(1, 2, 3, 0, 4, 5)


def _expand_root_level(seeds, t_plane, cw_seed_mask, cw_tl, cw_tr, rk_masks, i: int):
    """One level for every query: seeds (8,Q,16,NW), t_plane (Q,NW),
    cw_seed_mask (8,Q,16,1), cw_tl / cw_tr (Q,1), rk_masks (11,8,3,Q,16,1)."""
    out = _prf_triple(seeds, rk_masks)
    s_l, t_l, s_r, t_r = _children(out, t_plane, cw_seed_mask, cw_tl, cw_tr)
    if i < 5:
        lo = (1 << (1 << i)) - 1
        shift = 1 << i
        return (s_l & lo) | ((s_r & lo) << shift), (t_l & lo) | ((t_r & lo) << shift)
    return torch.cat([s_l, s_r], dim=-1), torch.cat([t_l, t_r], dim=-1)


def expand_planes_from_root(seeds, t_plane, cw_seed_masks, cw_tl, cw_tr, rk_masks,
                            depth: int):
    """Root-start expansion of `depth` levels for Q queries at once:
    seeds (Q,8,16,1) with bit 0 = the root seed's bits, t_plane (Q,1),
    cw_seed_masks (Q,>=depth,8,16,1), cw_tl / cw_tr (Q,>=depth),
    rk_masks (Q,11,8,3,16,1) -> seeds (Q,8,16,NW), t (Q,NW) with
    NW = 2^max(0, depth-5)."""
    x = seeds.transpose(0, 1)
    rk = _rk_bit_first(rk_masks)
    for i in range(depth):
        x, t_plane = _expand_root_level(
            x, t_plane, cw_seed_masks[:, i].transpose(0, 1), cw_tl[:, i:i + 1],
            cw_tr[:, i:i + 1], rk, i)
    return x.transpose(0, 1), t_plane
