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

Single queries and small batches expand per query instead
(``make_device_key``, ``make_device_fast_key``, ``expand_query_bits``,
``fast_leaf_bits``; the per-query subset below): a host prefix, then
breadth-first device levels, then a gather into natural row order.

Keyword shares evaluate at each row's keyword instead of the whole
domain: the 2-party point walk (``eval_points_bits[_batch]``) follows
each point's own branch over packed branch-bit planes, and multi-party
shares run the sigma-slot PRG walk over the whole index domain
(``expand_mp_full_domain_bits``) or at arbitrary points
(``eval_points_mp_bits``); the last sections below.

Device tensors hold the bit pattern of the JAX package's uint32 words as
``torch.int32``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.bits import go_varint_vec
from .aes_host import key_schedule, key_schedule_batch, prf_blocks
from .bitslice import aes_encrypt_planes, blocks_to_planes, key_masks
from .host import Key2P, KeyMP, _leaf_blocks_wide, _mp_params

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


def u32_tensor(a, device=None) -> torch.Tensor:
    """A numpy uint32 array or scalar (a payload, a key array) -> its int32
    bit pattern as a tensor on `device`."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32)).to(device)


def _bit_reverse(x: np.ndarray, nbits: int) -> np.ndarray:
    """Each value's low `nbits` bits reversed (int64 arrays)."""
    rev = np.zeros_like(x)
    for b in range(nbits):
        rev |= ((x >> b) & 1) << (nbits - 1 - b)
    return rev


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


def expand_fast_root_lanes_full(payloads: torch.Tensor, layout: FastRootLayout,
                                rk_masks: torch.Tensor, rk_leaf: torch.Tensor) -> torch.Tensor:
    """The whole fast expansion, tree walk and leaf PRG, in plain torch
    with Q in lanes (pir_tpu's all-XLA expansion, ``all_xla_expand``):
    (Q, total) payloads of batch-shared keys, rk_masks (11,8,3,16,1) and
    rk_leaf (11,8,16,1) from payload row 0 -> (Q, 8, 16, NWf) packed
    leaf-output words, NWf = n_blk * max(1, 2^depth / 32), in the per-query
    tail kernel's output order (ops/fast_tail.py): every level and the leaf
    AES run on (8, 16, W*Q) planes, one permute at the end."""
    q_n = payloads.shape[0]
    seeds, t, cw_s, cw_tl, cw_tr, fcw = unpack_fast_root_payload_lanes(payloads, layout)
    for i in range(layout.depth):
        w = max(1, (1 << i) // 32)
        seeds, t = _expand_root_level_lanes(seeds, t, cw_s[i], cw_tl[i], cw_tr[i], rk_masks, i, w)
    nwf = max(1, (1 << layout.depth) // 32)
    if layout.leaf_blocks > 1:  # wide leaf: block-major lanes, blk*(NWf*Q) + word*Q + q
        n_blk = layout.leaf_blocks
        ctr = u32_tensor(_leaf_ctr_masks(n_blk), seeds.device)  # (8,n_blk,16,1)
        x = torch.cat([seeds ^ ctr[:, b] for b in range(n_blk)], dim=-1)
        del seeds
        fcw_t = fcw.permute(2, 1, 3, 0).repeat(1, 1, 1, nwf)  # (n_blk,8,16,NWf*Q)
        fcw_w = torch.cat(list(fcw_t), dim=-1)
        t = t.repeat(n_blk)
    else:
        x, fcw_w = seeds, fcw.permute(1, 2, 0).repeat(1, 1, nwf)  # (8,16,NWf*Q)
        n_blk = 1
    out = aes_encrypt_planes(x, rk_leaf)
    out ^= x
    del x
    fcw_w &= t
    out ^= fcw_w
    return out.reshape(8, 16, n_blk * nwf, q_n).permute(3, 0, 1, 2)


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


def shard_prefix_walk(seeds, t_plane, cws, rk_masks, shard: int, low_bit: bool):
    """Walk from the root down to the subtree of row shard `shard` of
    2^len(cws) (pir_tpu/parallel/mesh.py's static subtree-prefix walk):
    level l takes the right child when bit len(cws)-1-l of `shard` is set
    (MSB first, the tree's bit order). cws holds one (cw_seed_mask,
    cw_tl, cw_tr) a level, in the layout ``_children`` takes for these
    seeds. low_bit masks seeds and t back to lane bit 0 after each level,
    as the fast root steps do (the correction smears mask-word t bits
    into the upper lanes); the compat step keeps the upper lanes, which
    the first in-word level of ``expand_planes_from_root`` masks away."""
    levels = len(cws)
    for lvl, (cw_s, cw_tl, cw_tr) in enumerate(cws):
        s_l, t_l, s_r, t_r = _children(_prf_triple(seeds, rk_masks), t_plane, cw_s, cw_tl,
                                       cw_tr)
        seeds, t_plane = (s_r, t_r) if (shard >> (levels - 1 - lvl)) & 1 else (s_l, t_l)
        if low_bit:
            seeds, t_plane = seeds & 1, t_plane & 1
    return seeds, t_plane


def _walk_head_lanes(payloads: torch.Tensor, layout: FastRootLayout,
                     rk_masks: torch.Tensor, head_levels: int, shard=None):
    """Unpack with Q in lanes and walk the top `head_levels` levels ->
    seeds (8,16,NW0*Q) / t (NW0*Q,) word-major, and the unpacked cw_s
    (d,8,16,Q), cw_tl / cw_tr (d,Q), fcw. rk_masks is the (11,8,3,16,1)
    shared or (11,8,3,16,Q) per-query round-key masks. With shard =
    (index, levels) the walk first descends `levels` levels to that row
    shard's subtree (shard_prefix_walk), and the head and the returned
    correction words start below it."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw = unpack_fast_root_payload_lanes(payloads, layout)
    if shard is not None:
        index, levels = shard
        seeds, t = shard_prefix_walk(seeds, t, [(cw_s[i], cw_tl[i], cw_tr[i])
                                                for i in range(levels)],
                                     rk_masks, index, low_bit=True)
        cw_s, cw_tl, cw_tr = cw_s[levels:], cw_tl[levels:], cw_tr[levels:]
    for i in range(head_levels):
        w = max(1, (1 << i) // 32)
        seeds, t = _expand_root_level_lanes(
            seeds, t, cw_s[i], cw_tl[i], cw_tr[i], rk_masks, i, w)
    return seeds, t, cw_s, cw_tl, cw_tr, fcw


def expand_root_head_grouped(payloads: torch.Tensor, layout: FastRootLayout,
                             rk_masks: torch.Tensor, head_levels: int, k: int, shard=None):
    """Root head walk with Q in lanes, regrouped for the stacked tail
    kernel (regroup_head_stacked). rk_masks is the head's (11,8,3,16,1)
    shared or (11,8,3,16,Q) per-query round-key masks; shard as in
    _walk_head_lanes."""
    seeds, t, cw_s, cw_tl, cw_tr, fcw = _walk_head_lanes(payloads, layout, rk_masks,
                                                         head_levels, shard)
    nw0 = max(1, (1 << head_levels) // 32)
    return regroup_head_stacked(
        seeds, t, cw_s[head_levels:], cw_tl[head_levels:],
        cw_tr[head_levels:], fcw, k, nw0, layout.leaf_blocks)


def expand_root_head_lanes(payloads: torch.Tensor, layout: FastRootLayout,
                           rk_masks: torch.Tensor, head_levels: int, shard=None):
    """Root head walk with Q in lanes, returning the per-query tail
    kernel's operands (ops/fast_tail.py): seeds (Q,8,16,NW0), t (Q,1,NW0),
    cw_s (Q,tail,8,16,1), cw_tl / cw_tr (Q,tail), fcw (Q,8,16,1) or
    (Q,8,n_blk,16,1), with NW0 = max(1, 2^head_levels // 32) and tail =
    depth - head_levels (less the shard levels, with shard as in
    _walk_head_lanes). rk_masks is the (11,8,3,16,1) batch-shared or
    the (11,8,3,16,Q) per-query round-key masks: the same walk serves
    distinct-key batches, batched over Q."""
    q_n = payloads.shape[0]
    seeds, t, cw_s, cw_tl, cw_tr, fcw = _walk_head_lanes(payloads, layout, rk_masks,
                                                         head_levels, shard)
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
    return ((bit_k * 16 + byte_i) * n_blk + blk) * (1 << depth) + _bit_reverse(leaf, depth)


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
    c = leaf & ((1 << tail) - 1)
    return (((bit_k << tail) * n_blk + c * n_blk + blk) * 16
            + byte_i) * (1 << head) + _bit_reverse(leaf >> tail, head)


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


@functools.lru_cache(maxsize=64)
def _compat_leaf_perm_root(num_bits: int, height: int) -> np.ndarray:
    """Natural row -> flat bit index (= bit_reverse(row)) for the compat
    preplane route: the order ``expand_planes_from_root`` leaves the
    leaves of `num_bits` device levels in."""
    return _bit_reverse(np.arange(height, dtype=np.int64), num_bits)


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
    # rev bit (i-1) = branch at level i (MSB-first path bits of the row)
    rev = _bit_reverse(np.arange(height, dtype=np.int64), device_bits)
    bitpos = rev & 31
    word = (rev >> 5) & (w - 1)
    chunk = np.zeros_like(rev)
    lvl = split
    for t in tails:
        b_bits = np.zeros_like(rev)
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


# --------------------------------------------------------------------------
# Per-query expansion: single queries and small batches
# --------------------------------------------------------------------------
# (counterpart of pir_tpu/dpf/device.py:84-296, :300-562 and :1222-1277)
# The first levels run on the host (exact numpy AES, natural node order,
# pruned to the nodes whose subtree meets [0, height)) until
# min_device_nodes (32 by default) nodes are live; the device walks the
# rest breadth first, concatenating [left children | right children] each
# level, and a gather with the plan's permutation restores natural row
# order at the leaf stage. Key material is built on the host as numpy
# uint32 arrays (the JAX package's arrays, value for value) and reaches
# the device as one payload row.

def _leaf_select_bits(seeds: torch.Tensor, t_plane: torch.Tensor,
                      fcw_mask: torch.Tensor) -> torch.Tensor:
    """Packed PIR selection bits, bit = (leaf value % 2 == 0): seeds
    (8,16,NW) or (8,Q,16,NW) -> (NW,) or (Q,NW) words.

    Varint parity = (byte0.bit1 ^ byte0.bit0) unless all 8 continuation
    bits are set (value 0); the final value's parity adds t * (FinalCW & 1).
    """
    allcont = seeds[7, ..., 0, :]
    for i in range(1, 8):
        allcont = allcont & seeds[7, ..., i, :]
    parity_s = (seeds[0, ..., 0, :] ^ seeds[1, ..., 0, :]) & ~allcont
    return ~(parity_s ^ (t_plane & fcw_mask))  # inverted convention (db.go:142)


def _unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., NW) words -> (..., 32 * NW) uint8 bits {0,1}, LSB first."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1).to(torch.uint8)


@dataclass(frozen=True)
class ExpandPlan:
    """Geometry of a pruned breadth-first expansion."""

    num_bits: int
    height: int
    host_levels: int  # levels expanded on the host (natural order)
    m_nodes: int  # live nodes at host_levels
    m_padded: int  # padded to a multiple of 32
    device_levels: int


def make_plan(num_bits: int, height: int, min_device_nodes: int = 32) -> ExpandPlan:
    lvl = 0
    m = 1
    while lvl < num_bits and m < min_device_nodes:
        lvl += 1
        m = -(-height // (1 << (num_bits - lvl)))  # ceil: live nodes at lvl
    m_padded = -(-m // 32) * 32 if lvl < num_bits else m
    return ExpandPlan(num_bits, height, lvl, m, m_padded, num_bits - lvl)


@functools.lru_cache(maxsize=64)
def _leaf_perm(num_bits: int, height: int, min_device_nodes: int = 32) -> np.ndarray:
    """Gather indices: natural row -> storage position."""
    plan = make_plan(num_bits, height, min_device_nodes)
    d = plan.device_levels
    x = np.arange(height, dtype=np.int64)
    return _bit_reverse(x & ((1 << d) - 1), d) * plan.m_padded + (x >> d)


def _host_prefix(server, key, plan: ExpandPlan):
    """Expand levels [0, host_levels) on the host, pruned, natural order:
    -> (m_nodes, 16) uint8 seeds and (m_nodes,) t bits."""
    seeds = np.frombuffer(key.s_init, dtype=np.uint8)[None, :].copy()
    t_bits = np.array([key.t_init], dtype=np.uint8)
    nb = plan.num_bits
    for i in range(plan.host_levels):
        flat = prf_blocks(seeds, server.ciphers, 3).reshape(seeds.shape[0], 48)
        cw_i = key.cw[i]
        cw_seed = np.frombuffer(cw_i[:16], dtype=np.uint8)
        t_mask = t_bits[:, None]
        s_l = flat[:, 0:16] ^ cw_seed[None, :] * t_mask
        s_r = flat[:, 17:33] ^ cw_seed[None, :] * t_mask
        t_l = (flat[:, 16] & 1) ^ (t_bits & cw_i[16])
        t_r = (flat[:, 33] & 1) ^ (t_bits & cw_i[17])
        # interleave children -> natural order, then keep the live ones
        live = -(-plan.height // (1 << (nb - i - 1)))
        seeds = np.stack([s_l, s_r], axis=1).reshape(-1, 16)[:live]
        t_bits = np.stack([t_l, t_r], axis=1).reshape(-1).astype(np.uint8)[:live]
    return seeds, t_bits


@dataclass
class DeviceKey2P:
    """Device-ready arrays (numpy uint32) for one server's compat share."""

    plan: ExpandPlan
    seeds0: np.ndarray | None  # (8, 16, NW0) packed level-`host_levels` seeds
    t0: np.ndarray | None  # (NW0,) packed t bits
    cw_seed_masks: np.ndarray | None  # (d, 8, 16, 1)
    cw_tl: np.ndarray | None  # (d,)
    cw_tr: np.ndarray | None  # (d,)
    rk_masks: np.ndarray | None  # (11, 8, 3, 16, 1)
    fcw_mask: np.uint32 | None
    perm: np.ndarray | None  # (height,) natural -> storage gather
    host_bits: np.ndarray | None  # (height,) uint8, when device_levels == 0


def _pack_t(t_bits: np.ndarray, m_padded: int) -> np.ndarray:
    padded = np.zeros(m_padded, dtype=np.uint32)
    padded[: len(t_bits)] = t_bits
    w = padded.reshape(-1, 32)
    return (w << np.arange(32, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)


def _block_masks(block: bytes) -> np.ndarray:
    """16-byte block -> (8, 16, 1) full-word bit masks."""
    return _block_masks_wide(block)[:, 0]


def _block_masks_wide(block: bytes) -> np.ndarray:
    """16*n-byte wide final CW -> (8, n, 16, 1) full-word bit masks."""
    b = np.frombuffer(block, dtype=np.uint8).reshape(-1, 16)
    bits = (b[None] >> np.arange(8, dtype=np.uint8)[:, None, None]) & 1
    return (bits.astype(np.uint32) * _FULL)[..., None]


def _cw_masks_list(cws: list[bytes]):
    """Correction words -> (d, 8, 16, 1) seed masks, (d,) tL and tR masks."""
    d = len(cws)
    seed_masks = np.zeros((d, 8, 16, 1), dtype=np.uint32)
    tl = np.zeros(d, dtype=np.uint32)
    tr = np.zeros(d, dtype=np.uint32)
    for i, cw in enumerate(cws):
        seed_masks[i] = _block_masks(cw[:16])
        tl[i] = _FULL if cw[16] & 1 else 0
        tr[i] = _FULL if cw[17] & 1 else 0
    return seed_masks, tl, tr


def prf_key_masks(server) -> np.ndarray:
    """(11, 8, 3, 16, 1) round-key masks for the first 3 fixed PRF keys."""
    rks = np.stack([key_schedule(c.key) for c in server.ciphers[:3]])
    m = key_masks(rks)  # (11, 8, 16, 3)
    return np.ascontiguousarray(m.transpose(0, 1, 3, 2))[..., None]


def make_device_key(server, key, height: int, min_device_nodes: int = 32) -> DeviceKey2P:
    """Host prefix + device arrays of a compat share (`server` a
    ``dpf.host.Dpf`` over the table's num_bits). Tiny domains, whose every
    level runs on the host, carry their selection bits in ``host_bits``."""
    plan = make_plan(server.num_bits, height, min_device_nodes)
    seeds, t_bits = _host_prefix(server, key, plan)

    if plan.device_levels == 0:
        vals = go_varint_vec(np.ascontiguousarray(seeds[:, :8])) + t_bits.astype(
            np.int64) * key.final_cw
        host_bits = ((vals & 1) == 0)[:height].astype(np.uint8)
        return DeviceKey2P(plan, None, None, None, None, None, None, None, None, host_bits)

    pad = plan.m_padded - seeds.shape[0]
    if pad:
        seeds = np.concatenate([seeds, np.zeros((pad, 16), dtype=np.uint8)])
        t_bits = np.concatenate([t_bits, np.zeros(pad, dtype=np.uint8)])
    cw_seed_masks, tl, tr = _cw_masks_list(key.cw[plan.host_levels:])
    return DeviceKey2P(
        plan=plan,
        seeds0=blocks_to_planes(seeds),
        t0=_pack_t(t_bits, plan.m_padded),
        cw_seed_masks=cw_seed_masks,
        cw_tl=tl,
        cw_tr=tr,
        rk_masks=prf_key_masks(server),
        fcw_mask=np.uint32(_FULL if (key.final_cw & 1) else 0),
        perm=_leaf_perm(plan.num_bits, height, min_device_nodes),
        host_bits=None,
    )


def _level_step(seeds, t_plane, cw_seed_mask, cw_tl, cw_tr, rk_masks):
    """One breadth-first doubling level: (8,16,NW) -> (8,16,2NW), or with
    queries on the second axis (8,Q,16,NW) -> (8,Q,16,2NW) (cw_seed_mask
    (8,Q,16,1), cw_tl / cw_tr (Q,1), rk_masks (11,8,3,Q,16,1))."""
    out = _prf_triple(seeds, rk_masks)
    s_l, t_l, s_r, t_r = _children(out, t_plane, cw_seed_mask, cw_tl, cw_tr)
    return torch.cat([s_l, s_r], dim=-1), torch.cat([t_l, t_r], dim=-1)


def _leaf_stage(seeds, t_plane, fcw_mask, perm: torch.Tensor) -> torch.Tensor:
    """Leaf selection bits, gathered into natural row order by the int64
    `perm` (on the seeds' device): -> (rows,) or (Q, rows) uint8."""
    return _unpack_bits(_leaf_select_bits(seeds, t_plane, fcw_mask))[..., perm]


def expand_query_bits(dkey: DeviceKey2P, device=None,
                      perm: torch.Tensor | None = None) -> torch.Tensor:
    """(height,) uint8 selection bits, natural row order, on `device`.
    `perm` is the leaf permutation already on the device (servers cache
    one per geometry); by default dkey.perm is uploaded."""
    if dkey.host_bits is not None:
        return torch.from_numpy(dkey.host_bits).to(device)
    seeds, t_plane = u32_tensor(dkey.seeds0, device), u32_tensor(dkey.t0, device)
    cw_s, cw_tl, cw_tr, rk = (u32_tensor(a, device) for a in (
        dkey.cw_seed_masks, dkey.cw_tl, dkey.cw_tr, dkey.rk_masks))
    for i in range(dkey.plan.device_levels):
        seeds, t_plane = _level_step(seeds, t_plane, cw_s[i], cw_tl[i], cw_tr[i], rk)
    if perm is None:
        perm = torch.from_numpy(dkey.perm).to(device)
    return _leaf_stage(seeds, t_plane, u32_tensor(dkey.fcw_mask, device), perm)


@dataclass
class DeviceFastKey2P:
    """Device-ready arrays (numpy uint32) for a fast-mode share."""

    plan: ExpandPlan  # over *leaves* (each leaf = leaf_bits rows)
    height: int
    seeds0: np.ndarray | None
    t0: np.ndarray | None
    cw_seed_masks: np.ndarray | None
    cw_tl: np.ndarray | None
    cw_tr: np.ndarray | None
    fcw_masks: np.ndarray | None  # (8, 16, 1), or (8, n_blk, 16, 1) for wide leaves
    rk_masks: np.ndarray | None  # (11, 8, 3, 16, 1) tree PRF keys
    rk_leaf: np.ndarray | None  # (11, 8, 16, 1) output-layer PRF key (key 3)
    perm: np.ndarray | None  # (height,) natural row -> flat bit position
    host_bits: np.ndarray | None


@functools.lru_cache(maxsize=64)
def _fast_leaf_perm(depth: int, height: int, m_padded: int, n_blk: int = 1) -> np.ndarray:
    """Natural row -> flat index into the unpacked (8,16,[n_blk,]NW*32)
    bit tensor (n_blk > 1: wide leaves, block-major lanes; see
    fast_leaf_bits_flat)."""
    nw32 = (m_padded << depth) if depth else m_padded
    r = np.arange(height, dtype=np.int64)
    leaf = r // (128 * n_blk)
    within = r % (128 * n_blk)
    blk = within >> 7
    wb = within & 127
    pos = _bit_reverse(leaf & ((1 << depth) - 1), depth) * m_padded + (leaf >> depth)
    return (((wb & 7) * 16 + (wb >> 3)) * n_blk + blk) * nw32 + pos


def make_device_fast_key(server, fkey, min_device_nodes: int = 32) -> DeviceFastKey2P:
    """Host prefix + device arrays of a fast share. A tree of fewer than
    `min_device_nodes` leaves (depth < 5 at the default) runs wholly on
    the host and carries its selection bits in ``host_bits``."""
    n_blk = fkey.leaf_bits // 128
    n_leaves = -(-fkey.height // fkey.leaf_bits)
    plan = make_plan(fkey.depth, n_leaves, min_device_nodes)

    # host prefix over the (depth, n_leaves) tree
    tree_key = Key2P(fkey.s_init, fkey.t_init, fkey.cw, 0)
    saved = server.num_bits
    server.num_bits = fkey.depth
    try:
        seeds, t_bits = _host_prefix(server, tree_key, plan)
    finally:
        server.num_bits = saved

    if plan.device_levels == 0 and plan.host_levels == fkey.depth:
        blocks = _leaf_blocks_wide(server, seeds, n_blk)
        fcw = np.frombuffer(fkey.final_cw_block, dtype=np.uint8)
        blocks = blocks ^ fcw[None, :] * t_bits[:, None]
        bits = np.unpackbits(blocks, axis=1, bitorder="little").reshape(-1)
        return DeviceFastKey2P(plan, fkey.height, None, None, None, None, None, None, None,
                               None, None, bits[: fkey.height].astype(np.uint8))

    pad = plan.m_padded - seeds.shape[0]
    if pad:
        seeds = np.concatenate([seeds, np.zeros((pad, 16), dtype=np.uint8)])
        t_bits = np.concatenate([t_bits, np.zeros(pad, dtype=np.uint8)])
    cw_seed_masks, tl, tr = _cw_masks_list(fkey.cw[plan.host_levels:])
    return DeviceFastKey2P(
        plan=plan,
        height=fkey.height,
        seeds0=blocks_to_planes(seeds),
        t0=_pack_t(t_bits, plan.m_padded),
        cw_seed_masks=cw_seed_masks,
        cw_tl=tl,
        cw_tr=tr,
        fcw_masks=(_block_masks(fkey.final_cw_block) if n_blk == 1
                   else _block_masks_wide(fkey.final_cw_block)),
        rk_masks=prf_key_masks(server),
        rk_leaf=key_masks(key_schedule(server.ciphers[3].key)[None]),  # (11,8,16,1)
        perm=_fast_leaf_perm(plan.device_levels, fkey.height, plan.m_padded, n_blk),
        host_bits=None,
    )


def fast_leaf_bits_flat_batch(seeds, t_plane, fcw_masks, rk_leaf) -> torch.Tensor:
    """Leaf stage of Q queries without reordering: seeds (8,Q,16,NW), t
    (Q,NW), fcw_masks (Q,8,16,1) or (Q,8,n_blk,16,1), rk_leaf
    (Q,11,8,16,1) -> (Q, flat) uint8 bits, each row fast_leaf_bits_flat's."""
    rkl = rk_leaf.permute(1, 2, 0, 3, 4)  # (11, 8, Q, 16, 1)
    f = fcw_masks.transpose(0, 1)  # (8, Q, 16, 1) or (8, Q, n_blk, 16, 1)
    if f.dim() == 5:  # wide leaf
        n_blk = f.shape[2]
        nw = seeds.shape[-1]
        ctr = u32_tensor(_leaf_ctr_masks(n_blk), seeds.device)
        x = torch.cat([seeds ^ ctr[:, b, None] for b in range(n_blk)], dim=-1)
        tt = t_plane.repeat(1, n_blk)
        fcw = torch.cat([f[:, :, b].expand(-1, -1, -1, nw) for b in range(n_blk)], dim=-1)
    else:
        x, tt, fcw = seeds, t_plane, f
    out = (aes_encrypt_planes(x, rkl) ^ x) ^ (tt[None, :, None, :] & fcw)
    return _unpack_bits(out).transpose(0, 1).reshape(seeds.shape[1], -1)


def fast_leaf_bits_flat(seeds, t_plane, fcw_masks, rk_leaf) -> torch.Tensor:
    """Leaf stage without reordering: seeds (8,16,NW) -> flat uint8 bits.

    128-bit leaves (fcw_masks (8,16,1)): index (bit*16 + byte)*NW*32 +
    leafpos. Wide leaves (fcw_masks (8,n_blk,16,1)): each leaf seed
    CTR-extends into n_blk MMO blocks, block-major along lanes (one
    bitsliced AES over an (8, 16, n_blk*NW) state); index ((bit*16 +
    byte)*n_blk + blk)*NW*32 + leafpos, as _fast_leaf_perm expects."""
    return fast_leaf_bits_flat_batch(seeds[:, None], t_plane[None], fcw_masks[None],
                                     rk_leaf[None])[0]


def fast_leaf_bits(seeds, t_plane, fcw_masks, rk_leaf, perm: torch.Tensor) -> torch.Tensor:
    """Leaf stage: seeds (8,16,NW) -> (height,) uint8 natural-order bits."""
    return fast_leaf_bits_flat(seeds, t_plane, fcw_masks, rk_leaf)[perm]


# Packed key payloads: one upload a query. Every array of a device key,
# flattened into one uint32 row and sliced apart on the device.

@dataclass(frozen=True)
class PayloadLayout:
    nw0: int
    d_levels: int
    height: int

    @property
    def sizes(self):
        nw0, d = self.nw0, self.d_levels
        return (8 * 16 * nw0, nw0, d * 128, d, d, 1, 11 * 8 * 16 * 3)

    @property
    def total(self):
        return sum(self.sizes)


def _concat_u32(parts) -> np.ndarray:
    return np.concatenate([np.asarray(p, dtype=np.uint32).ravel() for p in parts])


def pack_key_payload(dkey: DeviceKey2P) -> tuple[np.ndarray, PayloadLayout]:
    plan = dkey.plan
    layout = PayloadLayout(plan.m_padded // 32, plan.device_levels, plan.height)
    payload = _concat_u32([dkey.seeds0, dkey.t0, dkey.cw_seed_masks, dkey.cw_tl, dkey.cw_tr,
                           dkey.fcw_mask, dkey.rk_masks])
    assert payload.shape[0] == layout.total
    return payload, layout


def _segments(payload: torch.Tensor, sizes) -> list[torch.Tensor]:
    offs = np.cumsum((0,) + tuple(sizes))
    return [payload[..., offs[i]:offs[i + 1]] for i in range(len(sizes))]


def unpack_key_payload(payload: torch.Tensor, layout: PayloadLayout):
    """Device-side inverse of pack_key_payload: payload (total,) or (Q,
    total) int32 -> seeds (8,16,NW0), t (NW0,), cw_s (d,8,16,1), cw_tl /
    cw_tr (d,), fcw (), rk (11,8,3,16,1), each with the leading Q axis
    of a batch of payload rows."""
    nw0, d = layout.nw0, layout.d_levels
    lead = payload.shape[:-1]
    seg = _segments(payload, layout.sizes)
    return (
        seg[0].reshape(*lead, 8, 16, nw0),
        seg[1],
        seg[2].reshape(*lead, d, 8, 16, 1),
        seg[3],
        seg[4],
        seg[5][..., 0],
        seg[6].reshape(*lead, 11, 8, 3, 16, 1),
    )


def make_key_payload(server, key, height: int, min_device_nodes: int = 32):
    """Host keygen-to-payload shortcut: (payload, layout), or (the host-bits
    DeviceKey2P, None) for tiny domains."""
    dkey = make_device_key(server, key, height, min_device_nodes)
    if dkey.host_bits is not None:
        return dkey, None
    return pack_key_payload(dkey)


@dataclass(frozen=True)
class FastPayloadLayout:
    nw0: int
    d_levels: int
    height: int
    leaf_blocks: int = 1  # wide leaves: fcw masks are (8, n_blk, 16, 1)

    @property
    def sizes(self):
        nw0, d = self.nw0, self.d_levels
        return (128 * nw0, nw0, d * 128, d, d, 128 * self.leaf_blocks,
                11 * 8 * 3 * 16, 11 * 8 * 16)

    @property
    def total(self):
        return sum(self.sizes)


def pack_fast_payload(dk: DeviceFastKey2P) -> tuple[np.ndarray, FastPayloadLayout]:
    n_blk = dk.fcw_masks.shape[1] if dk.fcw_masks.ndim == 4 else 1
    layout = FastPayloadLayout(dk.plan.m_padded // 32, dk.plan.device_levels, dk.height, n_blk)
    payload = _concat_u32([dk.seeds0, dk.t0, dk.cw_seed_masks, dk.cw_tl, dk.cw_tr,
                           dk.fcw_masks, dk.rk_masks, dk.rk_leaf])
    assert payload.shape[0] == layout.total
    return payload, layout


def unpack_fast_payload(payload: torch.Tensor, layout: FastPayloadLayout):
    """Device-side inverse of pack_fast_payload: (total,) int32 -> seeds
    (8,16,NW0), t (NW0,), cw_s (d,8,16,1), cw_tl / cw_tr (d,), fcw
    (8,16,1) or (8,n_blk,16,1), rk (11,8,3,16,1), rk_leaf (11,8,16,1),
    each with the leading Q axis of a batch of payload rows (Q, total)."""
    nw0, d = layout.nw0, layout.d_levels
    lead = payload.shape[:-1]
    seg = _segments(payload, layout.sizes)
    fcw = (seg[5].reshape(*lead, 8, 16, 1) if layout.leaf_blocks == 1
           else seg[5].reshape(*lead, 8, layout.leaf_blocks, 16, 1))
    return (seg[0].reshape(*lead, 8, 16, nw0), seg[1], seg[2].reshape(*lead, d, 8, 16, 1),
            seg[3], seg[4], fcw, seg[6].reshape(*lead, 11, 8, 3, 16, 1),
            seg[7].reshape(*lead, 11, 8, 16, 1))


# --------------------------------------------------------------------------
# 2-party point evaluation: keyword queries (db.go:119-135)
# --------------------------------------------------------------------------
# (counterpart of pir_tpu/dpf/device.py:1280-1421) Every point walks the
# 32-level tree on its own branch: 32 points a lane word, the branch bit
# of level i of each point packed in plane i, so one bitsliced MMO step
# per level serves 32 * NW points. The JAX package vmaps a whole batch;
# here queries walk in chunks of POINT_EVAL_CHUNK, which bounds the live
# planes (about 0.4 GiB a query at NW = 32768, 2^20 keywords).

POINT_EVAL_CHUNK = 8


def _pack_bits_u32(bits: np.ndarray) -> np.ndarray:
    """(..., 32 * nw) {0, 1} -> (..., nw) uint32, bit j of word w =
    element 32w + j."""
    packed = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32, copy=False)


def pack_point_bit_planes(points: np.ndarray, num_bits: int) -> np.ndarray:
    """(num_bits, NW) uint32 branch-bit planes: level i's plane holds,
    packed, bit ``num_bits - 1 - i`` of each point, MSB first over the
    num_bits-bit domain (dpf/server.go:63-66)."""
    n = len(points)
    nw = -(-n // 32)
    padded = np.zeros(nw * 32, dtype=np.uint64)
    padded[:n] = np.asarray(points).astype(np.uint64)
    return np.stack([_pack_bits_u32((padded >> np.uint64(num_bits - 1 - i)) & np.uint64(1))
                     for i in range(num_bits)])


@dataclass
class DevicePointKey2P:
    """Device-ready arrays (numpy uint32) of one 2-party point-eval share."""

    num_bits: int
    s_init_masks: np.ndarray  # (8, 16, 1) root seed masks
    t_init_mask: np.uint32
    cw_seed_masks: np.ndarray  # (num_bits, 8, 16, 1)
    cw_tl: np.ndarray  # (num_bits,)
    cw_tr: np.ndarray
    rk_masks: np.ndarray  # (11, 8, 3, 16, 1)
    fcw_mask: np.uint32


def make_device_point_key(server, key: Key2P) -> DevicePointKey2P:
    """The point-eval arrays of a reference-exact key (`server` a
    ``dpf.host.Dpf`` over the 32-bit keyword domain)."""
    cw_seed_masks, tl, tr = _cw_masks_list(key.cw)
    return DevicePointKey2P(
        num_bits=server.num_bits,
        s_init_masks=_block_masks(key.s_init),
        t_init_mask=np.uint32(_FULL if key.t_init else 0),
        cw_seed_masks=cw_seed_masks,
        cw_tl=tl,
        cw_tr=tr,
        rk_masks=prf_key_masks(server),
        fcw_mask=np.uint32(_FULL if (key.final_cw & 1) else 0),
    )


def point_eval_packed_core(s_masks, t_mask, cw_seed_masks, cw_tl, cw_tr, rk_masks, fcw_mask,
                           xbits, num_bits: int) -> torch.Tensor:
    """The 2-party point walk of Q shares over packed branch-bit planes
    (dpf/server.go:55-101, the inverted parity included): s_masks
    (Q,8,16,1), t_mask (Q,), cw_seed_masks (Q,>=num_bits,8,16,1), cw_tl /
    cw_tr (Q,>=num_bits), rk_masks (Q,11,8,3,16,1), fcw_mask (Q,), xbits
    (num_bits, NW) -> (Q, NW) packed selection words, 32 points a word.
    A pure function of its tensors: the mesh's keyword step
    (parallel/mesh.py) calls it on a shard's slice of the planes."""
    seeds = s_masks.transpose(0, 1)  # (8, Q, 16, 1): lanes broadcast at level 0
    t_plane = t_mask[:, None]
    rk = _rk_bit_first(rk_masks)
    for i in range(num_bits):
        out = _prf_triple(seeds, rk)
        s_l, t_l, s_r, t_r = _children(out, t_plane, cw_seed_masks[:, i].transpose(0, 1),
                                       cw_tl[:, i:i + 1], cw_tr[:, i:i + 1])
        xb = xbits[i]
        seeds = s_l ^ ((s_l ^ s_r) & xb)
        t_plane = t_l ^ ((t_l ^ t_r) & xb)
    return _leaf_select_bits(seeds, t_plane, fcw_mask[:, None])


def point_eval_operands(dkeys: list[DevicePointKey2P], xbit_planes: torch.Tensor) -> list:
    """The Q keys' operands of point_eval_packed_core, stacked and
    uploaded to the device of `xbit_planes`. All keys share num_bits
    (32 for keyword shares), and the planes have as many rows."""
    nb = dkeys[0].num_bits
    if any(k.num_bits != nb for k in dkeys) or xbit_planes.shape[0] != nb:
        raise ValueError("point-eval keys and planes must share one domain")
    return [u32_tensor(np.stack([np.asarray(getattr(k, a)) for k in dkeys]), xbit_planes.device)
            for a in ("s_init_masks", "t_init_mask", "cw_seed_masks", "cw_tl", "cw_tr",
                      "rk_masks", "fcw_mask")]


def eval_point_operands_bits(ops: list, xbit_planes: torch.Tensor,
                             n_points: int) -> torch.Tensor:
    """(Q, n_points) uint8 selection bits from point_eval_operands, in
    chunks of POINT_EVAL_CHUNK queries."""
    out = torch.empty((ops[0].shape[0], n_points), dtype=torch.uint8, device=xbit_planes.device)
    c = POINT_EVAL_CHUNK
    for q0 in range(0, out.shape[0], c):
        packed = point_eval_packed_core(*(x[q0:q0 + c] for x in ops), xbit_planes,
                                        xbit_planes.shape[0])
        out[q0:q0 + c] = _unpack_bits(packed)[:, :n_points]
    return out


def eval_points_bits_batch(dkeys: list[DevicePointKey2P], xbit_planes: torch.Tensor,
                           n_points: int) -> torch.Tensor:
    """(Q, n_points) uint8 selection bits of Q point-eval shares at the
    points of `xbit_planes` (pack_point_bit_planes as an int32 tensor, on
    the device the walk runs on): upload, then the walk."""
    return eval_point_operands_bits(point_eval_operands(dkeys, xbit_planes), xbit_planes,
                                    n_points)


def eval_points_bits(dkey: DevicePointKey2P, xbit_planes: torch.Tensor,
                     n_points: int) -> torch.Tensor:
    """(n_points,) uint8 selection bits of one point-eval share."""
    return eval_points_bits_batch([dkey], xbit_planes, n_points)[0]


# --------------------------------------------------------------------------
# Multi-party (>= 3 server) evaluation
# --------------------------------------------------------------------------
# (counterpart of pir_tpu/dpf/device.py:1423-1665) The sigma-slot PRG walk
# of dpf/server.go:110-144, as completed by host.generate_multi_server.
# Only the parity of each mu-word is needed: bit 0 of u32 word delta is
# bit plane 0 of byte 4 * (delta % 4) of PRG block delta // 4, so each AES
# block gives 4 selection-bit planes.

MP_CHUNK_WORDS = 1 << 22  # plane words of AES input a chunk of PRG blocks


def _pack_lane_mask(flags: np.ndarray, nw: int) -> np.ndarray:
    """(n,) bool -> (nw,) uint32 with bit j of word w = flags[32w + j]."""
    padded = np.zeros(nw * 32, dtype=bool)
    padded[: len(flags)] = flags
    return _pack_bits_u32(padded)


def _mp_fixed_rk4(server) -> list[np.ndarray]:
    """Bitsliced round-key masks of the four fixed PRG keys (prf_blocks:
    block b uses ciphers[b % 4]); each (11, 8, 16, 1)."""
    return [key_masks(key_schedule(server.ciphers[i].key)[None])[..., 0][..., None]
            for i in range(4)]


def _ctr_block_masks(blocks: np.ndarray) -> np.ndarray:
    """(n,) PRG block numbers -> (n, 8, 16) full-word masks of their
    counter LE64(b // 4) in bytes 0..7 (aes_host.prf_blocks)."""
    ctr = np.zeros((len(blocks), 16), dtype=np.uint8)
    ctr[:, :8] = (np.asarray(blocks, dtype=np.int64) // 4).astype("<u8").view(
        np.uint8).reshape(-1, 8)
    bits = (ctr[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return bits.astype(np.uint32) * _FULL


def expand_mp_full_domain_bits(server, key: KeyMP, height: int, device=None) -> torch.Tensor:
    """(height,) uint8 selection-bit share of a multi-party index key over
    rows [0, height), equal to ``(host.eval_points_mp(...) & 1) == 1``
    (the XOR-share convention of server.expand_shared_query). Row x =
    gamma * 2^delta_bits + delta; the gamma rows lie in lanes, the p2
    seed slots on a small axis, and the PRG blocks walk in chunks of
    about MP_CHUNK_WORDS plane words."""
    p2, mu, gamma_bits, delta_bits = _mp_params(server.num_bits, key.num_parties)
    n_gamma = 1 << gamma_bits
    seeds = np.frombuffer(b"".join(key.sigma), dtype=np.uint8).reshape(n_gamma, p2, 16)
    seed_planes = np.stack([blocks_to_planes(np.ascontiguousarray(seeds[:, i]))
                            for i in range(p2)], axis=1)  # (8, p2, 16, NWg)
    nwg = seed_planes.shape[-1]
    # zero seeds skip G and CW (dpf/server.go:127-136)
    present = np.stack([_pack_lane_mask(seeds[:, i].any(axis=1), nwg) for i in range(p2)])
    num_blocks = -(-server.m * mu // 16)
    blocks = np.arange(num_blocks)
    rk4 = np.stack(_mp_fixed_rk4(server))  # (4, 11, 8, 16, 1)
    cw_bits = np.zeros((p2, num_blocks * 4), dtype=np.uint32)
    for i in range(p2):
        cw_bits[i, :mu] = np.asarray(key.cw[i][:mu], dtype=np.uint32) & 1
    cw_par = (cw_bits * _FULL).reshape(p2, num_blocks, 4).transpose(1, 0, 2)  # (nbk, p2, 4)

    x0 = u32_tensor(seed_planes, device)[:, None]  # (8, 1, p2, 16, NWg)
    present_t = u32_tensor(present, device)[None, :, None, :]  # (1, p2, 1, NWg)
    step = max(1, MP_CHUNK_WORDS // (8 * p2 * 16 * nwg))
    ys = []
    for b0 in range(0, num_blocks, step):
        blk = blocks[b0:b0 + step]
        ctr = u32_tensor(_ctr_block_masks(blk), device)  # (n, 8, 16)
        x = x0 ^ ctr.permute(1, 0, 2)[:, :, None, :, None]  # (8, n, p2, 16, NWg)
        rk = u32_tensor(rk4[blk % 4], device).permute(1, 2, 0, 3, 4)[:, :, :, None]
        out = aes_encrypt_planes(x, rk) ^ x  # MMO (dpf/common.go:60-75)
        par = out[0][:, :, 0:16:4, :]  # (n, p2, 4, NWg): bit 0 of bytes 0, 4, 8, 12
        cwp = u32_tensor(np.ascontiguousarray(cw_par[blk]), device)[..., None]
        contrib = present_t & (par ^ cwp)
        y = contrib[:, 0]
        for i in range(1, p2):
            y = y ^ contrib[:, i]
        ys.append(y.reshape(-1, nwg))  # (4n, NWg): parity words of deltas 4*b0 ..
    y = torch.cat(ys)  # (mu_pad, NWg)
    # the bit of gamma 32w + j and delta d is bit j of y[d, w]
    bits = _unpack_bits(y)[:, :n_gamma]  # (mu_pad, n_gamma)
    return bits.t()[:, : 1 << delta_bits].reshape(-1)[:height].contiguous()


def mp_point_operands(server, key: KeyMP, points):
    """Host-side packed operands of the multi-party point eval: (xp, rk4,
    ksel, bytesel, present, cwm, p2) as numpy uint32, shaped as
    mp_point_packed_core takes them (the lanes past the points evaluate
    point 0, and the caller drops them)."""
    p2, mu, gamma_bits, delta_bits = _mp_params(server.num_bits, key.num_parties)
    pts = np.asarray(points, dtype=np.int64)
    n = len(pts)
    nw = -(-n // 32)
    if nw * 32 != n:
        pts = np.concatenate([pts, np.zeros(nw * 32 - n, dtype=np.int64)])
    deltas = pts & ((1 << delta_bits) - 1)
    gammas = (pts >> delta_bits) & ((1 << gamma_bits) - 1)
    b = deltas >> 2  # the PRG block holding word delta
    kidx = b & 3  # its fixed key (prf_blocks: ciphers[b % 4])
    ctr = b >> 2  # its counter (prf_blocks: b // 4)
    widx = deltas & 3  # the word within the block

    sigma = np.frombuffer(b"".join(key.sigma), dtype=np.uint8).reshape(1 << gamma_bits, p2, 16)
    seeds = sigma[gammas]  # (n_pad, p2, 16)
    present_rows = seeds.any(axis=2)
    x = seeds.copy()
    x[:, :, :8] ^= ctr.astype("<u8").view(np.uint8).reshape(-1, 8)[:, None, :]
    xp = np.stack([blocks_to_planes(np.ascontiguousarray(x[:, i])) for i in range(p2)],
                  axis=1)  # (8, p2, 16, NW)
    rk4 = np.stack(_mp_fixed_rk4(server))[:, :, :, None]  # (4, 11, 8, 1, 16, 1)
    ksel = np.stack([_pack_lane_mask(kidx == k, nw) for k in range(4)])
    bytesel = np.stack([_pack_lane_mask(widx == k, nw) for k in range(4)])
    present = np.stack([_pack_lane_mask(present_rows[:, i], nw) for i in range(p2)])
    cwm = np.stack([_pack_lane_mask((np.asarray(key.cw[i], dtype=np.uint32)[deltas] & 1) == 1,
                                    nw) for i in range(p2)])
    return xp, rk4, ksel, bytesel, present, cwm, p2


def mp_point_packed_core(xp, rk4, ksel, bytesel, present, cwm, p2: int) -> torch.Tensor:
    """The multi-party point eval over packed per-lane operands: xp
    (8,p2,16,NW), rk4 (4,11,8,1,16,1), ksel / bytesel (4,NW), present /
    cwm (p2,NW) -> (NW,) packed XOR-share parity words. Each lane's round
    keys are the fixed-key schedule its one-hot ksel mask selects (the
    masks are disjoint, so OR composes them); the parity of its word
    (delta & 3) is bit 0 of byte 4 * (delta & 3), chosen by bytesel. A
    pure function of its tensors: the mesh's multi-party step
    (parallel/mesh.py) calls it on a shard's slice of the operands."""
    rk = rk4[0] & ksel[0]
    for k in range(1, 4):
        rk = rk | (rk4[k] & ksel[k])
    out = aes_encrypt_planes(xp, rk) ^ xp  # MMO (dpf/common.go:60-75)
    p0 = out[0]  # bit-0 planes, (p2, 16, NW)
    par = ((p0[:, 0] & bytesel[0]) ^ (p0[:, 4] & bytesel[1]) ^ (p0[:, 8] & bytesel[2])
           ^ (p0[:, 12] & bytesel[3]))  # (p2, NW)
    contrib = present & (par ^ cwm)  # zero-seed slots skip G and CW
    y = contrib[0]
    for i in range(1, p2):
        y = y ^ contrib[i]
    return y


def eval_points_mp_bits(server, key: KeyMP, points, device=None) -> torch.Tensor:
    """(len(points),) uint8 selection-bit share of a multi-party key at
    arbitrary points (keyword shares, db.go:132-135 with >= 3 servers),
    equal to ``(host.eval_points_mp(...) & 1) == 1``. Each point needs
    the one 16-byte PRG block that holds its output word: one bitsliced
    AES per sigma slot per 32 points."""
    xp, rk4, ksel, bytesel, present, cwm, p2 = mp_point_operands(server, key, points)
    y = mp_point_packed_core(*(u32_tensor(a, device) for a in (xp, rk4, ksel, bytesel, present,
                                                               cwm)), p2)
    return _unpack_bits(y)[: len(points)]
