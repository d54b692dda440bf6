"""The compat (reference-exact) head walk: CUDA kernel wrapper and its
plain version. No Pallas counterpart: it replaces the jnp walk that XLA
fuses on the TPU (``pir_tpu/models/pipeline.py`` ``_compat_skip_walk``
and ``fused_compat_root_batch*_fn``, ``pir_tpu/dpf/device.py``
``expand_planes_from_root``), which eager torch runs as one launch a
bitsliced gate.

Per query the walk keeps the left child on the `skip` dead leading
levels, then, with ``shard = (index, levels)``, follows `index`'s bits
(MSB first, right on a set bit) down to that row shard's subtree root,
then expands split = 5 + log2(w) root-start levels in full: the first
compat stage's input planes. Operands as ``unpack_compat_root_payload``
makes them (int32 words):

  seeds (Q,8,16,1) root seed bits in bit 0, t (Q,1), cw_s (Q,d,8,16,1),
  cw_tl / cw_tr (Q,d) and rk (Q,11,8,3,16,1) 0 / -1 masks
  -> seeds (Q,8,1,16,w) and t (Q,1,1,w), node order as
  ``expand_planes_from_root`` leaves it.

On a CUDA tensor the wrapper launches ``compat_head_kernel`` of
``csrc/compat_stage.cu`` (one block a query); on a CPU tensor it runs
``compat_head_plain``. The kernel reads bit 0 of each operand word.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dpf.device import (
    _children,
    _prf_triple,
    _rk_bit_first,
    expand_planes_from_root,
    shard_prefix_walk,
)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_LEVELS = 40  # prefix + root-start levels a launch walks (kMaxHeadLevels)


def compat_skip_walk(seeds, t, cw_s, cw_tl, cw_tr, rk, skip: int):
    """Walk `skip` dead leading levels keeping only the left child, for
    Q queries: seeds (Q,8,16,1), t (Q,1), cw_s (Q,d,8,16,1), cw_tl /
    cw_tr (Q,d), rk (Q,11,8,3,16,1).

    The planes are root-shaped: lane bit 0 holds the seed, and the high
    lane bits carry garbage that the first in-word packing level of
    expand_planes_from_root masks away (see CompatRootLayout)."""
    x = seeds.transpose(0, 1)
    rk_b = _rk_bit_first(rk)
    for k in range(skip):
        out = _prf_triple(x, rk_b)
        x, t, _, _ = _children(out, t, cw_s[:, k].transpose(0, 1), cw_tl[:, k:k + 1],
                               cw_tr[:, k:k + 1])
    return x.transpose(0, 1), t


def _split(w: int) -> int:
    if w < 1 or w & (w - 1):
        raise ValueError(f"lane width {w} is not a power of two")
    return 5 + w.bit_length() - 1


def compat_head_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, *, skip: int, w: int, shard=None):
    """Plain torch version: the skip walk, the shard prefix walk
    (dpf.device.shard_prefix_walk, upper lanes kept) and the root-start
    levels, bitsliced AES over the whole batch."""
    split = _split(w)
    sk = skip
    seeds, t = compat_skip_walk(seeds, t, cw_s, cw_tl, cw_tr, rk, sk)
    if shard is not None:
        index, levels = shard
        x, t = shard_prefix_walk(
            seeds.transpose(0, 1), t,
            [(cw_s[:, i].transpose(0, 1), cw_tl[:, i:i + 1], cw_tr[:, i:i + 1])
             for i in range(sk, sk + levels)], _rk_bit_first(rk), index, low_bit=False)
        seeds = x.transpose(0, 1)
        sk += levels
    seeds, t = expand_planes_from_root(seeds, t, cw_s[:, sk:], cw_tl[:, sk:], cw_tr[:, sk:],
                                       rk, split)
    q = seeds.shape[0]
    return seeds.unsqueeze(2).contiguous(), t.reshape(q, 1, 1, w).contiguous()


def _check(seeds, t, cw_s, cw_tl, cw_tr, rk, skip, split, shard):
    if seeds.dim() != 4:
        raise ValueError(f"seeds: want (Q,8,16,1), got {tuple(seeds.shape)}")
    q = seeds.shape[0]
    d = cw_s.shape[1] if cw_s.dim() == 5 else -1
    want = {
        "seeds": (seeds, (q, 8, 16, 1)),
        "t": (t, (q, 1)),
        "cw_s": (cw_s, (q, d, 8, 16, 1)),
        "cw_tl": (cw_tl, (q, d)),
        "cw_tr": (cw_tr, (q, d)),
        "rk": (rk, (q, 11, 8, 3, 16, 1)),
    }
    for name, (x, shape) in want.items():
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want int32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != seeds.device:
            raise ValueError(f"{name} is on {x.device}, seeds on {seeds.device}")
    index, levels = shard if shard is not None else (0, 0)
    if skip < 0 or levels < 0 or not 0 <= index < 1 << levels:
        raise ValueError(f"bad prefix: skip {skip}, shard {shard}")
    prefix = skip + levels
    if prefix + split > d:
        raise ValueError(f"{prefix} prefix + {split} head levels exceed the key's {d}")
    return prefix, index


def compat_head(seeds, t, cw_s, cw_tl, cw_tr, rk, *, skip: int, w: int, shard=None):
    """The head walk -> (seeds (Q,8,1,16,w), t (Q,1,1,w))."""
    split = _split(w)
    prefix, index = _check(seeds, t, cw_s, cw_tl, cw_tr, rk, skip, split, shard)
    if seeds.device.type == "cpu":
        return compat_head_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, skip=skip, w=w, shard=shard)
    if seeds.device.type != "cuda":
        raise ValueError(f"no compat head kernel for device {seeds.device}")
    ops = (seeds, t, cw_s, cw_tl, cw_tr, rk)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("compat head operands must be contiguous")
    if prefix + split > MAX_LEVELS or index >= 1 << 31:
        raise ValueError(f"{prefix + split} head levels exceed the kernel's {MAX_LEVELS}")
    q = seeds.shape[0]
    out_s = torch.empty((q, 8, 1, 16, w), dtype=torch.int32, device=seeds.device)
    out_t = torch.empty((q, 1, 1, w), dtype=torch.int32, device=seeds.device)
    if q == 0:
        return out_s, out_t
    fn = _build.load("compat_stage").pir_compat_head
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in ops), out_s.data_ptr(), out_t.data_ptr(),
                 q, cw_s.shape[1], prefix, index, split, stream)
    _build.check(err, "compat_head")
    _build.count_launch(compat_head)
    return out_s, out_t


compat_head.launches = 0
