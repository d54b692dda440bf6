"""Stacked fast-DPF tail: CUDA kernel wrapper and its plain version
(counterpart of ``pir_tpu/ops/pallas_expand.py:fast_tail_expand_stacked_pallas``).

k lane-packed queries per step walk the last `tail` tree levels — per
node a 3-block fixed-key AES-MMO PRG, sL = block 0, tL = block 1 byte 0,
sR = block 1 bytes 1..15 ++ block 2 byte 0, tR = block 2 byte 1,
corrected by ``t & CW`` — with branches doubling on a chunk axis
(chunk = parent * 2 + branch), then the leaf CTR-MMO over n_blk blocks
XOR ``t & fcw``. Operands (int32 bit-plane words):

  seeds (S,8,1,16,W), t (S,1,1,W), cw_s (S,tail,8,16,W),
  cw_tl / cw_tr (S,tail,1,W), fcw (S,8,n_blk,16,W),
  rk (11,8,3,16,1) and rk_leaf (11,8,16,1) for batch-shared keys, or
  rk (S,11,8,3,16,W) and rk_leaf (S,11,8,16,W) per step and lane word
  -> (S, 8, 2^tail * n_blk, 16, W).

On a CUDA tensor the wrapper launches ``csrc/stacked_tail.cu``; on a CPU
tensor it runs ``fast_tail_expand_stacked_plain``. The kernel reads each
round-key mask word's bit 0 (the masks are 0 / -1, as the payload
unpack makes them); every other operand is used bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dpf.bitslice import aes_encrypt_planes
from ..dpf.device import _leaf_ctr_masks

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _round_keys(rk: torch.Tensor, rk_leaf: torch.Tensor):
    """Masks laid out to broadcast against (8, S, B, [3,] 16, W) states."""
    if rk.dim() == 5:  # shared (11,8,3,16,1)
        return rk.reshape(11, 8, 1, 1, 3, 16, 1), rk_leaf.reshape(11, 8, 1, 1, 16, 1)
    # per step and lane: (S,11,8,3,16,W) -> (11,8,S,1,3,16,W)
    return (rk.permute(1, 2, 0, 3, 4, 5).unsqueeze(3),
            rk_leaf.permute(1, 2, 0, 3, 4).unsqueeze(3))


def fast_tail_expand_stacked_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                                   *, tail: int, n_blk: int) -> torch.Tensor:
    """Plain torch version: bitsliced AES over every step at once."""
    s_n, _, _, _, w = seeds.shape
    rk_tree, rkl = _round_keys(rk, rk_leaf)
    x = seeds.permute(1, 0, 2, 3, 4)  # (8, S, B=1, 16, W)
    tt = t.reshape(s_n, 1, 1, w)  # (S, B, 1, W)
    for lv in range(tail):
        xin = x.unsqueeze(3)  # (8, S, B, 1, 16, W)
        prg = aes_encrypt_planes(xin, rk_tree) ^ xin  # (8, S, B, 3, 16, W)
        s_l = prg[:, :, :, 0]
        t_l = prg[0, :, :, 1, 0:1]  # (S, B, 1, W)
        s_r = torch.cat([prg[:, :, :, 1, 1:16], prg[:, :, :, 2, 0:1]], dim=-2)
        t_r = prg[0, :, :, 2, 1:2]
        corr = tt.unsqueeze(0) & cw_s[:, lv].permute(1, 0, 2, 3).unsqueeze(2)
        t_l = t_l ^ (tt & cw_tl[:, lv].reshape(s_n, 1, 1, w))
        t_r = t_r ^ (tt & cw_tr[:, lv].reshape(s_n, 1, 1, w))
        b = x.shape[2]
        x = torch.stack([s_l ^ corr, s_r ^ corr], dim=3).reshape(8, s_n, 2 * b, 16, w)
        tt = torch.stack([t_l, t_r], dim=2).reshape(s_n, 2 * b, 1, w)
    b = x.shape[2]
    ctr = torch.from_numpy(_leaf_ctr_masks(n_blk).view("int32")).to(seeds.device)
    xl = (x.unsqueeze(3) ^ ctr.reshape(8, 1, 1, n_blk, 16, 1)).reshape(8, s_n, b * n_blk, 16, w)
    prg = aes_encrypt_planes(xl, rkl) ^ xl
    fcw_b = fcw.permute(1, 0, 2, 3, 4).unsqueeze(2).expand(8, s_n, b, n_blk, 16, w)
    tb = tt.reshape(s_n, b, 1, 1, w).expand(s_n, b, n_blk, 1, w)
    out = prg ^ (tb.reshape(1, s_n, b * n_blk, 1, w) & fcw_b.reshape(8, s_n, b * n_blk, 16, w))
    return out.permute(1, 0, 2, 3, 4).contiguous()


def _check(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf, tail, n_blk):
    s_n, _, _, _, w = seeds.shape
    want = {
        "seeds": (seeds, (s_n, 8, 1, 16, w)),
        "t": (t, (s_n, 1, 1, w)),
        "cw_s": (cw_s, (s_n, tail, 8, 16, w)),
        "cw_tl": (cw_tl, (s_n, tail, 1, w)),
        "cw_tr": (cw_tr, (s_n, tail, 1, w)),
        "fcw": (fcw, (s_n, 8, n_blk, 16, w)),
    }
    if rk.dim() == 5:
        want["rk"] = (rk, (11, 8, 3, 16, 1))
        want["rk_leaf"] = (rk_leaf, (11, 8, 16, 1))
    else:
        want["rk"] = (rk, (s_n, 11, 8, 3, 16, w))
        want["rk_leaf"] = (rk_leaf, (s_n, 11, 8, 16, w))
    for name, (x, shape) in want.items():
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want int32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != seeds.device:
            raise ValueError(f"{name} is on {x.device}, seeds on {seeds.device}")


def fast_tail_expand_stacked(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                             *, tail: int, n_blk: int) -> torch.Tensor:
    """Stacked tail walk + leaf PRG -> (S, 8, 2^tail * n_blk, 16, W) int32."""
    _check(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf, tail, n_blk)
    if seeds.device.type == "cpu":
        return fast_tail_expand_stacked_plain(
            seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf, tail=tail, n_blk=n_blk)
    if seeds.device.type != "cuda":
        raise ValueError(f"no stacked tail kernel for device {seeds.device}")
    ops = (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("stacked tail operands must be contiguous")
    s_n, _, _, _, w = seeds.shape
    out = torch.empty((s_n, 8, (1 << tail) * n_blk, 16, w), dtype=torch.int32,
                      device=seeds.device)
    if s_n == 0:
        return out
    fn = _build.load("stacked_tail").pir_stacked_tail
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rk_lanes = 1 if rk.dim() == 5 else w
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in ops), out.data_ptr(),
                 s_n, w, tail, n_blk, rk_lanes, stream)
    _build.check(err, "stacked_tail")
    _build.count_launch(fast_tail_expand_stacked)
    return out


fast_tail_expand_stacked.launches = 0
