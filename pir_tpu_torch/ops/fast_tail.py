"""Per-query fast-DPF tail: CUDA kernel wrapper and its plain version
(counterpart of ``pir_tpu/ops/pallas_expand.py:fast_tail_expand_pallas``).

Each query's head frontier walks the last `levels` tree levels — per
node the 3-block fixed-key AES-MMO PRG, sL = block 0, tL = block 1
byte 0, sR = block 1 bytes 1..15 ++ block 2 byte 0, tR = block 2 byte 1,
corrected by ``t & CW`` — doubling the lane axis by concatenating
[left | right] words, so each new level is the most significant lane
bit. Then the leaf CTR-MMO over n_blk blocks (block-major lanes: lane =
blk * NWf + word) XOR ``t & fcw``. Operands (int32 bit-plane words):

  seeds (Q,8,16,NW0), t (Q,1,NW0), cw_s (Q,levels,8,16,1),
  cw_tl / cw_tr (Q,levels), fcw (Q,8,16,1) or (Q,8,n_blk,16,1),
  rk (11,8,3,16,1) and rk_leaf (11,8,16,1) for batch-shared keys, or
  rk (Q,11,8,3,16,1) and rk_leaf (Q,11,8,16,1) per query
  -> (Q, 8, 16, n_blk * (NW0 << levels)), the classic bit-reversed
  storage order (dpf.device._fast_leaf_perm_root).

On a CUDA tensor the wrapper launches ``csrc/fast_tail.cu``; on a CPU
tensor it runs ``fast_tail_expand_plain``. The kernel reads bit 0 of
each mask operand (cw_s, cw_tl, cw_tr, rk, rk_leaf are 0 / -1, as the
payload unpack makes them); seeds, t and fcw are used bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dpf.bitslice import aes_encrypt_planes
from ..dpf.device import _leaf_ctr_masks

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_LEVELS = 16  # the kernel's per-block correction words and DFS stack


def leaf_blocks_of(fcw: torch.Tensor) -> int:
    """n_blk from the final-CW operand: (Q,8,16,1) or (Q,8,n_blk,16,1)."""
    return fcw.shape[2] if fcw.dim() == 5 else 1


def _tail_round_keys(rk: torch.Tensor, rk_leaf: torch.Tensor):
    """Masks laid out to broadcast against (8, Q, [3,] 16, NW) states."""
    if rk.dim() == 5:  # shared (11,8,3,16,1)
        return rk.reshape(11, 8, 1, 3, 16, 1), rk_leaf.reshape(11, 8, 1, 16, 1)
    # per query: (Q,11,8,3,16,1) -> (11,8,Q,3,16,1)
    return rk.permute(1, 2, 0, 3, 4, 5), rk_leaf.permute(1, 2, 0, 3, 4)


def fast_tail_expand_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                           *, levels: int) -> torch.Tensor:
    """Plain torch version: bitsliced AES over every query at once."""
    q = seeds.shape[0]
    rk_tree, rkl = _tail_round_keys(rk, rk_leaf)
    x = seeds.transpose(0, 1)  # (8, Q, 16, NW)
    tt = t  # (Q, 1, NW)
    for lv in range(levels):
        xin = x.unsqueeze(2)  # (8, Q, 1, 16, NW)
        prg = aes_encrypt_planes(xin, rk_tree) ^ xin  # (8, Q, 3, 16, NW)
        s_l = prg[:, :, 0]
        t_l = prg[0, :, 1, 0:1]  # (Q, 1, NW)
        s_r = torch.cat([prg[:, :, 1, 1:16], prg[:, :, 2, 0:1]], dim=-2)
        t_r = prg[0, :, 2, 1:2]
        corr = tt.unsqueeze(0) & cw_s[:, lv].transpose(0, 1)  # (8, Q, 16, NW)
        t_l = t_l ^ (tt & cw_tl[:, lv].reshape(q, 1, 1))
        t_r = t_r ^ (tt & cw_tr[:, lv].reshape(q, 1, 1))
        x = torch.cat([s_l ^ corr, s_r ^ corr], dim=-1)
        tt = torch.cat([t_l, t_r], dim=-1)
    if fcw.dim() == 5:  # block-major lanes: CTR block b at [b*NW, (b+1)*NW)
        n_blk = fcw.shape[2]
        ctr = torch.from_numpy(_leaf_ctr_masks(n_blk).view("int32")).to(seeds.device)
        x = torch.cat([x ^ ctr[:, b].unsqueeze(1) for b in range(n_blk)], dim=-1)
        f = fcw.transpose(0, 1)  # (8, Q, n_blk, 16, 1)
        fcw_b = torch.cat([f[:, :, b].expand(-1, -1, -1, tt.shape[-1])
                           for b in range(n_blk)], dim=-1)
        tt = torch.cat([tt] * n_blk, dim=-1)
    else:
        fcw_b = fcw.transpose(0, 1)  # (8, Q, 16, 1)
    prg = aes_encrypt_planes(x, rkl) ^ x
    return (prg ^ (tt.unsqueeze(0) & fcw_b)).transpose(0, 1).contiguous()


def check_operands(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf, levels: int) -> None:
    """Raise unless the operands have the dtypes, shapes and device of
    one per-query tail launch."""
    if seeds.dim() != 4:
        raise ValueError(f"seeds: want (Q,8,16,NW0), got {tuple(seeds.shape)}")
    q, _, _, nw0 = seeds.shape
    n_blk = leaf_blocks_of(fcw)
    want = {
        "seeds": (seeds, (q, 8, 16, nw0)),
        "t": (t, (q, 1, nw0)),
        "cw_s": (cw_s, (q, levels, 8, 16, 1)),
        "cw_tl": (cw_tl, (q, levels)),
        "cw_tr": (cw_tr, (q, levels)),
        "fcw": (fcw, (q, 8, n_blk, 16, 1) if fcw.dim() == 5 else (q, 8, 16, 1)),
    }
    if rk.dim() == 5:
        want["rk"] = (rk, (11, 8, 3, 16, 1))
        want["rk_leaf"] = (rk_leaf, (11, 8, 16, 1))
    else:
        want["rk"] = (rk, (q, 11, 8, 3, 16, 1))
        want["rk_leaf"] = (rk_leaf, (q, 11, 8, 16, 1))
    for name, (x, shape) in want.items():
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want int32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != seeds.device:
            raise ValueError(f"{name} is on {x.device}, seeds on {seeds.device}")
    if levels > MAX_LEVELS:
        raise ValueError(f"{levels} tail levels exceed the kernel's {MAX_LEVELS}")


def fast_tail_expand(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                     *, levels: int) -> torch.Tensor:
    """Per-query tail walk + leaf PRG -> (Q, 8, 16, n_blk * (NW0 << levels)) int32."""
    check_operands(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf, levels)
    if seeds.device.type == "cpu":
        return fast_tail_expand_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf,
                                      levels=levels)
    if seeds.device.type != "cuda":
        raise ValueError(f"no per-query tail kernel for device {seeds.device}")
    ops = (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, rk_leaf)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("per-query tail operands must be contiguous")
    q, _, _, nw0 = seeds.shape
    n_blk = leaf_blocks_of(fcw)
    out = torch.empty((q, 8, 16, n_blk * (nw0 << levels)), dtype=torch.int32,
                      device=seeds.device)
    if q == 0:
        return out
    fn = _build.load("fast_tail").pir_fast_tail
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in ops), out.data_ptr(), q, nw0, levels, n_blk,
                 int(rk.dim() == 6), stream)
    _build.check(err, "fast_tail")
    _build.count_launch(fast_tail_expand)
    return out


fast_tail_expand.launches = 0
