"""One stage of the compat (reference-exact) expansion cascade: CUDA kernel
wrapper and its plain version (counterpart of
``pir_tpu/ops/pallas_expand.py:compat_stage_pallas``).

Every (query, chunk, lane word, bit position) node of the stage's input
walks `tail` tree levels: per node the 3-block fixed-key AES-MMO PRG
under the query's tree keys, sL = block 0, tL = block 1 byte 0, sR =
block 1 bytes 1..15 ++ block 2 byte 0, tR = block 2 byte 1, corrected by
``t & CW``, with branches doubling on the chunk axis (chunk = parent * 2
+ branch, so a stage's first level is the most significant bit of the
output chunk's low `tail` bits). Operands (int32 bit-plane words):

  seeds (Q,8,NC,16,W), t (Q,NC,1,W), cw_s (Q,tail,8,16,1),
  cw_tl / cw_tr (Q,tail) and fcw (Q,) mask words, rk (Q,11,8,3,16,1)
  -> seeds (Q,8,NC<<tail,16,W) and t (Q,NC<<tail,1,W), or with
  emit_bits the packed selection words (Q,NC<<tail,1,W): bit =
  ~((parity & ~allcont) ^ (t & fcw)), the Go-varint parity of the leaf
  under the inverted convention of db.go:142.

On a CUDA tensor the wrapper launches ``csrc/compat_stage.cu``; on a CPU
tensor it runs ``compat_stage_plain``. The kernel reads bit 0 of each
mask operand (cw_s, cw_tl, cw_tr, rk, fcw are 0 / -1, as the payload
unpack makes them); seeds and t are used bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dpf.device import _children, _prf_triple

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_TAIL = 3  # the kernel keeps a node's whole subtree in registers
_MAX_GRID_YZ = 65535


def _varint_parity_packed(x: torch.Tensor, t: torch.Tensor, fcw: torch.Tensor) -> torch.Tensor:
    """Leaf planes x (8,Q,B,16,W), t (Q,B,W), fcw (Q,) -> (Q,B,1,W)
    packed selection words, bit = (leaf value % 2 == 0). The varint's
    parity is byte 0's bit 0 ^ bit 1 unless all 8 continuation bits
    (bit 7 of bytes 0..7) are set."""
    allcont = x[7, ..., 0, :]
    for byte in range(1, 8):
        allcont = allcont & x[7, ..., byte, :]
    parity = x[0, ..., 0, :] ^ x[1, ..., 0, :]
    out = ~((parity & ~allcont) ^ (t & fcw.reshape(-1, 1, 1)))
    return out.unsqueeze(-2)


def _stage_chunk(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, tail, emit_bits):
    q, _, nc, _, w = seeds.shape
    x = seeds.transpose(0, 1)  # (8, Q, B, 16, W)
    tt = t.reshape(q, nc, w)
    rk_b = rk.permute(1, 2, 3, 0, 4, 5).unsqueeze(4)  # (11, 8, 3, Q, 1, 16, 1)
    for lv in range(tail):
        out = _prf_triple(x, rk_b)  # (8, 3, Q, B, 16, W)
        s_l, t_l, s_r, t_r = _children(
            out, tt, cw_s[:, lv].transpose(0, 1).unsqueeze(2),
            cw_tl[:, lv].reshape(q, 1, 1), cw_tr[:, lv].reshape(q, 1, 1))
        b = x.shape[2]
        x = torch.stack([s_l, s_r], dim=3).reshape(8, q, 2 * b, 16, w)
        tt = torch.stack([t_l, t_r], dim=2).reshape(q, 2 * b, w)
    if emit_bits:
        return _varint_parity_packed(x, tt, fcw)
    return x.transpose(0, 1).contiguous(), tt.unsqueeze(-2).contiguous()


def compat_stage_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, *, tail: int,
                       emit_bits: bool, q_chunk: int = 4):
    """Plain torch version: bitsliced AES over `q_chunk` queries at a
    time (the AES gate temporaries of a whole stage would not fit)."""
    parts = [
        _stage_chunk(seeds[q0:q0 + q_chunk], t[q0:q0 + q_chunk], cw_s[q0:q0 + q_chunk],
                     cw_tl[q0:q0 + q_chunk], cw_tr[q0:q0 + q_chunk], rk[q0:q0 + q_chunk],
                     fcw[q0:q0 + q_chunk], tail, emit_bits)
        for q0 in range(0, seeds.shape[0], q_chunk)
    ]
    if emit_bits:
        return torch.cat(parts)
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _check(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, tail):
    if not 1 <= tail <= MAX_TAIL:
        raise ValueError(f"the compat stage walks 1..{MAX_TAIL} levels, not {tail}")
    if seeds.dim() != 5:
        raise ValueError(f"seeds: want (Q,8,NC,16,W), got {tuple(seeds.shape)}")
    q, _, nc, _, w = seeds.shape
    want = {
        "seeds": (seeds, (q, 8, nc, 16, w)),
        "t": (t, (q, nc, 1, w)),
        "cw_s": (cw_s, (q, tail, 8, 16, 1)),
        "cw_tl": (cw_tl, (q, tail)),
        "cw_tr": (cw_tr, (q, tail)),
        "rk": (rk, (q, 11, 8, 3, 16, 1)),
        "fcw": (fcw, (q,)),
    }
    for name, (x, shape) in want.items():
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want int32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != seeds.device:
            raise ValueError(f"{name} is on {x.device}, seeds on {seeds.device}")


def compat_stage(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, *, tail: int, emit_bits: bool):
    """One cascade stage -> (seeds', t') with NC' = NC << tail, or the
    packed selection words (Q, NC << tail, 1, W) when emit_bits."""
    _check(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, tail)
    if seeds.device.type == "cpu":
        return compat_stage_plain(seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, tail=tail,
                                  emit_bits=emit_bits)
    if seeds.device.type != "cuda":
        raise ValueError(f"no compat stage kernel for device {seeds.device}")
    ops = (seeds, t, cw_s, cw_tl, cw_tr, rk, fcw)
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("compat stage operands must be contiguous")
    q, _, nc, _, w = seeds.shape
    if q > _MAX_GRID_YZ or nc > _MAX_GRID_YZ:
        raise ValueError(f"{q} queries x {nc} chunks exceed one launch grid")
    nco = nc << tail
    words = torch.empty((q, nco, 1, w), dtype=torch.int32, device=seeds.device)
    out_s = words if emit_bits else torch.empty((q, 8, nco, 16, w), dtype=torch.int32,
                                                device=seeds.device)
    if q == 0:
        return words if emit_bits else (out_s, words)
    fn = _build.load("compat_stage").pir_compat_stage
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in ops), out_s.data_ptr(), words.data_ptr(),
                 q, nc, w, tail, int(emit_bits), stream)
    _build.check(err, "compat_stage")
    _build.count_launch(compat_stage)
    return words if emit_bits else (out_s, words)


compat_stage.launches = 0
