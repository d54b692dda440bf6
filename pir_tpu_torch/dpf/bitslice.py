"""Bitsliced AES-128 over 32-bit words, in torch (counterpart of
``pir_tpu/dpf/bitslice.py``).

The state of 32·NW AES blocks is held as 128 bit planes (8 bits x 16 byte
positions) of 32-bit words, one bit per block per plane, so every AES
step is XOR/AND on whole planes. Planes are ``torch.int32`` (the bit
pattern of the JAX package's uint32 words): int32 has every bitwise
operator on every device.

Layout convention: ``state[bit, ..., byte, lane]`` with bit 0 = LSB and
byte index = position in the 16-byte block; middle axes are free and
broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

_NOT = -1  # XOR with all ones: bitwise NOT of an int32 plane

# ShiftRows as a byte-index permutation: new[r+4c] = old[r+4((c+r)%4)]
SHIFT_ROWS_PERM = np.array(
    [(i % 4) + 4 * (((i // 4) + (i % 4)) % 4) for i in range(16)], dtype=np.int64
)
_XTIME_PERM = [7, 0, 1, 2, 3, 4, 5, 6]
_index_cache: dict[torch.device, torch.Tensor] = {}


def sub_bytes(state: torch.Tensor) -> torch.Tensor:
    """Bitsliced SubBytes: the Boyar–Peralta 113-gate S-box circuit.

    The circuit's U0..U7 / S0..S7 are MSB-first; planes are LSB-first,
    hence the reversed indexing.
    """
    U0, U1, U2, U3, U4, U5, U6, U7 = (state[7 - i] for i in range(8))
    y14 = U3 ^ U5
    y13 = U0 ^ U6
    y9 = U0 ^ U3
    y8 = U0 ^ U5
    t0 = U1 ^ U2
    y1 = t0 ^ U7
    y4 = y1 ^ U3
    y12 = y13 ^ y14
    y2 = y1 ^ U0
    y5 = y1 ^ U6
    y3 = y5 ^ y8
    t1 = U4 ^ y12
    y15 = t1 ^ U5
    y20 = t1 ^ U1
    y6 = y15 ^ U7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = U7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = U0 ^ y16
    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & U7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    z0 = t44 & y15
    z1 = t37 & y6
    z2 = t33 & U7
    z3 = t43 & y16
    z4 = t40 & y1
    z5 = t29 & y7
    z6 = t42 & y11
    z7 = t45 & y17
    z8 = t41 & y10
    z9 = t44 & y12
    z10 = t37 & y3
    z11 = t33 & y4
    z12 = t43 & y13
    z13 = t40 & y5
    z14 = t29 & y2
    z15 = t42 & y9
    z16 = t45 & y14
    z17 = t41 & y8
    t46 = z15 ^ z16
    t47 = z10 ^ z11
    t48 = z5 ^ z13
    t49 = z9 ^ z10
    t50 = z2 ^ z12
    t51 = z2 ^ z5
    t52 = z7 ^ z8
    t53 = z0 ^ z3
    t54 = z6 ^ z7
    t55 = z16 ^ z17
    t56 = z12 ^ t48
    t57 = t50 ^ t53
    t58 = z4 ^ t46
    t59 = z3 ^ t54
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t64 = z4 ^ t59
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    S0 = t59 ^ t63
    S6 = (t56 ^ t62) ^ _NOT
    S7 = (t48 ^ t60) ^ _NOT
    t67 = t64 ^ t65
    S3 = t53 ^ t66
    S4 = t51 ^ t66
    S5 = t47 ^ t65
    S1 = (t64 ^ S3) ^ _NOT
    S2 = (t55 ^ t67) ^ _NOT
    out = [S7, S6, S5, S4, S3, S2, S1, S0]  # back to LSB-first planes
    return torch.stack(out, dim=0)


def shift_rows(state: torch.Tensor) -> torch.Tensor:
    idx = _index_cache.get(state.device)
    if idx is None:
        idx = _index_cache[state.device] = torch.from_numpy(SHIFT_ROWS_PERM).to(state.device)
    return state.index_select(state.dim() - 2, idx)


def _xtime(b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) doubling along the bit axis (axis 0)."""
    out = b[_XTIME_PERM]
    hi = b[7]
    for k in (1, 3, 4):
        out[k] ^= hi
    return out


def mix_columns(state: torch.Tensor) -> torch.Tensor:
    # byte axis (-2) viewed as (column, row); byte i = 4c + r per FIPS-197
    s4 = state.reshape(state.shape[:-2] + (4, 4) + state.shape[-1:])
    r1 = torch.roll(s4, -1, dims=-2)  # a_{r+1} at row r
    r2 = torch.roll(s4, -2, dims=-2)
    r3 = torch.roll(s4, -3, dims=-2)
    # b_r = 2a_r ^ 3a_{r+1} ^ a_{r+2} ^ a_{r+3}
    out = _xtime(s4 ^ r1) ^ r1 ^ r2 ^ r3
    return out.reshape(state.shape)


def aes_encrypt_planes(x: torch.Tensor, rk_masks: torch.Tensor) -> torch.Tensor:
    """Bitsliced AES-128 encryption.

    x: (8, ..., 16, NW) int32 plaintext planes; rk_masks: (11, 8, ...,
    16, 1-or-NW) int32 round-key masks (0 / -1), broadcast-compatible
    with x. Returns ciphertext planes, shape = broadcast(x, rk_masks[0]).
    """
    state = x ^ rk_masks[0]
    for r in range(1, 10):
        state = sub_bytes(state)
        state = shift_rows(state)
        state = mix_columns(state)
        state = state ^ rk_masks[r]
    state = sub_bytes(state)
    state = shift_rows(state)
    return state ^ rk_masks[10]


# --------------------------------------------------------------------------
# Host <-> plane packing helpers (numpy, uint32 words)
# --------------------------------------------------------------------------

_FULL = np.uint32(0xFFFFFFFF)


def blocks_to_planes(blocks: np.ndarray) -> np.ndarray:
    """(n, 16) uint8 blocks -> (8, 16, ceil(n/32)) uint32 bit planes.

    Bit j of word w in plane (k, i) is bit k of byte i of block 32w+j.
    """
    n = blocks.shape[0]
    nw = -(-n // 32)
    padded = np.zeros((nw * 32, 16), dtype=np.uint8)
    padded[:n] = blocks
    by = np.ascontiguousarray(padded.reshape(nw, 32, 16).transpose(2, 0, 1))  # (16, nw, 32)
    out = np.empty((8, 16, nw), dtype=np.uint32)
    for k in range(8):
        out[k] = np.packbits((by >> k) & 1, axis=-1, bitorder="little").view("<u4")[..., 0]
    return out


def planes_to_blocks(planes: np.ndarray, n: int) -> np.ndarray:
    """Inverse of blocks_to_planes -> (n, 16) uint8."""
    planes = np.asarray(planes).view(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (planes[..., None] >> shifts) & np.uint32(1)  # (8,16,nw,32)
    bits = bits.reshape(8, 16, -1)[:, :, :n]  # (8,16,n)
    bytes_ = (bits.astype(np.uint8) << np.arange(8, dtype=np.uint8)[:, None, None]).sum(
        axis=0, dtype=np.uint8
    )
    return bytes_.T.copy()  # (16, n) -> (n, 16)


def key_masks(round_keys: np.ndarray) -> np.ndarray:
    """Round keys (..., 11, 16) uint8 -> masks (11, 8, 16, ...) uint32.

    Leading axes of the input become trailing axes of the output so they
    broadcast against lane dimensions.
    """
    rks = np.asarray(round_keys, dtype=np.uint8)
    lead = rks.shape[:-2]
    bits = (rks[..., None] >> np.arange(8, dtype=np.uint8)) & 1  # (..., 11, 16, 8)
    bits = np.moveaxis(bits, [-3, -1, -2], [0, 1, 2])  # (11, 8, 16, ...)
    return (bits.astype(np.uint32) * _FULL).reshape((11, 8, 16) + lead)
