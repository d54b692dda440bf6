"""Bit conventions of the reference Go implementation (counterpart of the
part of ``pir_tpu/utils/bits.py`` that reference-exact keys need).

* ``get_bit`` — MSB-first, 1-indexed bit extraction (dpf/common.go:53-58).
* ``go_varint`` / ``go_varint_vec`` — Go ``encoding/binary`` signed
  varint decoding of the final DPF seed (dpf/client.go:141,
  dpf/server.go:96).
* ``num_bits_for_height`` — the reference's DPF domain size rule.
* ``bitrev_permutation`` — breadth-first storage order -> natural order.
"""

from __future__ import annotations

import math

import numpy as np

GO_UINT_BITS = 64  # Go `uint` is 64-bit on all relevant platforms


def get_bit(n: int, pos: int, nbits: int = GO_UINT_BITS) -> int:
    """0th position is the most significant bit; 1-indexed from MSB:
    ``(n & (1 << (N - pos))) >> (N - pos)``."""
    return (n >> (nbits - pos)) & 1


def go_uvarint(buf: bytes) -> tuple[int, int]:
    """Go encoding/binary.Uvarint on a short buffer: (value, n); n == 0
    when no byte terminates the varint (value 0)."""
    x = 0
    s = 0
    for i, b in enumerate(buf):
        if b < 0x80:
            return x | (b << s), i + 1
        x |= (b & 0x7F) << s
        s += 7
    return 0, 0


def go_varint(buf: bytes) -> tuple[int, int]:
    """Go encoding/binary.Varint (zigzag-decoded signed varint)."""
    ux, n = go_uvarint(buf)
    x = ux >> 1
    if ux & 1:
        x = -(x + 1)  # Go: x = ^x for int64
    return x, n


def go_varint_vec(buf: np.ndarray) -> np.ndarray:
    """``go_varint`` over the rows of an (n, 8) uint8 array -> int64,
    including the all-continuation-bytes => 0 case."""
    assert buf.ndim == 2 and buf.shape[1] == 8
    b = buf.astype(np.uint64)
    is_term = buf < 0x80
    has_term = is_term.any(axis=1)
    first = np.argmax(is_term, axis=1)  # index of the terminator (0 if none)
    j = np.arange(8, dtype=np.uint64)
    contrib = (b & np.uint64(0x7F)) << (np.uint64(7) * j)[None, :]
    mask = j[None, :] <= first[:, None].astype(np.uint64)
    ux = np.where(mask, contrib, np.uint64(0)).sum(axis=1, dtype=np.uint64)
    ux = np.where(has_term, ux, np.uint64(0))
    val = (ux >> np.uint64(1)).astype(np.int64)
    neg = (ux & np.uint64(1)).astype(bool)
    return np.where(neg, -(val + 1), val)


def num_bits_for_height(height: int) -> int:
    """The reference's DPF domain size: uint(log2(h) + 1), a float log2
    then +1 then truncation (query.go:61, db.go:117). Exact powers of two
    get one extra bit (h = 1024 -> 11): a dead right half of the tree."""
    if height <= 0:
        raise ValueError("height must be positive")
    return int(math.log2(height) + 1)


def bitrev_permutation(num_bits: int) -> np.ndarray:
    """P with P[i] = bit_reverse(i, num_bits): breadth-first expansion
    stores leaf x at bit_reverse(x); gathering with P restores the
    natural order."""
    n = 1 << num_bits
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for b in range(num_bits):
        rev |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(num_bits - 1 - b)
    return rev.astype(np.int64)
