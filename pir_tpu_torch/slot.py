"""Slot — the fixed-size byte record unit (counterpart of ``pir_tpu/slot.py``).

XOR truncates to the shorter slot, as in the reference's slot.go;
``to_string`` strips trailing zero bytes (slot.go:61-63); the int-array
packing that marshals slots into Paillier plaintexts re-inserts the
leading zeros that minimal big-endian encodings drop (slot.go:98-134).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class Slot:
    data: bytearray = field(default_factory=bytearray)

    def __init__(self, data=b""):
        self.data = bytearray(data)

    def equal(self, other: "Slot | None") -> bool:
        if other is None:
            return False
        return len(self.data) == len(other.data) and self.data == other.data

    def compare(self, other: "Slot") -> int:
        """bytes.Compare semantics: -1 / 0 / 1."""
        a, b = bytes(self.data), bytes(other.data)
        return (a > b) - (a < b)

    def to_string(self) -> str:
        b = bytes(self.data).rstrip(b"\x00")
        return (b or b"\x00").decode("latin-1")

    def to_int_array(self, num_chunks: int) -> tuple[list[int], int]:
        """Split into num_chunks big-endian ints (slot.go:67-93): (ints,
        bytes per chunk). Raises ValueError for num_chunks <= 0."""
        if num_chunks <= 0:
            raise ValueError("cannot divide data into 0 chunks")
        n = len(self.data)
        per = max(1, -(-n // num_chunks))
        res = []
        for i in range(num_chunks):
            start = i * per
            end = min(n, start + per)
            res.append(int.from_bytes(bytes(self.data[start:end]), "big") if start < end else 0)
        return res, per

    @staticmethod
    def from_int_array(arr: list[int], num_bytes: int, num_bytes_per_int: int) -> "Slot":
        """Inverse packing with leading-zero reinsertion (slot.go:98-134)."""
        out = bytearray(num_bytes)
        next_byte = 0
        for v in arr:
            vb = v.to_bytes((v.bit_length() + 7) // 8, "big")  # minimal, b"" for 0
            shift_zeros = next_byte + num_bytes_per_int <= num_bytes
            if shift_zeros and len(vb) <= num_bytes_per_int:
                next_byte += num_bytes_per_int - len(vb)
            if not shift_zeros:
                next_byte += num_bytes - next_byte - len(vb)
            for b in vb:
                out[next_byte] = b
                next_byte += 1
        return Slot(out)

    def __repr__(self):
        return f"Slot({bytes(self.data)!r})"


def xor_slots(a: Slot, b: Slot) -> None:
    """In-place a ^= b, truncated to the shorter slot."""
    n = min(len(a.data), len(b.data))
    for j in range(n):
        a.data[j] ^= b.data[j]


def new_slot(data: bytes) -> Slot:
    return Slot(data)


def new_empty_slot(num_bytes: int) -> Slot:
    return Slot(bytes(num_bytes))


def new_random_slot(num_bytes: int) -> Slot:
    return Slot(os.urandom(num_bytes))


def new_slot_from_string(s: str, slot_size: int) -> Slot:
    b = s.encode("latin-1")
    return Slot(b + bytes(max(0, slot_size - len(b))))


def get_required_slot_size(data: list[str]) -> int:
    """Max byte length over the strings (slot.go:174-186)."""
    return max((len(s.encode("latin-1")) for s in data), default=0)
