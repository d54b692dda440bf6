"""Slot — the fixed-size byte record unit (counterpart of ``pir_tpu/slot.py``).

XOR truncates to the shorter slot, as in the reference's slot.go;
``to_string`` strips trailing zero bytes (slot.go:61-63).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Slot:
    data: bytearray = field(default_factory=bytearray)

    def __init__(self, data=b""):
        self.data = bytearray(data)

    def compare(self, other: "Slot") -> int:
        """bytes.Compare semantics: -1 / 0 / 1."""
        a, b = bytes(self.data), bytes(other.data)
        return (a > b) - (a < b)

    def to_string(self) -> str:
        b = bytes(self.data).rstrip(b"\x00")
        return (b or b"\x00").decode("latin-1")

    def __repr__(self):
        return f"Slot({bytes(self.data)!r})"


def xor_slots(a: Slot, b: Slot) -> None:
    """In-place a ^= b, truncated to the shorter slot."""
    n = min(len(a.data), len(b.data))
    for j in range(n):
        a.data[j] ^= b.data[j]


def new_empty_slot(num_bytes: int) -> Slot:
    return Slot(bytes(num_bytes))


def new_slot_from_string(s: str, slot_size: int) -> Slot:
    b = s.encode("latin-1")
    return Slot(b + bytes(max(0, slot_size - len(b))))


def get_required_slot_size(data: list[str]) -> int:
    """Max byte length over the strings (slot.go:174-186)."""
    return max((len(s.encode("latin-1")) for s in data), default=0)
