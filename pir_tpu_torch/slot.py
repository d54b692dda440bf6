"""Slot — the fixed-size byte record unit (counterpart of ``pir_tpu/slot.py``).

XOR truncates to the shorter slot, as in the reference's slot.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Slot:
    data: bytearray = field(default_factory=bytearray)

    def __init__(self, data=b""):
        self.data = bytearray(data)

    def __repr__(self):
        return f"Slot({bytes(self.data)!r})"


def xor_slots(a: Slot, b: Slot) -> None:
    """In-place a ^= b, truncated to the shorter slot."""
    n = min(len(a.data), len(b.data))
    for j in range(n):
        a.data[j] ^= b.data[j]


def new_empty_slot(num_bytes: int) -> Slot:
    return Slot(bytes(num_bytes))
