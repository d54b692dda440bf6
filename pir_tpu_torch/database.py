"""Database: slots as a dense ``(db_size, slot_bytes) uint8`` numpy array
and, for keyword queries, one uint64 keyword per row (counterpart of
``pir_tpu/database.py``). The server engine uploads it once to the
device."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .slot import Slot


@dataclass
class DBMetadata:
    """Layout info shared by client and server."""

    slot_bytes: int = 0
    db_size: int = 0


@dataclass
class Database(DBMetadata):
    data: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint8))
    # uint64, keyword r of grid row r for keyword queries (db.go:119-135)
    keywords: np.ndarray | None = None

    @property
    def slots(self) -> list[Slot]:
        return [Slot(self.data[i].tobytes()) for i in range(self.db_size)]

    def metadata(self) -> DBMetadata:
        return DBMetadata(self.slot_bytes, self.db_size)

    def build_for_data_with_slot_size(self, data: list[str], slot_size: int) -> None:
        """One row per string, its latin-1 bytes cut or zero-padded to
        slot_size."""
        self.slot_bytes = slot_size
        self.db_size = len(data)
        arr = np.zeros((len(data), slot_size), dtype=np.uint8)
        for i, s in enumerate(data):
            b = s.encode("latin-1")[:slot_size]
            arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        self.data = arr

    def set_keywords(self, keywords) -> None:
        self.keywords = np.asarray(keywords, dtype=np.uint64)


def new_database() -> Database:
    return Database()


def generate_random_db(size: int, num_bytes: int) -> Database:
    db = Database(slot_bytes=num_bytes, db_size=size)
    db.data = np.frombuffer(os.urandom(size * num_bytes), dtype=np.uint8).reshape(
        size, num_bytes
    ).copy()
    return db
