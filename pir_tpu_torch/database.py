"""Database: slots as a dense ``(db_size, slot_bytes) uint8`` numpy array
(counterpart of ``pir_tpu/database.py``). The server engine uploads it
once to the device."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class DBMetadata:
    """Layout info shared by client and server."""

    slot_bytes: int = 0
    db_size: int = 0


@dataclass
class Database(DBMetadata):
    data: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint8))

    def metadata(self) -> DBMetadata:
        return DBMetadata(self.slot_bytes, self.db_size)


def generate_random_db(size: int, num_bytes: int) -> Database:
    db = Database(slot_bytes=num_bytes, db_size=size)
    db.data = np.frombuffer(os.urandom(size * num_bytes), dtype=np.uint8).reshape(
        size, num_bytes
    ).copy()
    return db
