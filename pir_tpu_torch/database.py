"""Database: slots as a dense ``(db_size, slot_bytes) uint8`` numpy array
and, for keyword queries, one uint64 keyword per row (counterpart of
``pir_tpu/database.py``). The server engine uploads it once to the
device; ``update_slots`` changes rows, ``save`` / ``load`` checkpoint it."""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

from .slot import Slot, get_required_slot_size


@dataclass
class DBMetadata:
    """Layout info shared by client and server."""

    slot_bytes: int = 0
    db_size: int = 0

    # ---- grid dimensions (db.go:396-446) ----

    def index_to_coordinates(self, index: int, width: int, height: int):
        return index // width, index % width

    def get_dimensions_for_database(self, height: int, group_size: int):
        """(width * group_size, height) of the grid (db.go:403-420); the
        reference's float-of-integer-division makes every ceil a floor,
        kept here as integer division."""
        dim_width = self.db_size // (height * group_size)
        if dim_width == 0:
            dim_width = 1
        dim_height = self.db_size // (dim_width * group_size)
        return dim_width * group_size, dim_height

    def get_sqrt_of_db_size(self) -> int:
        return int(math.sqrt(self.db_size) + 1)


def get_optimal_db_dimensions(slot_size: int, db_size: int):
    """Bandwidth-optimal grid (db.go:425-434)."""
    height = int(max(1, math.sqrt(db_size * slot_size)))
    width = math.ceil(db_size / height)
    return int(width), int(height)


def get_optimal_weighted_db_dimensions(slot_size: int, db_size: int, weight: int):
    width, height = get_optimal_db_dimensions(slot_size, db_size)
    return int(width / weight), int(math.ceil(height * weight))


@dataclass
class Database(DBMetadata):
    data: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint8))
    # uint64, keyword r of grid row r for keyword queries (db.go:119-135)
    keywords: np.ndarray | None = None

    @property
    def slots(self) -> list[Slot]:
        return [Slot(self.data[i].tobytes()) for i in range(self.db_size)]

    def slot(self, i: int) -> Slot:
        return Slot(self.data[i].tobytes())

    def metadata(self) -> DBMetadata:
        return DBMetadata(self.slot_bytes, self.db_size)

    def build_for_data(self, data: list[str]) -> None:
        self.build_for_data_with_slot_size(data, get_required_slot_size(data))

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

    def update_slots(self, updates: dict[int, bytes], *,
                     copy_on_write: bool = False) -> None:
        """Slot updates ``{index: new_bytes}``, each zero-padded to
        slot_bytes (pir_tpu/database.py:92-131). A server holding tables on
        the device must be told too: ``TorchPirServer.apply_updates``.

        copy_on_write=True patches a fresh copy and swaps ``self.data`` in
        one attribute store, so a reader of the old array never sees a torn
        row; the default mutates in place and refuses read-only (mmap-loaded)
        rows."""
        target = np.array(self.data) if copy_on_write else self.data
        if not target.flags.writeable:
            raise ValueError(
                "database rows are read-only (mmap load); "
                "load(mmap=False) or update_slots(copy_on_write=True)"
            )
        for idx, payload in updates.items():
            if not 0 <= idx < self.db_size:
                raise IndexError(f"slot index {idx} out of range")
            b = bytes(payload.data if isinstance(payload, Slot) else payload)
            if len(b) > self.slot_bytes:
                raise ValueError(
                    f"update for slot {idx} is {len(b)} bytes; "
                    f"slots hold {self.slot_bytes}"
                )
            row = np.zeros(self.slot_bytes, dtype=np.uint8)
            row[: len(b)] = np.frombuffer(b, dtype=np.uint8)
            target[idx] = row
        if copy_on_write:
            self.data = target

    def save(self, path: str, *, mmap_capable: bool = False) -> None:
        """Checkpoint to `path` (.npz), in pir_tpu's format. With
        mmap_capable=True the rows go to a raw sibling ``.data.npy`` that
        ``load(..., mmap=True)`` maps instead of reading."""
        if mmap_capable:
            np.save(self._data_path(path), np.ascontiguousarray(self.data))
            data = np.zeros((0, 0), dtype=np.uint8)
        else:
            data = self.data
        np.savez_compressed(
            path,
            data=data,
            keywords=self.keywords if self.keywords is not None else np.zeros(0),
            meta=np.array([self.slot_bytes, self.db_size], dtype=np.int64),
            out_of_line=np.array([mmap_capable]),
        )

    @staticmethod
    def _data_path(path: str) -> str:
        base = path[:-4] if path.endswith(".npz") else path
        return base + ".data.npy"

    @staticmethod
    def load(path: str, *, mmap: bool = False) -> "Database":
        """Restore a checkpoint. mmap=True maps an mmap_capable checkpoint's
        rows read-only; it is ignored for in-line checkpoints."""
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        slot_bytes, db_size = (int(x) for x in z["meta"])
        db = Database(slot_bytes=slot_bytes, db_size=db_size)
        if "out_of_line" in z.files and bool(z["out_of_line"][0]):
            db.data = np.load(Database._data_path(path),
                              mmap_mode="r" if mmap else None)
        else:
            db.data = z["data"]
        kw = z["keywords"]
        if kw.size:
            db.keywords = kw.astype(np.uint64)
        return db


def new_database() -> Database:
    return Database()


def generate_random_db(size: int, num_bytes: int) -> Database:
    db = Database(slot_bytes=num_bytes, db_size=size)
    db.data = np.frombuffer(os.urandom(size * num_bytes), dtype=np.uint8).reshape(
        size, num_bytes
    ).copy()
    return db


def generate_empty_db(size: int, num_bytes: int) -> Database:
    db = Database(slot_bytes=num_bytes, db_size=size)
    db.data = np.zeros((size, num_bytes), dtype=np.uint8)
    return db
