"""Keyword PIR over a search tree of index queries (counterpart of
``pir_tpu/keyword.py``, reference keyword.go), over the port's own
server and database.

``PrivateSqrtST``: the first layer is sqrt(N) boundary keys held in the
clear (the client scans them), the second the sorted data as an
index-PIR database queried with group_size = height (one whole row of
sqrt(N) slots a query). Needs perfect-square, reverse-sorted input
(keyword.go:37-50). ``PrivateBST`` walks a level-order binary search
tree instead: one single-slot PIR query a level, then the data query.

Both answer their PIR queries through a ``TorchPirServer`` over the
layer, built at first use on the tree's ``device``: a CUDA device
unless the tree is made with ``device="cpu"``.

The other keyword mechanism, a DPF over the 32-bit keyword space, lives
in the query and server layers (``query.new_keyword_query_shares``,
``Database.set_keywords``; db.go:119-135). The sqrt tree's encrypted
(Paillier) query runs the host cPIR scan of ``encrypted.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .database import Database, DBMetadata, new_database
from .server import TorchPirServer
from .slot import Slot, get_required_slot_size, new_slot_from_string

PADDING = "\x00"  # keyword.go:9


@dataclass
class PrivateSqrtST:
    first_layer: list[str] = field(default_factory=list)
    second_layer: Database | None = None
    num_keys: int = 0
    slot_bytes: int = 0
    width: int = 0
    height: int = 0
    device: str | None = None  # the second layer's server: a CUDA device unless "cpu"
    _server: TorchPirServer | None = field(default=None, init=False, repr=False, compare=False)

    def build_for_data(self, data: list[str]) -> None:
        """keyword.go:34-73. Raises ValueError on bad input (Go errors)."""
        n = len(data)
        if math.isqrt(n) ** 2 != n:
            raise ValueError("length of data is not a perfect square")
        for i in range(n - 1):
            if data[i] < data[i + 1]:
                raise ValueError("data not sorted")
        sqrt_dim = math.isqrt(n)
        boundaries = [data[i] for i in range(sqrt_dim, n, sqrt_dim)]
        boundaries.append(data[n - 1])
        db = new_database()
        db.build_for_data_with_slot_size(data, get_required_slot_size(data))
        self.first_layer = boundaries
        self.second_layer = db
        self._server = None
        self.slot_bytes = get_required_slot_size(boundaries)
        self.num_keys = n
        self.width = sqrt_dim
        self.height = sqrt_dim

    def get_second_layer_metadata(self) -> DBMetadata:
        return self.second_layer.metadata()

    def server(self) -> TorchPirServer:
        """The TorchPirServer over the second layer on self.device, built
        once."""
        if self._server is None:
            self._server = TorchPirServer(self.second_layer, device=self.device)
        return self._server

    def private_query(self, query, server: TorchPirServer | None = None):
        """PIR over the second layer (keyword.go:76-81): through `server`
        (a TorchPirServer over self.second_layer) or self.server()."""
        return (server or self.server()).private_secret_shared_query(query)

    def private_encrypted_query(self, query):
        """cPIR over the second layer (keyword.go:84-90), on the default
        cPIR engine on self.device."""
        from .encrypted import private_encrypted_query

        return private_encrypted_query(self.second_layer, query, device=self.device)

    def find_bucket(self, key: str) -> int:
        """First-layer scan: the bucket that may hold `key`."""
        row_index = 0
        for row_index, boundary in enumerate(self.first_layer):
            if key > boundary:
                break
        return row_index

    def find_in_row(self, row: list[Slot], key: str) -> int:
        """Scan a recovered row for the key; returns the column index."""
        query_slot = new_slot_from_string(key, self.slot_bytes)
        col = 0
        for col, slot in enumerate(row):
            if slot.compare(query_slot) <= 0:
                break
        return col


def new_private_sqrt_st(device: str | None = None) -> PrivateSqrtST:
    return PrivateSqrtST(device=device)


@dataclass
class PrivateBST:
    """Keyword PIR over a level-order binary search tree: log2(N) levels,
    one single-slot PIR query a level against that level's boundary
    database, then the data query (keyword.go:14-16 names it as future
    work). Each level's query is an independent PIR query; the access
    pattern (one query a level) does not depend on the data. Needs
    power-of-two, descending-sorted input."""

    levels: list[Database] = field(default_factory=list)  # level l: 2^l keys
    data_layer: Database | None = None
    num_keys: int = 0
    depth: int = 0
    device: str | None = None  # the levels' servers: a CUDA device unless "cpu"
    _level_servers: dict[int, TorchPirServer] = field(default_factory=dict, init=False,
                                                      repr=False, compare=False)

    def build_for_data(self, data: list[str]) -> None:
        n = len(data)
        if n & (n - 1):
            raise ValueError("length of data is not a power of two")
        for i in range(n - 1):
            if data[i] < data[i + 1]:
                raise ValueError("data not sorted")
        self.num_keys = n
        self.depth = n.bit_length() - 1
        slot = get_required_slot_size(data)
        self.levels = []
        for lvl in range(self.depth):
            step = n >> (lvl + 1)
            # node j's boundary key at level lvl: data[(2j + 1) * step]
            db = new_database()
            db.build_for_data_with_slot_size([data[(2 * j + 1) * step] for j in range(1 << lvl)],
                                             slot)
            self.levels.append(db)
        self.data_layer = new_database()
        self.data_layer.build_for_data_with_slot_size(data, slot)
        self._level_servers = {}

    def level_server(self, level: int) -> TorchPirServer:
        """The TorchPirServer over one level's database on self.device,
        built once."""
        if level not in self._level_servers:
            self._level_servers[level] = TorchPirServer(self.levels[level], device=self.device)
        return self._level_servers[level]

    def private_level_query(self, level: int, query):
        """Answer one level's boundary-key query through level_server."""
        return self.level_server(level).private_secret_shared_query(query)

    def lookup(self, key: str, query_level, query_data) -> tuple[int, list]:
        """Walk the tree with the caller's PIR oracles: query_level(lvl,
        index) -> the Slot at that node, query_data(index) -> the
        recovered data slots. Descending order: go left (bit 0) when key
        > boundary. Returns (index, slots)."""
        node = 0
        probe = new_slot_from_string(key, self.data_layer.slot_bytes)
        for lvl in range(self.depth):
            boundary = query_level(lvl, node)
            node = 2 * node + (0 if boundary.compare(probe) < 0 else 1)
        return node, query_data(node)


def new_private_bst(device: str | None = None) -> PrivateBST:
    return PrivateBST(device=device)


def pad_to_power_of_2(data: list[str]) -> list[str]:
    """keyword.go:100-114."""
    next_power = int(math.pow(2, math.ceil(math.log2(len(data)))))
    return [data[i] if i < len(data) else PADDING for i in range(next_power)]


def pad_to_sqrt(data: list[str]) -> list[str]:
    """keyword.go:116-131."""
    next_sqrt = int(math.ceil(math.sqrt(len(data))))
    next_sqrt *= next_sqrt
    return [data[i] if i < len(data) else PADDING for i in range(next_sqrt)]
