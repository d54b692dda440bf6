"""``TorchPirServer``: the device-resident fast-mode 2-server PIR engine
(counterpart of the stacked fast root-start path of
``pir_tpu/server.py:TpuPirServer``).

The table is uploaded once, in the chunk-major storage order of the
stacked tail kernel; each batch of fast-mode index shares becomes one
payload upload and one pass through ``models/pipeline.py``. Batch-shared
and distinct PRF keys both go this way. A batch this engine cannot
serve raises; there is no other path.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .database import Database
from .dpf import host as dpf_host
from .dpf.device import (
    _fast_leaf_perm_root_stacked,
    make_fast_payload_batch,
    scatter_rows_to_storage_order,
)
from .models.pipeline import (
    fused_fast_root_batch_stacked,
    payload_tensor,
    stacked_fast_geometry,
)
from .ops.scan import pad_rows_u8
from .query import QueryShare, SecretSharedQueryResult
from .slot import Slot
from .utils import pad_tile


def validate_fast_key_geometry(key_fast, dim_height: int) -> None:
    """Reject fast keys whose geometry disagrees with the database: depth
    and leaf width drive the table layout and allocations, so a crafted
    key must fail instead of driving giant allocations."""
    lb = key_fast.leaf_bits
    if lb < 128 or lb & (lb - 1):
        raise ValueError("unsupported fast-key leaf width")
    if (key_fast.height != dim_height
            or lb > max(128, 1 << max(0, dim_height - 1).bit_length())
            or key_fast.depth != dpf_host.fast_depth_for_height(dim_height, lb)):
        raise ValueError("fast key geometry does not match the database")


class TorchPirServer:
    """Device-resident PIR server answering fast-mode index batches.

    device: a CUDA device by default; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU. With no device given and no GPU
    present the constructor raises.
    """

    # batches below this pad up to it (one minimum batch shape)
    MIN_BATCH = 8
    # storage tables pad their rows to a multiple of this (as TpuPirServer's
    # default mxu_block, so the two tables are equal bytes)
    ROW_BLOCK = 8192

    def __init__(self, db: Database, device: str | torch.device | None = None,
                 fast_nonshared_chunk: int = 1024):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchPirServer needs a CUDA device; pass device='cpu' "
                    "to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {self.device}")
        self.db = db
        # distinct-key batches materialise per-step round-key operands
        # (~2.9 MB per 32-query step), so they run in chunks of this size
        self.fast_nonshared_chunk = fast_nonshared_chunk
        self._tables: dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    def _root_table_u8(self, group_size: int, depth: int, n_blk: int = 1) -> torch.Tensor:
        """Storage-ordered raw u8 table for the stacked fast path: rows
        scattered into the chunk-major flat order of the stacked tail
        kernel, zero-padded to a multiple of ROW_BLOCK rows."""
        tail = stacked_fast_geometry(depth, n_blk)[1]
        key = (group_size, depth, n_blk, tail)
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                h = self.db.db_size // group_size
                row_bytes = group_size * self.db.slot_bytes
                flat = (128 * n_blk) << depth
                perm = _fast_leaf_perm_root_stacked(depth, h, n_blk, tail)
                rows = self.db.data[: h * group_size].reshape(h, row_bytes)
                sc = scatter_rows_to_storage_order(rows, perm, flat)
                table = torch.from_numpy(pad_rows_u8(sc, self.ROW_BLOCK)).to(self.device)
                self._tables[key] = table
        return table

    def _slice_batch_results(self, out: np.ndarray, group_size: int,
                             n: int) -> list[SecretSharedQueryResult]:
        sb = self.db.slot_bytes
        return [
            SecretSharedQueryResult(
                sb,
                [Slot(out[i, c * sb:(c + 1) * sb].tobytes()) for c in range(group_size)],
            )
            for i in range(n)
        ]

    @staticmethod
    def _fast_root_applicable(queries: list[QueryShare]) -> bool:
        """Root-start expansion needs >= one full 32-bit word of leaves
        (depth >= 5)."""
        q0 = queries[0]
        return (q0.key_fast is not None and not q0.is_keyword_based
                and q0.key_fast.depth >= 5)

    @staticmethod
    def _batch_shares_prf_keys(queries: list[QueryShare]) -> bool:
        """True when every share carries the same PRF keys. Batch keygen
        hands every share the same key list object, so the common case
        is O(Q) identity checks; bytes are compared only for shares from
        distinct keygens."""
        p0 = queries[0].prf_keys
        sig0 = None
        for s in queries[1:]:
            if s.prf_keys is p0:
                continue
            if sig0 is None:
                sig0 = tuple(bytes(k.bytes) for k in p0)
            if tuple(bytes(k.bytes) for k in s.prf_keys) != sig0:
                return False
        return True

    def _validate_batch(self, queries: list[QueryShare]) -> None:
        if not queries:
            raise ValueError("empty batch")
        q0 = queries[0]
        g = q0.group_size
        if q0.key_fast is None or q0.is_keyword_based:
            raise NotImplementedError("the port serves fast-mode index queries only")
        validate_fast_key_geometry(q0.key_fast, self.db.db_size // g)
        lb = q0.key_fast.leaf_bits
        for query in queries:
            if query.group_size != g or not query.is_two_party or query.is_keyword_based:
                raise ValueError("batch requires uniform 2-party index queries")
            if query.key_fast is None:
                raise ValueError("batch cannot mix fast and compat queries")
            if query.key_fast.leaf_bits != lb:
                raise ValueError("batch cannot mix fast-key leaf widths")
        if not self._fast_root_applicable(queries):
            raise NotImplementedError(
                "fast keys of depth < 5 have no root-start device path in the port")

    def _dispatch_fast_root(self, queries: list[QueryShare],
                            shared_rk: bool | None = None) -> torch.Tensor:
        """Dispatch a uniform fast batch; returns the (Q, row_bytes) uint8
        device tensor (not yet fetched)."""
        g = queries[0].group_size
        depth = queries[0].key_fast.depth
        n_blk = queries[0].key_fast.leaf_bits // 128
        cap = self.fast_nonshared_chunk
        if shared_rk is None:
            shared_rk = self._batch_shares_prf_keys(queries)
        # pad small batches to the threshold; shared_rk is resolved first,
        # since tiling duplicates q0 and must not flip a distinct-key batch
        # to the shared layout. Distinct-key batches pad only up to the
        # chunk cap, or the chunk split below would recurse on its padding.
        pad_to = self.MIN_BATCH if shared_rk else min(self.MIN_BATCH, cap)
        if len(queries) < pad_to:
            queries = pad_tile(queries, pad_to)
        if not shared_rk and len(queries) > cap:
            outs = []
            for s0 in range(0, len(queries), cap):
                part = queries[s0:s0 + cap]
                take = len(part)
                if take < cap:
                    part = pad_tile(part, cap)
                outs.append(self._dispatch_fast_root(part, shared_rk=False)[:take])
            return torch.cat(outs, dim=0)
        pay, layout = make_fast_payload_batch(queries, shared_rk=shared_rk)
        table = self._root_table_u8(g, depth, n_blk)
        return fused_fast_root_batch_stacked(table, payload_tensor(pay, self.device), layout)

    def private_secret_shared_query_batch_async(self, queries: list[QueryShare]):
        """Dispatch a batch without waiting for the device; returns a
        zero-arg callable producing the results."""
        self._validate_batch(queries)
        out_dev = self._dispatch_fast_root(queries)
        g, n = queries[0].group_size, len(queries)
        return lambda: self._slice_batch_results(out_dev.cpu().numpy(), g, n)

    def private_secret_shared_query_batch(
        self, queries: list[QueryShare]
    ) -> list[SecretSharedQueryResult]:
        """Answer a batch of same-shape fast-mode index queries."""
        return self.private_secret_shared_query_batch_async(queries)()
