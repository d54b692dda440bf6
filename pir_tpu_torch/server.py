"""``TorchPirServer``: the device-resident 2-server PIR engine
(counterpart of the root-start batch paths and the serving stream of
``pir_tpu/server.py:TpuPirServer``).

Each batch of index shares becomes one payload upload and one pass
through ``models/pipeline.py``, against a table uploaded once in the
storage order of its path:

* fast keys: the chunk-major order of the stacked tail kernel
  (``fast_stacked=True``, the default), or the classic bit-reversed
  order of the per-query tail kernel (``fast_stacked=False``);
  batch-shared and distinct PRF keys both go either way;
* reference-exact (compat) keys: the order of the compat-stage cascade,
  in slices of at most ``COMPAT_BATCH_CAP`` queries.

Every table pads its rows with zero bytes to a multiple of 4, the width
the kernels read; answers are sliced back to the row's bytes.
``fast_serving_stream()`` serves fast batches with a one-batch lag, in
the stacked mode or through the fused scan + tail kernel. A batch this
engine cannot serve raises; there is no other path.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .database import Database
from .dpf import host as dpf_host
from .dpf.device import (
    _compat_perm,
    _fast_leaf_perm_root,
    _fast_leaf_perm_root_stacked,
    compat_skip_levels,
    compat_stage_plan,
    make_compat_payload_batch,
    make_fast_payload_batch,
    scatter_rows_to_storage_order,
)
from .models.pipeline import (
    check_overlap_layout,
    fused_compat_root_batch,
    fused_fast_overlap_step,
    fused_fast_root_batch_pertail,
    fused_fast_root_batch_stacked,
    payload_tensor,
    stacked_fast_geometry,
)
from .ops.compat_stage import MAX_TAIL
from .ops.scan import pad_cols_u8, pad_rows_u8
from .query import QueryShare, SecretSharedQueryResult
from .slot import Slot
from .utils import pad_tile
from .utils.bits import num_bits_for_height

# The compat stage cascade (dpf.device.compat_stage_plan): at most this
# many lane words per chunk (the head walks 5 + log2(w) levels, and w
# shrinks until a stage is left), at most the kernel's MAX_TAIL levels
# per stage, this many queries per stage launch and per dispatched
# slice. The chunk bounds the stage buffers and changes no output byte:
# 64 queries make a first-stage launch of 1024 blocks (~8 per SM of an
# H100) and keep the second stage's seed planes at 256 MiB (4 MiB a
# query on the 1 GiB table); see PERF.md.
COMPAT_MAX_W = 128
COMPAT_MAX_TAIL = MAX_TAIL
COMPAT_Q_CHUNK = 64
COMPAT_BATCH_CAP = 1024


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
    """Device-resident PIR server answering 2-party index batches of fast
    and of reference-exact (compat) keys.

    device: a CUDA device by default; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU. With no device given and no GPU
    present the constructor raises.

    fast_stacked: fast batches go through the stacked tail kernel (the
    default) or, when False, through the per-query tail kernel of
    ``tail_levels`` levels (at most depth - 5) against the classic table.
    The serving stream follows the same switch (``fast_serving_stream``).

    Compat batches run the stage cascade of ``dpf.device.compat_stage_plan``
    at the geometry of ``_compat_geometry`` (see the COMPAT_* constants).
    """

    # batches below this pad up to it (one minimum batch shape)
    MIN_BATCH = 8
    # storage tables pad their rows to a multiple of this (as TpuPirServer's
    # default mxu_block, so the two tables are equal bytes)
    ROW_BLOCK = 8192

    def __init__(self, db: Database, device: str | torch.device | None = None,
                 fast_nonshared_chunk: int = 1024, fast_stacked: bool = True,
                 tail_levels: int = 5):
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
        self.fast_stacked = fast_stacked
        self.tail_levels = tail_levels
        self._tables: dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    def _storage_table(self, key, group_size: int, perm, flat: int,
                       row_block: int) -> torch.Tensor:
        """The cached u8 table `key`: rows scattered to their flat bit
        positions perm() (zero rows elsewhere, XOR-neutral), padded with
        zero rows to a multiple of `row_block` and with zero bytes to a
        multiple of 4 a row, on the server's device."""
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                h = self.db.db_size // group_size
                rows = self.db.data[: h * group_size].reshape(h, group_size * self.db.slot_bytes)
                sc = scatter_rows_to_storage_order(rows, perm(), flat)
                table = torch.from_numpy(pad_cols_u8(pad_rows_u8(sc, row_block))).to(self.device)
                self._tables[key] = table
        return table

    def _root_table_u8(self, group_size: int, depth: int, n_blk: int = 1,
                       stacked: bool = True) -> torch.Tensor:
        """Storage-ordered raw u8 table for the fast paths, zero-padded to
        a multiple of ROW_BLOCK rows: the chunk-major flat order of the
        stacked tail kernel, or with ``stacked=False`` the classic
        bit-reversed order of the per-query tail kernel."""
        h = self.db.db_size // group_size
        flat = (128 * n_blk) << depth
        if stacked:
            tail = stacked_fast_geometry(depth, n_blk)[1]
            return self._storage_table(
                (group_size, depth, n_blk, tail), group_size,
                lambda: _fast_leaf_perm_root_stacked(depth, h, n_blk, tail), flat, self.ROW_BLOCK)
        return self._storage_table(("classic", group_size, depth, n_blk), group_size,
                                   lambda: _fast_leaf_perm_root(depth, h, n_blk), flat,
                                   self.ROW_BLOCK)

    def _compat_root_table_u8(self, group_size: int, device_bits: int, w: int,
                              tails: tuple[int, ...]) -> torch.Tensor:
        """Storage-ordered raw u8 table for the compat stage cascade: rows
        scattered in the cascade's walk order, zero-padded to a multiple
        of min(2048, 2^device_bits) rows."""
        h = self.db.db_size // group_size
        flat = 1 << device_bits
        return self._storage_table(("compat", group_size, device_bits, w, tails), group_size,
                                   lambda: _compat_perm(device_bits, h, w, tails), flat,
                                   min(2048, flat))

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

    def _compat_device_bits(self, group_size: int) -> int:
        h = self.db.db_size // group_size
        nb = num_bits_for_height(h)
        return nb - compat_skip_levels(nb, h)

    def _compat_geometry(self, group_size: int) -> tuple[int, int, tuple[int, ...]]:
        """(device_bits, lane words w, stage tails) of the compat cascade:
        w is the largest power of two <= COMPAT_MAX_W whose 5 + log2(w)
        head levels leave at least one stage (needs device_bits >= 6)."""
        nbd = self._compat_device_bits(group_size)
        w = min(COMPAT_MAX_W, 1 << max(0, nbd - 6))
        return nbd, w, compat_stage_plan(nbd, w, COMPAT_MAX_TAIL)[1]

    def _compat_applicable(self, queries: list[QueryShare]) -> bool:
        """The compat stage cascade needs a batch of at least MIN_BATCH
        and a head of >= 5 levels followed by a stage: device_bits >= 6."""
        q0 = queries[0]
        if q0.key_fast is not None or q0.is_keyword_based or len(queries) < self.MIN_BATCH:
            return False
        return self._compat_device_bits(q0.group_size) >= 6

    def _validate_batch(self, queries: list[QueryShare]) -> None:
        if not queries:
            raise ValueError("empty batch")
        q0 = queries[0]
        g = q0.group_size
        if q0.is_keyword_based or (q0.key_fast is None and q0.key_two_party is None):
            raise NotImplementedError("the port serves 2-party index queries only")
        fast = q0.key_fast is not None
        if fast:
            validate_fast_key_geometry(q0.key_fast, self.db.db_size // g)
        lb = q0.key_fast.leaf_bits if fast else None
        # a compat key's level count sizes its expansion (2^levels bits),
        # so a crafted key must fail here instead of driving allocations
        nb = None if fast else num_bits_for_height(self.db.db_size // g)
        for query in queries:
            if query.group_size != g or not query.is_two_party or query.is_keyword_based:
                raise ValueError("batch requires uniform 2-party index queries")
            if (query.key_fast is not None) != fast:
                raise ValueError("batch cannot mix fast and compat queries")
            if fast and query.key_fast.leaf_bits != lb:
                raise ValueError("batch cannot mix fast-key leaf widths")
            if not fast and len(query.key_two_party.cw) != nb:
                raise ValueError("compat key geometry does not match the database")
        if fast and not self._fast_root_applicable(queries):
            raise NotImplementedError(
                "fast keys of depth < 5 have no root-start device path in the port")
        if not fast and not self._compat_applicable(queries):
            raise ValueError(
                f"compat batches below {self.MIN_BATCH} queries or of at most 5 device "
                "levels take the preplane or per-query paths of pir_tpu, not yet ported")

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
        pay_t = payload_tensor(pay, self.device)
        if self.fast_stacked:
            return fused_fast_root_batch_stacked(self._root_table_u8(g, depth, n_blk), pay_t,
                                                 layout)
        return fused_fast_root_batch_pertail(self._root_table_u8(g, depth, n_blk, stacked=False),
                                             pay_t, layout, self.tail_levels)

    def _dispatch_compat(self, queries: list[QueryShare]) -> torch.Tensor:
        """Dispatch a uniform compat batch through the stage cascade, in
        slices of at most COMPAT_BATCH_CAP queries; returns the (Q,
        row_bytes) uint8 device tensor (not yet fetched)."""
        g = queries[0].group_size
        h = self.db.db_size // g
        nbd, w, tails = self._compat_geometry(g)
        table = self._compat_root_table_u8(g, nbd, w, tails)
        outs = []
        for i in range(0, len(queries), COMPAT_BATCH_CAP):
            pay, layout = make_compat_payload_batch(queries[i:i + COMPAT_BATCH_CAP], height=h)
            outs.append(fused_compat_root_batch(table, payload_tensor(pay, self.device), layout,
                                                w=w, tails=tails, q_chunk=COMPAT_Q_CHUNK))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def private_secret_shared_query_batch_async(self, queries: list[QueryShare]):
        """Dispatch a batch without waiting for the device; returns a
        zero-arg callable producing the results."""
        self._validate_batch(queries)
        g, n = queries[0].group_size, len(queries)
        if queries[0].key_fast is None:
            out_dev = self._dispatch_compat(queries)
        else:
            out_dev = self._dispatch_fast_root(queries)
        return lambda: self._slice_batch_results(out_dev.cpu().numpy(), g, n)

    def private_secret_shared_query_batch(
        self, queries: list[QueryShare]
    ) -> list[SecretSharedQueryResult]:
        """Answer a batch of same-shape index queries."""
        return self.private_secret_shared_query_batch_async(queries)()

    def fast_serving_stream(self) -> "FastServingStream":
        """Open a steady-state fast-mode serving stream: submit(k)
        dispatches batch k and returns a future of batch k-1's results
        (one-batch lag); flush() drains the last batch. Batches must keep
        one shape (size, group size, depth).

        With fast_stacked (the default) each batch rides the batch API's
        dispatch: wide-leaf keys and distinct-key batches are served.
        With fast_stacked=False batch k's scan runs in the same kernel as
        batch k+1's tail (ops/fused.py): 128-bit leaves and batch-shared
        PRF keys only.
        """
        return FastServingStream(self)


class FastServingStream:
    """See TorchPirServer.fast_serving_stream."""

    def __init__(self, server: TorchPirServer):
        self._srv = server
        self._mode = None  # "stacked" | "fused", decided on the first submit
        self._shape = None  # (Q, group, depth) [+ layout in fused mode]
        self._pending = None  # stacked: (out_dev, queries) not yet drained
        self._words = None  # fused: the previous batch's selection words
        self._prev = None  # fused: the previous batch's queries
        self._table_key = None

    def _table(self) -> torch.Tensor:
        """The serving table, resolved at every dispatch (not pinned at
        stream start), so a rebuilt table reaches an open stream."""
        return self._srv._root_table_u8(*self._table_key, stacked=False)

    def _check_uniform(self, queries: list[QueryShare]) -> tuple:
        srv = self._srv
        if not queries:
            raise ValueError("empty batch")
        q0 = queries[0]
        if q0.key_fast is None or q0.is_keyword_based:
            raise ValueError("stream serves fast-mode index queries only")
        if not srv._fast_root_applicable(queries):
            raise ValueError("stream needs the root-start fast path (depth >= 5)")
        srv._validate_batch(queries)
        return (len(queries), q0.group_size, q0.key_fast.depth)

    def _prepare(self, queries: list[QueryShare]) -> torch.Tensor:
        """Fused mode: validate a batch and build its device payload; the
        first batch fixes the stream's shape and zero selection words.
        Nothing changes when the batch is refused."""
        srv = self._srv
        shape = self._check_uniform(queries)
        if not srv._batch_shares_prf_keys(queries):
            raise ValueError("stream batches need batch-shared PRF keys")
        pay, layout = make_fast_payload_batch(queries, shared_rk=True)
        shape = shape + (layout,)
        if self._shape is None:
            check_overlap_layout(layout)
            q0 = queries[0]
            self._table_key = (q0.group_size, q0.key_fast.depth, q0.key_fast.leaf_bits // 128)
            rows = self._table().shape[0]
            self._words = torch.zeros((rows // 32, len(queries)), dtype=torch.int32,
                                      device=srv.device)
            self._shape = shape
        elif shape != self._shape:
            raise ValueError(f"stream batches must keep one shape: "
                             f"{shape[:3]} != {self._shape[:3]}")
        return payload_tensor(pay, srv.device)

    def _step(self, payloads: torch.Tensor) -> torch.Tensor:
        out_prev, self._words = fused_fast_overlap_step(
            self._table(), self._words, payloads, self._shape[3], self._srv.tail_levels)
        return out_prev

    def _future(self, out_dev: torch.Tensor, queries: list[QueryShare]):
        g, n = queries[0].group_size, len(queries)
        return lambda: self._srv._slice_batch_results(out_dev.cpu().numpy(), g, n)

    def submit(self, queries):
        """Dispatch a batch; returns a zero-arg callable resolving the
        previous batch's results (None for the first submit). A refused
        batch raises and leaves the pending batch answerable."""
        queries = list(queries)
        mode = self._mode or ("stacked" if self._srv.fast_stacked else "fused")
        if mode == "fused":
            pay = self._prepare(queries)
            self._mode = mode
            out_prev = self._step(pay)
            prev, self._prev = self._prev, queries
            return None if prev is None else self._future(out_prev, prev)
        shape = self._check_uniform(queries)
        if self._shape is not None and shape != self._shape:
            raise ValueError(f"stream batches must keep one shape: {shape} != {self._shape}")
        out_dev = self._srv._dispatch_fast_root(queries)
        self._mode, self._shape = mode, shape
        prev, self._pending = self._pending, (out_dev, queries)
        return None if prev is None else self._future(*prev)

    def flush(self):
        """Drain the last submitted batch: its results' future, or None
        if the stream is empty. Fused mode scans it beside the tail of a
        zero payload, whose words are discarded."""
        if self._mode == "stacked":
            if self._pending is None:
                return None
            (out, queries), self._pending = self._pending, None
            self._shape = self._mode = None
            return self._future(out, queries)
        if self._prev is None:
            return None
        zeros = torch.zeros((self._shape[0], self._shape[3].total), dtype=torch.int32,
                            device=self._srv.device)
        out_last = self._step(zeros)
        prev, self._prev = self._prev, None
        self._words = self._shape = self._mode = None
        return self._future(out_last, prev)
