"""``TorchPirServer``: the device-resident 2-server PIR engine
(counterpart of the single-query API, the batch paths and the serving
stream of ``pir_tpu/server.py:TpuPirServer``), and the host golden model
of its answers (the module-level ``expand_shared_query``,
``private_secret_shared_query_with_expanded_bits`` and
``private_secret_shared_query``, numpy).

Each batch of index shares becomes one payload upload and one pass
through ``models/pipeline.py``, against a table uploaded once in the
storage order of its path:

* fast keys: the chunk-major order of the stacked tail kernel
  (``fast_stacked=True``, the default), or the classic bit-reversed
  order of the per-query tail kernel (``fast_stacked=False``);
  batch-shared and distinct PRF keys both go either way;
* reference-exact (compat) keys: the order of the compat-stage cascade,
  in slices of at most ``COMPAT_BATCH_CAP`` queries; on a table of 5
  device levels, too shallow for a stage, the bit-reversed row order of
  the preplane route, whose whole walk runs in plain torch and whose
  scan is the bit-plane scan kernel.

Every storage table pads its rows with zero bytes to a multiple of 4,
the width the kernels read; answers are sliced back to the row's bytes.
Fast batches of at most MIN_BATCH queries scan with the masked-XOR scan
kernel instead of the packed scan.

Single queries (``private_secret_shared_query``,
``expand_shared_query`` + ``private_secret_shared_query_with_expanded_bits``)
and the batches the root-start paths do not take (compat batches below
MIN_BATCH, compat tables of fewer than 5 device levels, fast keys of
depth < 5) run per query: the host walks the first levels, the device the rest,
and the masked-XOR scan kernel reads the natural-order word table
(``_table``). ``fast_serving_stream()`` serves fast batches with a
one-batch lag, in the stacked mode or through the fused scan + tail
kernel.

Keyword shares (2-party, the 32-bit keyword domain evaluated at each
row's keyword) and multi-party shares (>= 3 servers, index or keyword)
expand per query on the device (``dpf/device.py``: the point walk, the
multi-party PRG walk) and scan with the masked-XOR scan kernel; a
keyword batch runs one point walk for its queries and scans with the
bit-plane scan kernel (``ops/planes_scan.py``) the natural table's
bytes. Multi-party batches raise ValueError, as in pir_tpu.

Single-server cPIR (``private_encrypted_query_batch_async``): level-1
Paillier queries (``encrypted.py``) scan with kernel 10 (``crypto/mont.py``)
the level-1 exponent matrix, built from the table; that of the table's
own square-root grid is cached on the device beside the DPF tables.

``apply_updates`` changes slots live: every cached table is patched by a
row scatter into a clone, swapped in under the cache lock.

``NativePirServer`` is the host engine on the native C++/AES-NI library
(``native/``): the same answers from numpy rows, for a caller that names
it (``PirConfig(engine="native")``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import encrypted as enc
from .crypto.mont import (
    ints_to_words,
    mont_scan,
    upload_words,
    word_ctx,
    words_for_modulus,
    words_to_ints,
)
from .database import Database
from .dpf import host as dpf_host
from .dpf.device import (
    _compat_leaf_perm_root,
    _compat_perm,
    _fast_leaf_perm,
    _fast_leaf_perm_root,
    _fast_leaf_perm_root_stacked,
    _leaf_perm,
    compat_skip_levels,
    compat_stage_plan,
    eval_points_bits,
    eval_points_bits_batch,
    eval_points_mp_bits,
    expand_mp_full_domain_bits,
    expand_query_bits,
    make_compat_payload_batch,
    make_device_fast_key,
    make_device_key,
    make_device_point_key,
    make_fast_payload_batch,
    pack_fast_payload,
    pack_key_payload,
    pack_point_bit_planes,
    scatter_rows_to_storage_order,
    u32_tensor,
)
from .models.pipeline import (
    MIN_BATCH,
    check_overlap_layout,
    fused_answer,
    fused_answer_batch,
    fused_compat_preplane_batch,
    fused_compat_root_batch,
    fused_fast_answer_batch,
    fused_fast_answer_storage,
    fused_fast_bits,
    fused_fast_overlap_step,
    fused_fast_root_batch_pertail,
    fused_fast_root_batch_stacked,
    stacked_fast_geometry,
)
from .ops.compat_stage import MAX_TAIL
from .ops.planes_scan import planes_scan
from .ops.scan import pack_rows_u32, pack_table_u32, pad_cols_u8, pad_rows_u8, unpack_result_u32
from .ops.xor_scan import masked_xor_scan
from .query import QueryShare, SecretSharedQueryResult
from .slot import Slot
from .utils import pad_tile
from .utils.bits import num_bits_for_height
from .utils.metrics import next_batch, span

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


def is_index_share(query: QueryShare) -> bool:
    """True for a 2-party index share (fast or compat key), the shares the
    root-start and per-query index paths take; keyword and multi-party
    shares go through the point-eval paths."""
    return query.is_two_party and not query.is_keyword_based


def _num_bits(query: QueryShare, dim_height: int) -> int:
    """The DPF domain of a reference-exact or multi-party share: 32 bits
    for keywords, else the table height's (pir_tpu/server.py:_server_dpf)."""
    return 32 if query.is_keyword_based else num_bits_for_height(dim_height)


def check_share(query: QueryShare, dim_height: int) -> None:
    """Raise ValueError unless `query` carries the key its kind needs, of
    the geometry the table gives it: a key's levels, leaf width and
    sigma rows size the evaluation, so a crafted key must fail here
    instead of driving allocations."""
    if not query.is_two_party:
        key = query.key_multi_party
        if key is None or key.num_parties < 3:
            raise ValueError("a multi-party share needs a KeyMP of >= 3 parties")
        p2, mu, gamma_bits, _ = dpf_host._mp_params(_num_bits(query, dim_height),
                                                    key.num_parties)
        if (len(key.sigma) != 1 << gamma_bits or any(len(r) != 16 * p2 for r in key.sigma)
                or len(key.cw) != p2 or any(len(c) < mu for c in key.cw)):
            raise ValueError("multi-party key geometry does not match the database")
        return
    if query.key_fast is not None:
        if query.is_keyword_based:
            raise ValueError("keyword shares carry reference-exact keys, not fast keys")
        validate_fast_key_geometry(query.key_fast, dim_height)
        return
    if query.key_two_party is None:
        raise ValueError("a 2-party share needs a reference-exact or a fast key")
    if len(query.key_two_party.cw) != _num_bits(query, dim_height):
        kind = "keyword" if query.is_keyword_based else "compat"
        raise ValueError(f"{kind} key geometry does not match the database")


def _keywords(db: Database, dim_height: int) -> np.ndarray:
    """The first dim_height rows' keywords (db.go:119-135)."""
    if db.keywords is None or len(db.keywords) < dim_height:
        raise ValueError("keyword shares need a keyword for every row (Database.set_keywords)")
    return db.keywords[:dim_height]


def expand_shared_query(db: Database, query: QueryShare) -> np.ndarray:
    """Host expansion of a share into (H,) bool selection bits, natural
    row order (db.go:109-174; numpy, the golden model)."""
    dim_height = db.db_size // query.group_size
    check_share(query, dim_height)
    if query.key_fast is not None:
        pf = dpf_host.server_initialize(query.prf_keys, query.key_fast.depth)
        return dpf_host.eval_full_domain_fast_bits(pf, query.key_fast)
    pf = dpf_host.server_initialize(query.prf_keys, _num_bits(query, dim_height))
    if not query.is_two_party:
        points = (_keywords(db, dim_height).astype(np.int64) if query.is_keyword_based
                  else np.arange(dim_height, dtype=np.int64))
        # multi-party outputs are XOR shares, so the direct parity is the
        # bit share; the inverted rule of db.go:157-161 belongs to the
        # 2-party +/- shares (pir_tpu/server.py:76-83)
        return (dpf_host.eval_points_mp(pf, query.key_multi_party, points) & 1) == 1
    if query.is_keyword_based:
        vals = dpf_host.eval_points(pf, query.share_number, query.key_two_party,
                                    _keywords(db, dim_height))
        return (vals & 1) == 0
    return dpf_host.eval_full_domain_bits(pf, query.share_number, query.key_two_party,
                                          dim_height)


def private_secret_shared_query_with_expanded_bits(
    db: Database, query: QueryShare, bits: np.ndarray
) -> SecretSharedQueryResult:
    """The XOR scan over the selected rows (db.go:74-107), in numpy."""
    dim_width = query.group_size
    dim_height = db.db_size // dim_width
    rows = db.data[: dim_height * dim_width].reshape(dim_height, dim_width, db.slot_bytes)
    mask = np.asarray(bits[:dim_height], dtype=bool)
    if mask.any():
        acc = np.bitwise_xor.reduce(rows[mask], axis=0)
    else:
        acc = np.zeros((dim_width, db.slot_bytes), dtype=np.uint8)
    return SecretSharedQueryResult(db.slot_bytes, [Slot(acc[c].tobytes())
                                                   for c in range(dim_width)])


def private_secret_shared_query(db: Database, query: QueryShare) -> SecretSharedQueryResult:
    """One answer share on the host (db.go:67-72)."""
    return private_secret_shared_query_with_expanded_bits(db, query,
                                                         expand_shared_query(db, query))


class NativePirServer:
    """The CPU engine on the native C++/AES-NI library (counterpart of
    pir_tpu/server.py:NativePirServer): the same query semantics as the
    host golden model and TorchPirServer, on numpy rows and bits from the
    Database. A host engine by definition, chosen by name
    (``PirConfig(engine="native")``); it builds its library at first use
    (``native.load``, g++) and raises if it cannot."""

    def __init__(self, db: Database):
        from . import native

        native.load()
        self.db = db

    def expand_shared_query(self, query: QueryShare) -> np.ndarray:
        """(H,) uint8 selection bits, natural row order. Multi-party shares
        have no C++ path (as in pir_tpu): the host golden model's numpy
        expansion answers them with the same bits."""
        from . import native

        h = self.db.db_size // query.group_size
        check_share(query, h)
        if not query.is_two_party:
            return expand_shared_query(self.db, query).astype(np.uint8)
        if query.key_fast is not None:
            return native.expand_fast_bits(query)
        if query.is_keyword_based:
            return native.eval_point_bits(query, 32, _keywords(self.db, h))
        return native.expand_bits(query, num_bits_for_height(h), h)

    def _rows(self, group_size: int) -> np.ndarray:
        h = self.db.db_size // group_size
        return self.db.data[: h * group_size].reshape(h, group_size * self.db.slot_bytes)

    def _result(self, out: np.ndarray, group_size: int) -> SecretSharedQueryResult:
        sb = self.db.slot_bytes
        return SecretSharedQueryResult(sb, [Slot(out[c * sb:(c + 1) * sb].tobytes())
                                            for c in range(group_size)])

    def private_secret_shared_query_with_expanded_bits(
        self, query: QueryShare, bits: np.ndarray
    ) -> SecretSharedQueryResult:
        """The native masked-XOR scan of the rows with (H,) bits in {0, 1}."""
        from . import native

        g = query.group_size
        return self._result(native.scan_xor(self._rows(g), np.asarray(bits, dtype=np.uint8)), g)

    def private_secret_shared_query(self, query: QueryShare) -> SecretSharedQueryResult:
        return self.private_secret_shared_query_with_expanded_bits(
            query, self.expand_shared_query(query))

    def private_secret_shared_query_batch(
        self, queries: list[QueryShare]
    ) -> list[SecretSharedQueryResult]:
        """A batch of one group size in ONE cache-blocked pass over the
        table (native.scan_xor_batch); mixed group sizes per query."""
        from . import native

        if not queries:
            return []
        g = queries[0].group_size
        if any(q.group_size != g for q in queries):
            return [self.private_secret_shared_query(q) for q in queries]
        bits = np.stack([self.expand_shared_query(q) for q in queries])
        out = native.scan_xor_batch(self._rows(g), bits)
        return [self._result(out[i], g) for i in range(len(queries))]


class TorchPirServer:
    """Device-resident PIR server answering 2-party index batches of fast
    and of reference-exact (compat) keys, keyword batches, and single
    queries of every kind (index or keyword, 2-party or multi-party).

    device: a CUDA device by default; pass ``device="cpu"`` to run the
    kernels' plain versions on the CPU. With no device given and no GPU
    present the constructor raises.

    fast_stacked: fast batches go through the stacked tail kernel (the
    default) or, when False, through the per-query tail kernel of
    ``tail_levels`` levels (at most depth - 5) against the classic table.
    The serving stream follows the same switch (``fast_serving_stream``).

    Compat batches of at least MIN_BATCH queries run the stage cascade of
    ``dpf.device.compat_stage_plan`` at the geometry of
    ``_compat_geometry`` (see the COMPAT_* constants), or on 5 device
    levels the preplane route (``_compat_preplane_applicable``).

    min_device_nodes: per-query expansion walks levels on the host until
    this many nodes are live (``dpf.device.make_plan``), as TpuPirServer.
    """

    # storage tables pad their rows to a multiple of this (as TpuPirServer's
    # default mxu_block, so the two tables are equal bytes)
    ROW_BLOCK = 8192

    def __init__(self, db: Database, device: str | torch.device | None = None,
                 fast_nonshared_chunk: int = 1024, fast_stacked: bool = True,
                 tail_levels: int = 5, min_device_nodes: int = 32):
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
        self.min_device_nodes = min_device_nodes
        self._tables: dict[tuple, torch.Tensor] = {}
        # each storage table's natural row -> flat row map, kept on the host
        # for apply_updates (recomputing one is a numpy pass over every row)
        self._perms: dict[tuple, np.ndarray] = {}
        self._lock = threading.Lock()

    def _cached(self, key, build) -> torch.Tensor:
        """The device tensor cached under `key`, built once by build()."""
        with self._lock:
            val = self._tables.get(key)
            if val is None:
                with span("pir.table"):
                    val = self._tables[key] = build()
        return val

    def _storage_table(self, key, group_size: int, perm, flat: int,
                       row_block: int) -> torch.Tensor:
        """The cached u8 table `key`: rows scattered to their flat bit
        positions perm() (zero rows elsewhere, XOR-neutral), padded with
        zero rows to a multiple of `row_block` and with zero bytes to a
        multiple of 4 a row, on the server's device."""
        def build():
            h = self.db.db_size // group_size
            rows = self.db.data[: h * group_size].reshape(h, group_size * self.db.slot_bytes)
            p = self._perms[key] = perm()
            sc = scatter_rows_to_storage_order(rows, p, flat)
            return torch.from_numpy(pad_cols_u8(pad_rows_u8(sc, row_block))).to(self.device)

        return self._cached(key, build)

    def _table(self, group_size: int) -> torch.Tensor:
        """The natural-order (H, G * words) int32 word table of the
        per-query paths (ops.scan.pack_table_u32): each slot padded to whole
        words, no padded rows; unpack_result_u32 slices the answers."""
        def build():
            h = self.db.db_size // group_size
            words = pack_table_u32(self.db.data, h, group_size)
            return torch.from_numpy(words.view(np.int32)).to(self.device)

        return self._cached(("words", group_size), build)

    def _fast_storage_words(self, group_size: int, dkey) -> torch.Tensor:
        """The natural word table's rows (_table) scattered into a per-query
        fast expansion's storage order (dpf.device._fast_leaf_perm; zero rows
        elsewhere), (flat, G * words) int32, cached per group size and
        expansion geometry: the table of fast singles below the root route
        (depth < 5), which is small (pir_tpu's _storage_tables words)."""
        d, mp = dkey.plan.device_levels, dkey.plan.m_padded
        n_blk = dkey.fcw_masks.shape[1] if dkey.fcw_masks.ndim == 4 else 1
        key = ("storage words", group_size, d, mp, n_blk)

        def build():
            h = self.db.db_size // group_size
            p = self._perms[key] = _fast_leaf_perm(d, h, mp, n_blk)
            words = pack_table_u32(self.db.data, h, group_size)
            flat = (mp << d) * 128 * n_blk
            sc = scatter_rows_to_storage_order(words, p, flat)
            return torch.from_numpy(sc.view(np.int32)).to(self.device)

        return self._cached(key, build)

    def _kw_plane_table(self, group_size: int) -> torch.Tensor:
        """The rows' keywords as (32, ceil(H/32)) int32 branch-bit planes
        of the point walk (dpf.device.pack_point_bit_planes), cached."""
        h = self.db.db_size // group_size
        return self._cached(("keyword planes", group_size), lambda: u32_tensor(
            pack_point_bit_planes(_keywords(self.db, h), 32), self.device))

    def _point_bits(self, query: QueryShare) -> torch.Tensor:
        """(H,) uint8 selection bits of a keyword or multi-party share,
        natural row order, on the device: the multi-party PRG walk over
        the index domain or at the rows' keywords, or the 2-party point
        walk at the rows' keywords."""
        h = self.db.db_size // query.group_size
        check_share(query, h)
        pf = dpf_host.server_initialize(query.prf_keys, _num_bits(query, h))
        if not query.is_two_party:
            if query.is_keyword_based:
                return eval_points_mp_bits(pf, query.key_multi_party, _keywords(self.db, h),
                                           self.device)
            return expand_mp_full_domain_bits(pf, query.key_multi_party, h, self.device)
        return eval_points_bits(make_device_point_key(pf, query.key_two_party),
                                self._kw_plane_table(query.group_size), h)

    def _perm(self, num_bits: int, height: int) -> torch.Tensor:
        """The compat leaf permutation (int64) on the device, per geometry."""
        mdn = self.min_device_nodes
        return self._cached(("perm", num_bits, height, mdn), lambda: torch.from_numpy(
            _leaf_perm(num_bits, height, mdn)).to(self.device))

    def _fast_perm(self, dkey) -> torch.Tensor:
        """The fast-mode leaf permutation (int64) on the device, per shape."""
        n_blk = dkey.fcw_masks.shape[1] if dkey.fcw_masks.ndim == 4 else 1
        shape = (dkey.plan.device_levels, dkey.height, dkey.plan.m_padded, n_blk)
        return self._cached(("fast perm",) + shape, lambda: torch.from_numpy(
            _fast_leaf_perm(*shape)).to(self.device))

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

    def _compat_preplane_table_u8(self, group_size: int, device_bits: int) -> torch.Tensor:
        """Raw u8 table of the compat preplane route: row r at
        bit_reverse(r) of the 2^device_bits leaves, zero rows elsewhere
        (pir_tpu's _compat_root_plane_table, as bytes: the port keeps no
        plane table)."""
        h = self.db.db_size // group_size
        flat = 1 << device_bits
        return self._storage_table(("preplane", group_size, device_bits), group_size,
                                   lambda: _compat_leaf_perm_root(device_bits, h), flat, flat)

    def _level1_exponents(self, width: int, height: int, num_cts: int) -> torch.Tensor:
        """The cPIR level-1 exponent matrix of a (width, height) grid of
        num_cts chunks a slot (encrypted._level1_exponents), (height, width
        * num_cts, EW) int32 words on the device.

        The geometry and num_cts (the key size) are the client's, so a
        cache keyed by them would let clients fill the device. Only the
        database's own square-root grid (encrypted.new_encrypted_query's)
        is cached, one entry, replaced when a key asks for another
        num_cts; any other grid is built for the call and freed with it."""
        def build():
            return upload_words(enc._level1_exponents(self.db, width, height, num_cts)[0],
                                self.device)

        if (width, height) != enc.sqrt_grid(self.db.metadata()):
            with span("pir.table"):
                return build()
        key = ("cpir", width, height, num_cts)
        with self._lock:
            val = self._tables.get(key)
            if val is None:
                for old in [k for k in self._tables if k[0] == "cpir"]:
                    del self._tables[old]
                with span("pir.table"):
                    val = self._tables[key] = build()
        return val

    def private_encrypted_query_batch_async(self, queries: list[enc.EncryptedQuery]):
        """Dispatch a batch of level-1 cPIR queries (single-server Paillier,
        db.go:176-271) to kernel 10 without waiting for the device; returns
        a zero-arg callable producing their EncryptedQueryResults, the
        ciphertexts of private_encrypted_query's CPython engine.

        Every query is checked as the single query is
        (encrypted.check_encrypted_query, and an odd N^2) before any is
        launched. Each query's ebits go up as words, then one ``mont_scan``
        under its own modulus N^2 reads the exponent matrix of its
        geometry (``_level1_exponents``: cached for the table's own grid).
        On the card the copy back is enqueued behind the batch's
        own scans, so the future waits for them alone and not for a batch
        dispatched after it; it turns the words into ciphertexts.

        Spans: ``pir.dispatch`` (the batch's root: the checks),
        ``pir.table`` (a matrix built), ``pir.cpir.bases`` (the ebits to
        words, their upload), ``pir.cpir.scan`` (the plan, the constants,
        the launches, the copy back's enqueue); in the future
        ``pir.answers.copy`` (the wait for the scans and the copy back) and
        ``pir.cpir.results`` (words to ints, the results)."""
        with span("pir.dispatch", next_batch()) as root:
            if not queries:
                raise ValueError("empty batch")
            cts = []
            for q in queries:
                cts.append(enc.check_encrypted_query(self.db, q))
                word_ctx(q.pk.n2)  # refuses an even modulus
            sb = self.db.slot_bytes
            per = [max(1, -(-sb // c)) for c in cts]
            emats = [self._level1_exponents(q.db_width, q.db_height, c)
                     for q, c in zip(queries, cts)]
            with span("pir.cpir.bases"):
                bases = [upload_words(ints_to_words([ct.c % q.pk.n2 for ct in q.ebits],
                                                    words_for_modulus(q.pk.n2)), self.device)
                         for q in queries]
            with span("pir.cpir.scan"):
                outs = [mont_scan(b, e, q.pk.n2, 8 * p)
                        for q, b, e, p in zip(queries, bases, emats, per)]
                shapes = [o.shape for o in outs]
                flat = torch.cat([o.flatten() for o in outs])
                ready = None
                if self.device.type == "cuda":
                    # the copy back is enqueued now, behind this batch's
                    # scans and ahead of the next batch's
                    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                    host.copy_(flat, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(self.device))
                    flat = host
        batch = root.arg

        def take() -> list[enc.EncryptedQueryResult]:
            with span("pir.answers.copy", batch):
                if ready is not None:
                    ready.synchronize()
                words = flat.numpy()
            with span("pir.cpir.results", batch):
                results, off = [], 0
                for q, c, p, (w, L) in zip(queries, cts, per, shapes):
                    out = words_to_ints(words[off:off + w * L].reshape(w, L))
                    off += w * L
                    slots = [enc.EncryptedSlot([enc.Ciphertext(out[col * c + j],
                                                               enc.ENC_LEVEL_ONE)
                                                for j in range(c)])
                             for col in range(q.db_width)]
                    results.append(enc.EncryptedQueryResult(slots, q.pk, sb, p))
                return results

        return take

    def apply_updates(self, updates: dict[int, bytes]) -> None:
        """Apply slot updates ``{index: new_bytes}`` to the database and to
        every cached table (counterpart of pir_tpu/server.py:apply_updates).

        Each table derives row-wise from ``db.data``: the natural word table
        through ``ops.scan.pack_rows_u32``, the stacked, classic and compat
        storage tables through their permutations, rows padded with zero
        bytes to whole words, the fast singles' storage word table
        through both, and the cPIR exponent matrices by grid row. So each
        gets one device row scatter, O(changed rows) uploaded. A patched
        table is a clone swapped in under the
        lock: a query holding the old table finishes on the old rows and
        never sees a torn row, and an open FastServingStream sees the new
        table at its next dispatch. The database swaps its rows copy-on-write
        for the same reason. Keyword planes and permutations derive from no
        row and stay as they are. (pir_tpu also patches its bit-plane tables
        of the root and compat-root routes, which the port does not build:
        its preplane route reads the raw u8 table, patched like the others.)
        """
        with self._lock:
            self.db.update_slots(updates, copy_on_write=True)
            self._swap_patched(self._row_patches(updates))

    def _row_patches(self, updates) -> list[tuple[tuple, np.ndarray, np.ndarray]]:
        """(table key, table rows, new row contents) of every cached table
        the updated slots touch, on the host."""
        idxs = np.unique(np.fromiter((int(i) for i in updates), dtype=np.int64,
                                     count=len(updates)))
        sb = self.db.slot_bytes
        patches = []
        for key in self._tables:
            if key[0] == "cpir":
                _, w, h, num_cts = key
                r = np.unique(idxs // w)
                r = r[r < h]
                if len(r):
                    vals = enc._level1_exponents(self.db, w, h, num_cts, r)[0]
                    patches.append((key, r, vals.view(np.int32)))
                continue
            words = key[0] in ("words", "storage words")
            if not (words or key in self._perms):
                continue  # permutations and keyword planes
            g = key[1] if isinstance(key[0], str) else key[0]
            h = self.db.db_size // g
            r = np.unique(idxs // g)
            r = r[r < h]
            if not len(r):
                continue
            if words:
                at = self._perms[key][r] if key in self._perms else r
                patches.append((key, at, pack_rows_u32(self.db.data, r, g, sb).view(np.int32)))
            else:
                raw = self.db.data[: h * g].reshape(h, g * sb)[r]
                patches.append((key, self._perms[key][r], pad_cols_u8(raw)))
        return patches

    def _swap_patched(self, patches) -> None:
        """Upload each patch and swap in a patched clone of its table."""
        for key, rows, vals in patches:
            table = self._tables[key].clone()
            table[torch.from_numpy(rows).to(self.device)] = torch.from_numpy(
                np.ascontiguousarray(vals)).to(self.device)
            self._tables[key] = table

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

    def _answers(self, out_dev: torch.Tensor, group_size: int, n: int, batch: int):
        """The zero-arg future of batch number `batch`'s results: the
        (Q, row_bytes) device answers copied back, then sliced."""
        def take() -> list[SecretSharedQueryResult]:
            with span("pir.answers.copy", batch):
                out = out_dev.cpu().numpy()
            with span("pir.answers.slice", batch):
                return self._slice_batch_results(out, group_size, n)

        return take

    def _result_from_words(self, res_words: torch.Tensor,
                           group_size: int) -> SecretSharedQueryResult:
        """(G * words,) int32 answer words of the natural table -> result."""
        out = unpack_result_u32(res_words.cpu().numpy().view(np.uint32), group_size,
                                self.db.slot_bytes)
        return SecretSharedQueryResult(self.db.slot_bytes,
                                       [Slot(out[c].tobytes()) for c in range(group_size)])

    def _index_payload(self, query: QueryShare, height: int):
        """(payload, layout, dkey) of one 2-party index share, payload a
        numpy uint32 row; payload and layout are None when the host walked
        every level (dkey.host_bits holds the selection bits)."""
        if query.key_fast is not None:
            validate_fast_key_geometry(query.key_fast, height)
            pf = dpf_host.server_initialize(query.prf_keys, query.key_fast.depth)
            dkey = make_device_fast_key(pf, query.key_fast, self.min_device_nodes)
            pack = pack_fast_payload
        else:
            pf = dpf_host.server_initialize(query.prf_keys, num_bits_for_height(height))
            dkey = make_device_key(pf, query.key_two_party, height, self.min_device_nodes)
            pack = pack_key_payload
        if dkey.host_bits is not None:
            return None, None, dkey
        return (*pack(dkey), dkey)

    def _bits(self, query: QueryShare, payload, layout, dkey) -> torch.Tensor:
        """(H,) uint8 selection bits of one share (_index_payload's triple)
        on the device: host bits uploaded, else expanded on the device."""
        if dkey.host_bits is not None:
            return torch.from_numpy(dkey.host_bits).to(self.device)
        if query.key_fast is not None:
            return fused_fast_bits(u32_tensor(payload, self.device), self._fast_perm(dkey),
                                   layout)
        return expand_query_bits(dkey, self.device, self._perm(dkey.plan.num_bits,
                                                               dkey.plan.height))

    def expand_shared_query(self, query: QueryShare) -> torch.Tensor:
        """Device DPF expansion of one share -> (H,) uint8 selection bits
        in natural row order, on the server's device."""
        if not is_index_share(query):
            return self._point_bits(query)
        self._validate_batch([query])
        h = self.db.db_size // query.group_size
        return self._bits(query, *self._index_payload(query, h))

    def private_secret_shared_query_with_expanded_bits(
        self, query: QueryShare, bits
    ) -> SecretSharedQueryResult:
        """The masked-XOR scan of the natural-order table with the given
        (H,) selection bits in {0, 1}: a tensor (expand_shared_query's) or
        a numpy array (the host golden's bools)."""
        if isinstance(bits, torch.Tensor):
            bits = bits.to(self.device, torch.uint8).contiguous()
        else:
            bits = torch.from_numpy(np.asarray(bits, dtype=np.uint8)).to(self.device)
        g = query.group_size
        return self._result_from_words(masked_xor_scan(self._table(g), bits), g)

    def private_secret_shared_query(self, query: QueryShare) -> SecretSharedQueryResult:
        """One answer share. A fast share of depth >= 5 rides the batch path
        (padded to MIN_BATCH, so the masked-XOR scan kernel reads the storage
        table once); a shallower fast share with device levels expands from
        one payload and scans the storage word table of its expansion
        (_fast_storage_words) with no gather; a compat share expands from one
        payload and scans the natural table; a tiny domain's host bits, and a
        keyword or multi-party share's point bits, scan the same table."""
        if not is_index_share(query):
            return self.private_secret_shared_query_with_expanded_bits(
                query, self._point_bits(query))
        self._validate_batch([query])
        if self._fast_root_applicable([query]):
            return self.private_secret_shared_query_batch([query])[0]
        g = query.group_size
        h = self.db.db_size // g
        payload, layout, dkey = self._index_payload(query, h)
        if payload is not None and query.key_fast is not None:
            res = fused_fast_answer_storage(self._fast_storage_words(g, dkey),
                                            u32_tensor(payload, self.device), layout)
            return self._result_from_words(res, g)
        if payload is not None:
            res = fused_answer(self._table(g), u32_tensor(payload, self.device),
                               self._perm(dkey.plan.num_bits, h), layout)
            return self._result_from_words(res, g)
        return self.private_secret_shared_query_with_expanded_bits(
            query, self._bits(query, payload, layout, dkey))

    def _dispatch_per_query(self, queries: list[QueryShare]) -> torch.Tensor:
        """The per-query batch path (pir_tpu/server.py:1085-1108) for what
        the root-start paths do not take: compat batches below MIN_BATCH,
        compat tables of fewer than 5 device levels, fast keys of depth < 5.
        Returns the (Q, G * words) int32 answer words (not yet fetched)."""
        g = queries[0].group_size
        h = self.db.db_size // g
        keyed = [self._index_payload(q, h) for q in queries]
        payload, layout, dkey = keyed[0]
        table = self._table(g)
        if payload is not None:
            pays = u32_tensor(np.stack([k[0] for k in keyed]), self.device)
            if queries[0].key_fast is not None:
                return fused_fast_answer_batch(table, pays, self._fast_perm(dkey), layout)
            return fused_answer_batch(table, pays, self._perm(dkey.plan.num_bits, h), layout)
        return masked_xor_scan(table, torch.stack([self._bits(q, *k)
                                                   for q, k in zip(queries, keyed)]))

    @staticmethod
    def _fast_root_applicable(queries: list[QueryShare]) -> bool:
        """Root-start expansion needs >= one full 32-bit word of leaves
        (depth >= 5); shallower keys run per query."""
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

    def _compat_batch(self, queries: list[QueryShare]) -> bool:
        q0 = queries[0]
        return q0.key_fast is None and not q0.is_keyword_based and len(queries) >= MIN_BATCH

    def _compat_applicable(self, queries: list[QueryShare]) -> bool:
        """The compat stage cascade needs a batch of at least MIN_BATCH
        and a head of >= 5 levels followed by a stage: device_bits >= 6."""
        return self._compat_batch(queries) and self._compat_device_bits(
            queries[0].group_size) >= 6

    def _compat_preplane_applicable(self, queries: list[QueryShare]) -> bool:
        """A compat batch of at least MIN_BATCH on exactly 5 device levels
        takes the preplane route, as in pir_tpu/server.py:1046-1071 (there
        every level count from 5 up that its stage cascade does not take;
        here the cascade takes 6 and up). Shallower tables run per query."""
        return self._compat_batch(queries) and self._compat_device_bits(
            queries[0].group_size) == 5

    def _dispatch_compat_preplane(self, queries: list[QueryShare]) -> torch.Tensor:
        """Dispatch a uniform compat batch through the preplane route;
        returns the (Q, row_bytes) uint8 device tensor (not yet fetched)."""
        g = queries[0].group_size
        h = self.db.db_size // g
        pay, layout = make_compat_payload_batch(queries, height=h)
        return fused_compat_preplane_batch(self._compat_preplane_table_u8(g, layout.device_bits),
                                           u32_tensor(pay, self.device), layout)

    def _keyword_query_batch(self, queries: list[QueryShare]) -> torch.Tensor:
        """A keyword batch (pir_tpu/server.py:735-766): one point walk for
        the batch, then the bit-plane scan kernel on the natural word
        table's bytes. Returns the (Q, G * words) int32 answer words (not
        yet fetched)."""
        g = queries[0].group_size
        h = self.db.db_size // g
        dkeys = []
        for query in queries:
            if query.group_size != g or not query.is_two_party or not query.is_keyword_based:
                raise ValueError("keyword batch requires uniform 2-party keyword queries")
            check_share(query, h)
            pf = dpf_host.server_initialize(query.prf_keys, 32)
            dkeys.append(make_device_point_key(pf, query.key_two_party))
        bits = eval_points_bits_batch(dkeys, self._kw_plane_table(g), h)  # (Q, H)
        return planes_scan(self._table(g).view(torch.uint8), bits).view(torch.int32)

    def _validate_batch(self, queries: list[QueryShare]) -> None:
        """Raise ValueError unless `queries` is a uniform 2-party index
        batch (keyword batches validate in _keyword_query_batch)."""
        if not queries:
            raise ValueError("empty batch")
        q0 = queries[0]
        if q0.is_keyword_based:
            return
        g = q0.group_size
        if q0.is_two_party:
            check_share(q0, self.db.db_size // g)
        fast = q0.key_fast is not None
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
            if not fast and (query.key_two_party is None or len(query.key_two_party.cw) != nb):
                raise ValueError("compat key geometry does not match the database")

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
        pad_to = MIN_BATCH if shared_rk else min(MIN_BATCH, cap)
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
        with span("pir.payload"):
            pay, layout = make_fast_payload_batch(queries, shared_rk=shared_rk)
            pay_t = u32_tensor(pay, self.device)
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
            with span("pir.payload"):
                pay, layout = make_compat_payload_batch(queries[i:i + COMPAT_BATCH_CAP],
                                                        height=h)
                pay_t = u32_tensor(pay, self.device)
            outs.append(fused_compat_root_batch(table, pay_t, layout, w=w, tails=tails,
                                                q_chunk=COMPAT_Q_CHUNK))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def private_secret_shared_query_batch_async(self, queries: list[QueryShare]):
        """Dispatch a batch without waiting for the device; returns a
        zero-arg callable producing the results."""
        with span("pir.dispatch", next_batch()) as root:
            self._validate_batch(queries)
            g, n = queries[0].group_size, len(queries)
            if queries[0].is_keyword_based:
                words = self._keyword_query_batch(queries)
                return lambda: [self._result_from_words(w, g) for w in words.cpu()]
            if self._fast_root_applicable(queries):
                out_dev = self._dispatch_fast_root(queries)
            elif self._compat_applicable(queries):
                out_dev = self._dispatch_compat(queries)
            elif self._compat_preplane_applicable(queries):
                out_dev = self._dispatch_compat_preplane(queries)
            else:
                words = self._dispatch_per_query(queries)
                return lambda: [self._result_from_words(w, g) for w in words.cpu()]
            return self._answers(out_dev, g, n, root.arg)

    def private_secret_shared_query_batch(
        self, queries: list[QueryShare]
    ) -> list[SecretSharedQueryResult]:
        """Answer a batch of same-shape 2-party index or keyword queries."""
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
        self._pending = None  # stacked: (out_dev, queries, batch number) not yet drained
        self._words = None  # fused: the previous batch's selection words
        self._prev = None  # fused: the previous batch's (queries, batch number)
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
        return u32_tensor(pay, srv.device)

    def _step(self, payloads: torch.Tensor) -> torch.Tensor:
        out_prev, self._words = fused_fast_overlap_step(
            self._table(), self._words, payloads, self._shape[3], self._srv.tail_levels)
        return out_prev

    def _future(self, out_dev: torch.Tensor, queries: list[QueryShare], batch: int):
        return self._srv._answers(out_dev, queries[0].group_size, len(queries), batch)

    def submit(self, queries):
        """Dispatch a batch; returns a zero-arg callable resolving the
        previous batch's results (None for the first submit). A refused
        batch raises and leaves the pending batch answerable."""
        with span("pir.dispatch", next_batch()) as root:
            queries = list(queries)
            mode = self._mode or ("stacked" if self._srv.fast_stacked else "fused")
            if mode == "fused":
                pay = self._prepare(queries)
                self._mode = mode
                out_prev = self._step(pay)
                prev, self._prev = self._prev, (queries, root.arg)
                return None if prev is None else self._future(out_prev, *prev)
            shape = self._check_uniform(queries)
            if self._shape is not None and shape != self._shape:
                raise ValueError(f"stream batches must keep one shape: {shape} != {self._shape}")
            out_dev = self._srv._dispatch_fast_root(queries)
            self._mode, self._shape = mode, shape
            prev, self._pending = self._pending, (out_dev, queries, root.arg)
            return None if prev is None else self._future(*prev)

    def flush(self):
        """Drain the last submitted batch: its results' future, or None
        if the stream is empty. Fused mode scans it beside the tail of a
        zero payload, whose words are discarded."""
        if self._mode == "stacked":
            if self._pending is None:
                return None
            prev, self._pending = self._pending, None
            self._shape = self._mode = None
            return self._future(*prev)
        if self._prev is None:
            return None
        zeros = torch.zeros((self._shape[0], self._shape[3].total), dtype=torch.int32,
                            device=self._srv.device)
        out_last = self._step(zeros)
        prev, self._prev = self._prev, None
        self._words = self._shape = self._mode = None
        return self._future(out_last, *prev)
