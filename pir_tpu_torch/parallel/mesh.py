"""Sharding of the PIR answer pipeline over a grid of devices
(counterpart of ``pir_tpu/parallel/mesh.py``).

The two axes of pir_tpu's mesh (SURVEY.md §2.10):

* **tp**, the database *rows*: each shard owns a contiguous row range
  and the DPF subtree covering exactly those rows, expands it, scans its
  own slice of the table, and the shards' partial answers are combined
  by XOR (the reference's nprocs partial merge, db.go:256-261);
* **dp**, the query batch: each row of the grid answers its own slice
  of the batch.

The client's key never changes: sharding is a server-side layout of the
same DPF, invisible to the protocol.

pir_tpu runs one program over ``jax.devices()`` with ``shard_map``. Here
one process holds a ``(dp, tp)`` grid of ``torch.device``s
(``TorchMesh``): for each shard it launches the single-card pipeline's
kernels on that shard's device and table slice, all shards in one loop
with no synchronisation between them, then copies each grid row's
``(Q, B)`` partial answers to the row's lead device and folds them with
XOR (pir_tpu's ``all_gather`` + ``xor_reduce``). A grid may name one
device more than once: ``make_mesh(devices=["cuda:0"] * 4)`` runs four
row shards on one card, each shard's tables held once on it. On the CPU
(``make_mesh(n, device="cpu")``) every kernel runs its plain version.

The routes of ``MeshPirServer.private_secret_shared_query_batch``:

* shared-key fast batches on a tp of 2^k: each shard walks its k-level
  subtree prefix, then the stacked tail kernel (or, with
  ``fast_stacked=False``, the per-query tail kernel) and the packed
  scan kernel over its slice of the storage table (a grid row's slice
  of at most 8 queries scans with the masked-XOR scan kernel, as on one
  card);
* compat batches on a tp of 2^k: the skip walk, the prefix walk, the
  head and the compat-stage cascade, then the packed scan kernel;
* distinct-key fast batches, and compat batches on any other tp: the
  host walks each key's first levels down to one seed set per shard
  (``make_sharded_fast_key`` / ``make_sharded_key``), the shard walks the
  rest in plain torch and folds its natural word table with the
  masked-XOR scan kernel;
* keyword and multi-party batches: each shard evaluates the point walk
  at its own rows' keywords or indices and scans with the bit-plane scan
  kernel;
* anything else (mixed batches, tables too small to shard) goes to the
  numpy golden model, ``server.private_secret_shared_query``, as in
  pir_tpu.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import server as server_mod
from ..dpf import host as dpf_host
from ..dpf.aes_host import key_schedule
from ..dpf.bitslice import blocks_to_planes, key_masks
from ..dpf.device import (
    ExpandPlan,
    _block_masks,
    _block_masks_wide,
    _compat_perm,
    _cw_masks_list,
    _fast_leaf_perm,
    _fast_leaf_perm_root,
    _fast_leaf_perm_root_stacked,
    _host_prefix,
    _pack_t,
    _rk_bit_first,
    _unpack_bits,
    compat_skip_levels,
    compat_stage_plan,
    eval_point_operands_bits,
    fast_leaf_bits_flat_batch,
    make_compat_payload_batch,
    make_device_point_key,
    make_fast_payload_batch,
    mp_point_operands,
    mp_point_packed_core,
    pack_point_bit_planes,
    point_eval_operands,
    prf_key_masks,
    scatter_rows_to_storage_order,
    u32_tensor,
)
from ..models.pipeline import (
    _expand_planes_loop,
    _queries_in_lanes,
    expand_bits_planes,
    fused_compat_root_batch,
    fused_fast_root_batch_pertail,
    fused_fast_root_batch_stacked,
    stacked_fast_geometry,
)
from ..ops.planes_scan import planes_scan
from ..ops.scan import pack_rows_u32, pack_table_u32, pad_cols_u8, pad_rows_u8, unpack_result_u32
from ..ops.xor_scan import MAX_Q, masked_xor_scan
from ..query import SecretSharedQueryResult
from ..slot import Slot
from ..utils import pad_tile
from ..utils.bits import num_bits_for_height

# levels of the per-query tail kernel on the fast_stacked=False root step
# (pir_tpu's make_sharded_fast_root_step default)
TAIL_LEVELS = 5
# each shard's slice of a storage table pads its rows to a multiple of this
PAD_TO = 8192
# queries a walk of the host-prefix steps: one masked-XOR scan launch, and
# a bound on the walk's planes (pir_tpu walks the whole batch at once)
HOST_PREFIX_CHUNK = MAX_Q


@dataclass(frozen=True, eq=False)
class TorchMesh:
    """A (dp, tp) grid of torch devices: grid row r answers the r-th
    slice of a batch, column s holds row shard s."""

    devices: np.ndarray  # (dp, tp) object array of torch.device

    @property
    def shape(self) -> dict[str, int]:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}


def _normalise(dev) -> torch.device:
    """A device with its index spelled out, so that two names of one card
    compare equal ("cuda" and "cuda:0")."""
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, dp: int = 1, device: str | None = None,
              devices=None) -> TorchMesh:
    """A grid of n_devices devices, dp rows of n_devices // dp row shards.

    devices: an explicit list, which may name one device more than once
    (the first n_devices are taken). Else ``device`` None or "cuda" takes
    the process's CUDA cards, raising when there are fewer than asked,
    and "cpu" gives n_devices (by default 1) CPU shards. Nothing falls
    back to the CPU unasked."""
    if devices is not None:
        avail = [_normalise(d) for d in devices]
        where = "in the given device list"
    elif device in (None, "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh needs CUDA devices; pass device='cpu' to run on the CPU")
        avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        where = "CUDA device(s) in this process"
    elif device == "cpu":
        avail = [torch.device("cpu")] * (n_devices or 1)
        where = "CPU shards"
    else:
        raise ValueError(f"mesh device must be None, 'cuda' or 'cpu', not {device!r}")
    n = n_devices or len(avail)
    if n > len(avail):
        raise ValueError(f"requested a {n}-device mesh but there are only {len(avail)} "
                         f"{where}; a device list may name one card more than once")
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} must be >= 1 and divide n_devices={n}")
    grid = np.empty((dp, n // dp), dtype=object)
    for i, d in enumerate(avail[:n]):
        grid[i // (n // dp), i % (n // dp)] = d
    return TorchMesh(grid)


# --------------------------------------------------------------------------
# Host helpers (pir_tpu/parallel/mesh.py:62-253, :635-716)
# --------------------------------------------------------------------------

@dataclass
class ShardedKeyArrays:
    """A compat share's arrays split into `n_shards` row shards (numpy uint32)."""

    seeds: np.ndarray  # (D, 8, 16, NWs)
    t: np.ndarray  # (D, NWs)
    cw_seed_masks: np.ndarray  # (d, 8, 16, 1)
    cw_tl: np.ndarray  # (d,)
    cw_tr: np.ndarray  # (d,)
    rk_masks: np.ndarray  # (11, 8, 3, 16, 1)
    fcw_mask: np.uint32
    d_levels: int
    rows_per_shard: int  # covered rows per shard (padded)


def _split_prefix(seeds, t_bits, per_shard: int, n_shards: int):
    """Zero-pad the host prefix's nodes to per_shard * n_shards (zero seeds
    against zero-padded rows: XOR-neutral) -> (D,8,16,NWs) planes and
    (D,NWs) packed t bits."""
    pad = per_shard * n_shards - seeds.shape[0]
    if pad:
        seeds = np.concatenate([seeds, np.zeros((pad, 16), dtype=np.uint8)])
        t_bits = np.concatenate([t_bits, np.zeros(pad, dtype=np.uint8)])
    planes = np.stack([blocks_to_planes(seeds[k * per_shard:(k + 1) * per_shard])
                       for k in range(n_shards)])
    t_packed = np.stack([_pack_t(t_bits[k * per_shard:(k + 1) * per_shard], per_shard)
                         for k in range(n_shards)])
    return planes, t_packed


def make_sharded_key(server: dpf_host.Dpf, key: dpf_host.Key2P, height: int,
                     n_shards: int) -> ShardedKeyArrays:
    """Split one compat share into per-row-shard subtree seed sets: the
    host walks levels until at least 32 nodes a shard are live."""
    nb = server.num_bits
    min_nodes = 32 * n_shards
    lvl, m = 0, 1
    while lvl < nb and m < min_nodes:
        lvl += 1
        m = -(-height // (1 << (nb - lvl)))
    if m < min_nodes:
        raise ValueError(f"height {height} too small to shard {n_shards} ways (need >= "
                         f"{min_nodes} leaf nodes)")
    per_shard = -(-(-(-m // n_shards)) // 32) * 32
    plan = ExpandPlan(nb, height, lvl, m, per_shard * n_shards, nb - lvl)
    seeds, t_bits = _host_prefix(server, key, plan)
    planes, t_packed = _split_prefix(seeds, t_bits, per_shard, n_shards)
    cw_seed_masks, tl, tr = _cw_masks_list(key.cw[lvl:])
    return ShardedKeyArrays(
        seeds=planes, t=t_packed, cw_seed_masks=cw_seed_masks, cw_tl=tl, cw_tr=tr,
        rk_masks=prf_key_masks(server),
        fcw_mask=np.uint32(0xFFFFFFFF if (key.final_cw & 1) else 0),
        d_levels=nb - lvl, rows_per_shard=per_shard << (nb - lvl))


def shard_local_perm(d_levels: int, per_shard_nodes: int) -> np.ndarray:
    """Natural local row -> local storage position (the same for every shard)."""
    rows = per_shard_nodes << d_levels
    x = np.arange(rows, dtype=np.int64)
    s = x >> d_levels
    local = x & ((1 << d_levels) - 1)
    rev = np.zeros_like(local)
    for b in range(d_levels):
        rev |= ((local >> b) & 1) << (d_levels - 1 - b)
    return rev * per_shard_nodes + s


def pow2_padded_len(n: int, dp: int, chunk: int = 1) -> int:
    """Batch length padded so each dp slice is a power of two (capped at
    `chunk`), or a power-of-two multiple of `chunk` above it. pir_tpu
    pads so to bound its compiled shapes; the port pads the same way so
    that a dp slice sees the same queries (padding repeats queries and is
    sliced off)."""
    per = -(-n // dp)
    if per <= chunk:
        p = min(1 << (per - 1).bit_length(), chunk)
    else:
        p = chunk << (-(-per // chunk) - 1).bit_length()
    return p * dp


def pad_table_rows(table: np.ndarray, total_rows: int) -> np.ndarray:
    """Zero-pad a (H, C) table to the sharded row count."""
    if table.shape[0] == total_rows:
        return table
    out = np.zeros((total_rows, table.shape[1]), dtype=table.dtype)
    out[: table.shape[0]] = table
    return out


@dataclass
class ShardedFastKeyArrays:
    """A fast share's arrays split into row shards (leaf tree split)."""

    seeds: np.ndarray  # (D, 8, 16, NWs)
    t: np.ndarray  # (D, NWs)
    cw_seed_masks: np.ndarray  # (d, 8, 16, 1)
    cw_tl: np.ndarray
    cw_tr: np.ndarray
    fcw_masks: np.ndarray  # (8, 16, 1), or (8, n_blk, 16, 1) for wide leaves
    rk_masks: np.ndarray  # (11, 8, 3, 16, 1)
    rk_leaf: np.ndarray  # (11, 8, 16, 1)
    d_levels: int
    per_shard_nodes: int
    rows_per_shard: int  # = per_shard_nodes * 2^d_levels * leaf_bits


def make_sharded_fast_key(server: dpf_host.Dpf, fkey, n_shards: int) -> ShardedFastKeyArrays:
    """Split a fast share into per-row-shard subtree seed sets. Below 32
    nodes a shard (wide leaves on small tables) the shards pad with zero
    seeds, whose garbage bits select zero-padded rows (XOR-neutral)."""
    depth = fkey.depth
    n_blk = fkey.leaf_bits // 128
    n_leaves = -(-fkey.height // fkey.leaf_bits)
    min_nodes = 32 * n_shards
    lvl, m = 0, 1
    while lvl < depth and m < min_nodes:
        lvl += 1
        m = -(-n_leaves // (1 << (depth - lvl)))
    per_shard = -(-(-(-m // n_shards)) // 32) * 32
    plan = ExpandPlan(depth, n_leaves, lvl, m, per_shard * n_shards, depth - lvl)
    saved = server.num_bits
    server.num_bits = depth
    try:
        seeds, t_bits = _host_prefix(server, dpf_host.Key2P(fkey.s_init, fkey.t_init, fkey.cw,
                                                            0), plan)
    finally:
        server.num_bits = saved
    planes, t_packed = _split_prefix(seeds, t_bits, per_shard, n_shards)
    cw_seed_masks, tl, tr = _cw_masks_list(fkey.cw[lvl:])
    return ShardedFastKeyArrays(
        seeds=planes, t=t_packed, cw_seed_masks=cw_seed_masks, cw_tl=tl, cw_tr=tr,
        fcw_masks=(_block_masks(fkey.final_cw_block) if n_blk == 1
                   else _block_masks_wide(fkey.final_cw_block)),
        rk_masks=prf_key_masks(server),
        rk_leaf=key_masks(key_schedule(server.ciphers[3].key)[None]),
        d_levels=depth - lvl, per_shard_nodes=per_shard,
        rows_per_shard=(per_shard << (depth - lvl)) * fkey.leaf_bits)


def _shard_rows(data: np.ndarray, height: int, group_size: int, slot_bytes: int,
                rows_per_shard: int, s: int) -> np.ndarray:
    """Shard s's natural rows, (local_h, group_size * slot_bytes): the
    last shard may hold fewer than rows_per_shard, or none."""
    h = height // group_size
    lo = s * rows_per_shard
    local_h = min(max(h - lo, 0), rows_per_shard)
    return data[: h * group_size].reshape(h, group_size * slot_bytes)[lo:lo + local_h]


def _storage_shard(rows: np.ndarray, perm: np.ndarray, flat: int, pad_to: int) -> np.ndarray:
    """One shard's storage-ordered slice: rows scattered by perm into
    `flat` positions (zero rows elsewhere), padded to a multiple of pad_to."""
    return pad_rows_u8(scatter_rows_to_storage_order(rows, perm, flat), pad_to)


def root_shard_perm(d_local: int, local_h: int, n_blk: int,
                    stacked_tail: int | None) -> np.ndarray:
    """A shard's natural local row -> flat position in its fast root
    table: the stacked tail kernel's chunk-major order at that tail
    depth, or (stacked_tail None) the per-query tail's bit-reversed one."""
    if stacked_tail is None:
        return _fast_leaf_perm_root(d_local, local_h, n_blk)
    return _fast_leaf_perm_root_stacked(d_local, local_h, n_blk, stacked_tail)


def build_sharded_compat_table_u8(data: np.ndarray, height: int, group_size: int,
                                  slot_bytes: int, nbd: int, shard_levels: int, w: int,
                                  tails: tuple, pad_to: int = PAD_TO) -> np.ndarray:
    """Every shard's storage-ordered u8 slice for the compat root step,
    stacked: rows scattered by the cascade's order over the shard's local
    nbd - shard_levels levels, each slice padded to a multiple of pad_to."""
    d_local = nbd - shard_levels
    flat = 1 << d_local
    slices = []
    for s in range(1 << shard_levels):
        rows = _shard_rows(data, height, group_size, slot_bytes, flat, s)
        slices.append(_storage_shard(rows, _compat_perm(d_local, len(rows), w, tuple(tails)),
                                     flat, pad_to))
    return np.concatenate(slices, axis=0)


def build_sharded_root_table_u8(data: np.ndarray, height: int, group_size: int,
                                slot_bytes: int, depth: int, shard_levels: int,
                                pad_to: int = PAD_TO, n_blk: int = 1,
                                stacked_tail: int | None = None) -> np.ndarray:
    """Every shard's storage-ordered u8 slice for the fast root step,
    stacked: shard s owns natural rows [s * F, (s + 1) * F), F = (128 *
    n_blk) << (depth - shard_levels), scattered by root_shard_perm, each
    slice padded to a multiple of pad_to."""
    d_local = depth - shard_levels
    flat = (128 * n_blk) << d_local
    slices = []
    for s in range(1 << shard_levels):
        rows = _shard_rows(data, height, group_size, slot_bytes, flat, s)
        slices.append(_storage_shard(rows, root_shard_perm(d_local, len(rows), n_blk,
                                                           stacked_tail), flat, pad_to))
    return np.concatenate(slices, axis=0)


def _in_chunks(chunk):
    """A grid step running chunk(s, dev, rows) on HOST_PREFIX_CHUNK
    queries of its rows at a time, the partials concatenated."""
    def step(r, s, dev, rows):
        return torch.cat([chunk(s, dev, slice(c0, min(c0 + HOST_PREFIX_CHUNK, rows.stop)))
                          for c0 in range(rows.start, rows.stop, HOST_PREFIX_CHUNK)])

    return step


def _results_u8(out: np.ndarray, group_size: int, slot_bytes: int,
                n: int) -> list[SecretSharedQueryResult]:
    """(Q, >= G * slot_bytes) uint8 answers of a storage table -> results."""
    sb = slot_bytes
    return [SecretSharedQueryResult(sb, [Slot(out[i, c * sb:(c + 1) * sb].tobytes())
                                         for c in range(group_size)]) for i in range(n)]


def _results_words(out: np.ndarray, group_size: int, slot_bytes: int,
                   n: int) -> list[SecretSharedQueryResult]:
    """(Q, G * words) int32 answers of a natural word table -> results."""
    res = []
    for i in range(n):
        slots = unpack_result_u32(out[i].view(np.uint32), group_size, slot_bytes)
        res.append(SecretSharedQueryResult(slot_bytes, [Slot(slots[c].tobytes())
                                                        for c in range(group_size)]))
    return res


# --------------------------------------------------------------------------
# The engine (pir_tpu/parallel/mesh.py:816-1453)
# --------------------------------------------------------------------------

class MeshPirServer:
    """Serving engine over a device grid, with TorchPirServer's query
    surface: every batch is answered by the whole grid (tp = rows, dp =
    the batch), the deployment-scale form of the reference's nprocs
    partial merge (db.go:256-261).

    Give ``mesh`` (``make_mesh``), or tp and dp over ``device``: None is
    the process's CUDA cards (tp * dp of them; tp None takes all of them
    that dp divides), "cpu" runs the kernels' plain versions.

    Each table is built once a layout and held as one slice a row shard,
    uploaded once to each distinct device of that shard's grid column.
    """

    # the service hands uniform >= 3-party batches here whole
    batch_accepts_multi_party = True

    def __init__(self, db, mesh: TorchMesh | None = None, tp: int | None = None, dp: int = 1,
                 compat_w: int = 128, compat_max_tail: int = 3, compat_q_chunk: int = 16,
                 fast_stacked: bool = True, device: str | None = None):
        if mesh is None:
            if tp is None:
                tp = 1 if device == "cpu" else max(1, torch.cuda.device_count() // dp)
            mesh = make_mesh(tp * dp, dp=dp, device=device)
        self.db = db
        self.mesh = mesh
        self.n_shards = mesh.shape["tp"]
        self.dp = mesh.shape["dp"]
        # shared-key root batches take the stacked tail kernel a shard;
        # False: the per-query tail kernel
        self.fast_stacked = fast_stacked
        # the compat root step's cascade geometry (a fixed head of
        # 5 + log2(compat_w) levels, stages of at most compat_max_tail
        # levels, compat_q_chunk queries a stage launch)
        self.compat_w = compat_w
        self.compat_max_tail = compat_max_tail
        self.compat_q_chunk = compat_q_chunk
        # table key -> {(shard, device): tensor}; each table's per-shard
        # natural local row -> position maps for apply_updates
        self._tables: dict[tuple, dict] = {}
        self._perms: dict[tuple, list[np.ndarray]] = {}
        self._kw_planes: dict[tuple, dict] = {}
        self._leaf_perms: dict[tuple, dict] = {}
        # serialises table builds against live updates: a build that read
        # pre-update rows must not land after a patch
        self._lock = threading.RLock()

    # ---- geometry ----

    def _shard_levels(self) -> int:
        return self.n_shards.bit_length() - 1

    def _devices(self, s: int) -> list[torch.device]:
        """The distinct devices of grid column s."""
        out = []
        for d in self.mesh.devices[:, s]:
            if d not in out:
                out.append(d)
        return out

    def _stacked_tail_for(self, depth: int, n_blk: int) -> int | None:
        """The stacked tail depth of the shards' subtrees, or None on the
        per-query tail (fast_stacked=False): part of the root table's
        key, since the two kernels want different storage orders."""
        if not self.fast_stacked:
            return None
        return stacked_fast_geometry(depth - self._shard_levels(), n_blk)[1]

    def _root_applicable(self, queries) -> bool:
        """Shared-key fast batches on a 2^k-way tp ride the root step; the
        shards' subtrees need >= 5 levels, so that every packed leaf word
        is full (32 leaves a word)."""
        q0 = queries[0]
        if q0.key_fast is None or self.n_shards & (self.n_shards - 1):
            return False
        if q0.key_fast.depth < self._shard_levels() + 5:
            return False
        return server_mod.TorchPirServer._batch_shares_prf_keys(queries)

    def _compat_root_geometry(self, q0):
        """(num_bits, skip, nbd) of a compat query, or None when the compat
        root step cannot shard this domain. The geometry comes from the
        database, not the key: a crafted level count must not size a table."""
        if self.n_shards & (self.n_shards - 1):
            return None
        h = self.db.db_size // q0.group_size
        num_bits = len(q0.key_two_party.cw)
        if num_bits != num_bits_for_height(h):
            return None
        skip = compat_skip_levels(num_bits, h)
        nbd = num_bits - skip
        # the cascade needs d_local > split = 5 + log2(w)
        if nbd - self._shard_levels() <= 5 + int(np.log2(self.compat_w)):
            return None
        return num_bits, skip, nbd

    def _mesh_applicable(self, query) -> bool:
        if not query.is_two_party or query.is_keyword_based:
            return False
        h = self.db.db_size // query.group_size
        if query.key_fast is not None:
            return h >= 32 * 128 * self.n_shards
        return h >= 32 * self.n_shards * 2  # the subtree split needs headroom

    def _points_applicable(self, query) -> bool:
        """Keyword and multi-party sharding wants a lane word of real rows a shard."""
        return self.db.db_size // query.group_size >= 32 * self.n_shards

    def _point_rows_per_shard(self, h: int) -> int:
        """Rows a shard for the point steps: the even split rounded up to a
        whole 32-row lane word."""
        return -(-(-(-h // self.n_shards)) // 32) * 32

    # ---- tables ----

    def _placed(self, cache: dict, key, build_shard) -> dict:
        """{(shard, device): tensor} of table `key` in `cache`, built at
        first use: shard s's numpy slice (build_shard(s)) uploaded once
        to each distinct device of grid column s."""
        with self._lock:
            placed = cache.get(key)
            if placed is None:
                placed = {}
                for s in range(self.n_shards):
                    arr = build_shard(s)
                    for dev in self._devices(s):
                        placed[(s, dev)] = torch.from_numpy(arr).to(dev)
                cache[key] = placed
            return placed

    def _words_table(self, group_size: int, rows_per_shard: int) -> dict:
        """The natural-order (rows_per_shard, G * words) int32 word table
        a shard (ops.scan.pack_table_u32, zero rows past the table)."""
        full = []

        def build(s):
            if not full:
                h = self.db.db_size // group_size
                full.append(pad_table_rows(pack_table_u32(self.db.data, h, group_size),
                                           self.n_shards * rows_per_shard))
            return full[0][s * rows_per_shard:(s + 1) * rows_per_shard].view(np.int32)

        return self._placed(self._tables, ("words", group_size, rows_per_shard), build)

    def _storage_table(self, key, group_size: int, flat: int, perm_of) -> dict:
        """A storage-ordered u8 table a shard: shard s's rows scattered by
        perm_of(local_h), rows padded to a multiple of PAD_TO, bytes to a
        multiple of 4; the maps are kept for apply_updates."""
        def build(s):
            rows = _shard_rows(self.db.data, self.db.db_size, group_size, self.db.slot_bytes,
                               flat, s)
            perm = perm_of(len(rows))
            self._perms.setdefault(key, [None] * self.n_shards)[s] = perm
            return pad_cols_u8(_storage_shard(rows, perm, flat, PAD_TO))

        return self._placed(self._tables, key, build)

    def _root_table(self, group_size: int, depth: int, n_blk: int) -> dict:
        stacked_tail = self._stacked_tail_for(depth, n_blk)
        d_local = depth - self._shard_levels()
        return self._storage_table(
            ("root", group_size, depth, n_blk, stacked_tail), group_size,
            (128 * n_blk) << d_local,
            lambda local_h: root_shard_perm(d_local, local_h, n_blk, stacked_tail))

    def _compat_root_table(self, group_size: int, nbd: int) -> tuple[dict, tuple]:
        d_local = nbd - self._shard_levels()
        _, tails = compat_stage_plan(d_local, self.compat_w, self.compat_max_tail)
        table = self._storage_table(
            ("compat", group_size, nbd), group_size, 1 << d_local,
            lambda local_h: _compat_perm(d_local, local_h, self.compat_w, tails))
        return table, tails

    def _kw_planes_sharded(self, group_size: int, rows_per_shard: int) -> dict:
        """The rows' keywords as (32, rows_per_shard / 32) branch-bit planes
        a shard (dpf.device.pack_point_bit_planes; keyword 0 on padded
        rows, which scan zero rows). Keywords are immutable under updates."""
        h = self.db.db_size // group_size

        def build(s):
            kws = np.zeros(rows_per_shard, dtype=np.int64)
            lo, hi = s * rows_per_shard, min(h, (s + 1) * rows_per_shard)
            if hi > lo:
                kws[:hi - lo] = server_mod._keywords(self.db, h)[lo:hi].astype(np.int64)
            return pack_point_bit_planes(kws, 32).view(np.int32)

        return self._placed(self._kw_planes, (group_size, rows_per_shard), build)

    def _leaf_perm(self, key, build) -> dict:
        """A host-prefix step's natural local row -> flat bit map (the same
        for every shard) on each device of the grid."""
        with self._lock:
            placed = self._leaf_perms.get(key)
            if placed is None:
                perm = torch.from_numpy(build())
                placed = self._leaf_perms[key] = {d: perm.to(d) for d in
                                                  set(self.mesh.devices.ravel())}
            return placed

    # ---- live updates ----

    def apply_updates(self, updates: dict[int, bytes]) -> None:
        """Apply slot updates ``{index: new_bytes}`` to the database and to
        every cached shard table on its device (counterpart of
        pir_tpu/parallel/mesh.py:apply_updates): one row scatter into a
        clone of each shard slice the updates touch, the table's slices
        swapped in together under the lock, so a batch holding the old
        table finishes on the old rows and never sees some shards new."""
        with self._lock:
            self.db.update_slots(updates, copy_on_write=True)
            idxs = np.unique(np.fromiter((int(i) for i in updates), dtype=np.int64,
                                         count=len(updates)))
            for key, placed in list(self._tables.items()):
                patches = self._shard_patches(key, idxs)
                if not patches:
                    continue
                new = dict(placed)
                for (s, dev), tbl in placed.items():
                    if s in patches:
                        pos, vals = patches[s]
                        t = tbl.clone()
                        t[torch.from_numpy(pos).to(dev)] = torch.from_numpy(
                            np.ascontiguousarray(vals)).to(dev)
                        new[(s, dev)] = t
                self._tables[key] = new

    def _shard_patches(self, key, idxs) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """{shard: (local positions, new row contents)} of table `key` for
        the updated slots `idxs`."""
        kind, g = key[0], key[1]
        h = self.db.db_size // g
        r = np.unique(idxs // g)
        r = r[r < h]
        if not len(r):
            return {}
        if kind == "words":
            rps = key[2]
        elif kind == "root":
            _, _, depth, n_blk, _ = key
            rps = (128 * n_blk) << (depth - self._shard_levels())
        else:
            rps = 1 << (key[2] - self._shard_levels())
        sb = self.db.slot_bytes
        patches = {}
        for s in np.unique(r // rps):
            rs = r[r // rps == s]
            loc = rs - s * rps
            if kind == "words":
                patches[int(s)] = (loc, pack_rows_u32(self.db.data, rs, g, sb).view(np.int32))
            else:
                raw = self.db.data[: h * g].reshape(h, g * sb)[rs]
                patches[int(s)] = (self._perms[key][s][loc], pad_cols_u8(raw))
        return patches

    # ---- running a step on the grid ----

    def _grid(self, n: int, step) -> np.ndarray:
        """Run step(r, s, dev, rows) -> partial for every shard s of every
        grid row r, rows the slice of the (padded) batch that row answers;
        all shards are launched before any is read. Each row's partials
        are copied to its lead device and folded with XOR; -> the (n, C)
        answers on the host."""
        per = n // self.dp
        partials = [[step(r, s, dev, slice(r * per, (r + 1) * per))
                     for s, dev in enumerate(self.mesh.devices[r])] for r in range(self.dp)]
        outs = []
        for r, row in enumerate(partials):
            lead = self.mesh.devices[r, 0]
            acc = row[0]
            for p in row[1:]:
                acc = acc ^ p.to(lead)
            outs.append(acc)
        return torch.cat([o.cpu() for o in outs]).numpy()

    def _uploads(self, arrays):
        """Per-device upload cache of numpy uint32 arrays: get(dev, rows)
        -> the tensors of arrays[i][rows] on dev."""
        done = {}

        def get(dev, rows):
            k = (dev, rows.start)
            if k not in done:
                done[k] = [u32_tensor(np.ascontiguousarray(a[rows]), dev) for a in arrays]
            return done[k]

        return get

    # ---- root steps (pir_tpu/parallel/mesh.py:295-632) ----

    def _answer_batch_fast_root(self, queries):
        g = queries[0].group_size
        pay, layout = make_fast_payload_batch(queries, shared_rk=True)
        with self._lock:
            tables = self._root_table(g, queries[0].key_fast.depth, layout.leaf_blocks)
        levels = self._shard_levels()
        up = self._uploads([pay])

        def step(r, s, dev, rows):
            (p,) = up(dev, rows)
            if self.fast_stacked:
                return fused_fast_root_batch_stacked(tables[(s, dev)], p, layout, (s, levels))
            return fused_fast_root_batch_pertail(tables[(s, dev)], p, layout, TAIL_LEVELS,
                                                 (s, levels))

        return _results_u8(self._grid(len(queries), step), g, self.db.slot_bytes, len(queries))

    def _answer_batch_compat_root(self, queries, geometry):
        _, _, nbd = geometry
        g = queries[0].group_size
        h = self.db.db_size // g
        n = len(queries)
        m = pow2_padded_len(n, self.dp, self.compat_q_chunk)
        if m > n:
            queries = pad_tile(queries, m)
        pay, layout = make_compat_payload_batch(queries, height=h)
        with self._lock:
            tables, tails = self._compat_root_table(g, nbd)
        levels = self._shard_levels()
        up = self._uploads([pay])

        def step(r, s, dev, rows):
            (p,) = up(dev, rows)
            return fused_compat_root_batch(tables[(s, dev)], p, layout, w=self.compat_w,
                                           tails=tails, q_chunk=self.compat_q_chunk,
                                           shard=(s, levels))

        return _results_u8(self._grid(m, step), g, self.db.slot_bytes, n)

    # ---- host-prefix steps (pir_tpu/parallel/mesh.py:254-292, :1461-1514) ----

    def _answer_batch_fast(self, queries):
        g = queries[0].group_size
        keys = [make_sharded_fast_key(dpf_host.server_initialize(q.prf_keys, q.key_fast.depth),
                                      q.key_fast, self.n_shards) for q in queries]
        k0 = keys[0]
        n_blk = k0.fcw_masks.shape[1] if k0.fcw_masks.ndim == 4 else 1
        seeds = np.stack([k.seeds for k in keys], axis=1)  # (D, Q, 8, 16, NWs)
        t = np.stack([k.t for k in keys], axis=1)
        common = [np.stack([getattr(k, a) for k in keys]) for a in (
            "cw_seed_masks", "cw_tl", "cw_tr", "fcw_masks", "rk_masks", "rk_leaf")]
        perms = self._leaf_perm(("fast", k0.d_levels, k0.per_shard_nodes, n_blk),
                                lambda: _fast_leaf_perm(k0.d_levels, k0.rows_per_shard,
                                                        k0.per_shard_nodes, n_blk))
        with self._lock:
            tables = self._words_table(g, k0.rows_per_shard)
        up = self._uploads(common)
        shard_up = [self._uploads([seeds[s], t[s]]) for s in range(self.n_shards)]

        def chunk(s, dev, rows):
            cw_s, cw_tl, cw_tr, fcw, rk, rk_leaf = up(dev, rows)
            sd, tt = shard_up[s](dev, rows)
            x, tt = _expand_planes_loop(sd.transpose(0, 1), tt, cw_s.permute(1, 2, 0, 3, 4),
                                        cw_tl.t()[..., None], cw_tr.t()[..., None],
                                        _rk_bit_first(rk), k0.d_levels)
            bits = fast_leaf_bits_flat_batch(x, tt, fcw, rk_leaf)[:, perms[dev]]
            return masked_xor_scan(tables[(s, dev)], bits)

        n = len(queries)
        return _results_words(self._grid(n, _in_chunks(chunk)), g, self.db.slot_bytes, n)

    def _answer_batch_compat(self, queries):
        g = queries[0].group_size
        h = self.db.db_size // g
        nb = num_bits_for_height(h)
        keys = [make_sharded_key(dpf_host.server_initialize(q.prf_keys, nb), q.key_two_party, h,
                                 self.n_shards) for q in queries]
        k0 = keys[0]
        seeds = np.stack([k.seeds for k in keys], axis=1)
        t = np.stack([k.t for k in keys], axis=1)
        common = [np.stack([getattr(k, a) for k in keys]) for a in (
            "cw_seed_masks", "cw_tl", "cw_tr", "rk_masks")]
        fcw = np.array([k.fcw_mask for k in keys], dtype=np.uint32)
        per_shard_nodes = k0.seeds.shape[-1] * 32
        perms = self._leaf_perm(("compat", k0.d_levels, per_shard_nodes),
                                lambda: shard_local_perm(k0.d_levels, per_shard_nodes))
        with self._lock:
            tables = self._words_table(g, k0.rows_per_shard)
        up = self._uploads(common + [fcw])
        shard_up = [self._uploads([seeds[s], t[s]]) for s in range(self.n_shards)]

        def chunk(s, dev, rows):
            cw_s, cw_tl, cw_tr, rk, f = up(dev, rows)
            sd, tt = shard_up[s](dev, rows)
            lanes = _queries_in_lanes(sd, tt, cw_s, cw_tl, cw_tr, f, rk)
            bits = expand_bits_planes(*lanes[:5], lanes[6], lanes[5], perms[dev],
                                      d_levels=k0.d_levels)
            return masked_xor_scan(tables[(s, dev)], bits)

        n = len(queries)
        return _results_words(self._grid(n, _in_chunks(chunk)), g, self.db.slot_bytes, n)

    # ---- point steps (pir_tpu/parallel/mesh.py:719-813) ----

    def _answer_batch_keyword(self, queries):
        g = queries[0].group_size
        h = self.db.db_size // g
        rps = self._point_rows_per_shard(h)
        with self._lock:
            tables = self._words_table(g, rps)
            planes = self._kw_planes_sharded(g, rps)
        dkeys = [make_device_point_key(dpf_host.server_initialize(q.prf_keys, 32),
                                       q.key_two_party) for q in queries]

        def step(r, s, dev, rows):
            xb = planes[(s, dev)]
            bits = eval_point_operands_bits(point_eval_operands(dkeys[rows], xb), xb, rps)
            return planes_scan(tables[(s, dev)].view(torch.uint8), bits).view(torch.int32)

        n = len(queries)
        return _results_words(self._grid(n, step), g, self.db.slot_bytes, n)

    def _answer_batch_mp(self, queries):
        q0 = queries[0]
        g = q0.group_size
        h = self.db.db_size // g
        rps = self._point_rows_per_shard(h)
        total = self.n_shards * rps
        with self._lock:
            tables = self._words_table(g, rps)
        nb = 32 if q0.is_keyword_based else num_bits_for_height(h)
        if q0.is_keyword_based:
            points = np.zeros(total, dtype=np.int64)
            points[:h] = server_mod._keywords(self.db, h).astype(np.int64)
        else:
            # padded rows evaluate garbage points against zero table rows
            points = np.arange(total, dtype=np.int64)
        ops = [mp_point_operands(dpf_host.server_initialize(q.prf_keys, nb), q.key_multi_party,
                                 points) for q in queries]
        nw = rps // 32

        def step(r, s, dev, rows):
            lanes = slice(s * nw, (s + 1) * nw)
            ys = [mp_point_packed_core(*(u32_tensor(np.ascontiguousarray(
                a if i == 1 else a[..., lanes]), dev) for i, a in enumerate(o[:6])), o[6])
                for o in ops[rows]]
            bits = _unpack_bits(torch.stack(ys))
            return planes_scan(tables[(s, dev)].view(torch.uint8), bits).view(torch.int32)

        n = len(queries)
        return _results_words(self._grid(n, step), g, self.db.slot_bytes, n)

    # ---- the host golden's surface (audit reuse) ----

    def expand_shared_query(self, query):
        """(H,) bool selection bits of one share, from the host golden."""
        return server_mod.expand_shared_query(self.db, query)

    def private_secret_shared_query_with_expanded_bits(self, query, bits):
        """The host golden's scan with the given selection bits."""
        if isinstance(bits, torch.Tensor):
            bits = bits.cpu().numpy()
        return server_mod.private_secret_shared_query_with_expanded_bits(
            self.db, query, np.asarray(bits).astype(bool))

    # ---- routing (pir_tpu/parallel/mesh.py:1386-1449) ----

    def private_secret_shared_query_batch(self, queries) -> list[SecretSharedQueryResult]:
        """Answer a batch on the grid: the route of pir_tpu's
        MeshPirServer for the same batch, with its bytes."""
        if not queries:
            return []
        q0 = queries[0]
        uniform = all(
            q.group_size == q0.group_size
            and q.is_two_party == q0.is_two_party
            and q.is_keyword_based == q0.is_keyword_based
            and (q.key_fast is not None) == (q0.key_fast is not None)
            and (q.key_fast is None or q.key_fast.leaf_bits == q0.key_fast.leaf_bits)
            for q in queries)
        if q0.key_fast is not None:
            # crafted depth or leaf geometry fails before any table build
            server_mod.validate_fast_key_geometry(q0.key_fast, self.db.db_size // q0.group_size)
        if uniform:  # every key's geometry, before it sizes an allocation
            for q in queries:
                server_mod.check_share(q, self.db.db_size // q.group_size)
        # the root steps carry their own (weaker) capacity gates, so they
        # are checked before the host-prefix steps' (_mesh_applicable)
        root = (uniform and q0.key_fast is not None and not q0.is_keyword_based
                and q0.is_two_party and self._root_applicable(queries))
        if uniform and q0.key_fast is None and q0.is_two_party and not q0.is_keyword_based:
            geo = self._compat_root_geometry(q0)
            if geo is not None:
                return self._answer_batch_compat_root(queries, geo)
        n = len(queries)
        m = pow2_padded_len(n, self.dp)
        padded = pad_tile(queries, m) if m > n else queries
        if uniform and self._points_applicable(q0):
            if q0.is_keyword_based and q0.is_two_party:
                return self._answer_batch_keyword(padded)[:n]
            if (not q0.is_two_party
                    and len({q.key_multi_party.num_parties for q in queries}) == 1):
                return self._answer_batch_mp(padded)[:n]
        if not root and (not uniform or not self._mesh_applicable(q0)):
            return [server_mod.private_secret_shared_query(self.db, q) for q in queries]
        if root:
            return self._answer_batch_fast_root(padded)[:n]
        if q0.key_fast is not None:
            return self._answer_batch_fast(padded)[:n]
        return self._answer_batch_compat(padded)[:n]

    def private_secret_shared_query(self, query) -> SecretSharedQueryResult:
        return self.private_secret_shared_query_batch([query])[0]
