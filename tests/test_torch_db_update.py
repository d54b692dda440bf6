"""Live updates and persistence of pir_tpu_torch vs pir_tpu.

Cases mirror tests/test_db_update.py: ``Database.update_slots`` and
``save`` / ``load`` (checkpoints cross between the packages with equal
bytes); every table ``TorchPirServer.apply_updates`` patches equals a
fresh server's rebuild; after updates every path answers as TpuPirServer
does after its own ``apply_updates`` (equal answer shares, its answers
taken share by share) and recovers the new rows; queries concurrent with updates see old or new rows, never
torn ones. The serving streams: tests/test_torch_db_update_stream.py. Shares are pir_tpu's
keygen, carried across with pir_tpu_torch.state. Tolerance 0.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_keyword import port_share as port_keyword_share
from test_torch_single import _pir_tpu_answer, to_port

from pir_tpu import query as jq
from pir_tpu.database import Database as JDatabase
from pir_tpu.database import generate_random_db
from pir_tpu.server import TpuPirServer
from pir_tpu_torch import query as tq
from pir_tpu_torch.database import Database
from pir_tpu_torch.ops.scan import pack_rows_u32, pack_table_u32
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.slot import Slot
from pir_tpu_torch.state import database_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# one table height for every JAX program (2^13 x 8 B: the fused stream's
# smallest tiling); the servers walk levels on the host until 4096 nodes
# are live, as tests/test_torch_single.py's do, so JAX compiles less
HEIGHT = 1 << 13
SLOT = 8
BATCH = 16
MDN = 4096


def _rows(results):
    return np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8) for r in results])


def _keyword_db(rows, slot, seed):
    db = generate_random_db(rows, slot)
    rng = np.random.default_rng(seed)
    db.set_keywords(rng.choice(1 << 32, size=rows, replace=False).astype(np.uint64))
    return db


def _port_db(db):
    return database_from_numpy(np.array(db.data), db.slot_bytes, keywords=db.keywords)


def _updates(rng, rows, slot, n):
    """n distinct rows, their first and last among them, new bytes of
    every length up to `slot` (an empty one zeroes its row)."""
    idx = rng.choice(rows, size=n, replace=False)
    idx[:2] = 0, rows - 1
    return {int(i): rng.bytes(int(rng.integers(0, slot + 1))) for i in idx}


# ---- Database ------------------------------------------------------------------

def test_update_slots_semantics(tmp_path):
    db = database_from_numpy(generate_random_db(64, 8).data, 8)
    db.update_slots({3: b"\x01\x02", 5: Slot(b"\xff" * 8)})
    assert db.data[3].tobytes() == b"\x01\x02" + b"\x00" * 6  # zero-padded
    assert db.data[5].tobytes() == b"\xff" * 8
    with pytest.raises(IndexError):
        db.update_slots({64: b"x"})
    with pytest.raises(IndexError):
        db.update_slots({-1: b"x"})
    with pytest.raises(ValueError, match="slots hold 8"):
        db.update_slots({0: b"x" * 9})
    p = str(tmp_path / "ck.npz")
    db.save(p, mmap_capable=True)
    back = Database.load(p, mmap=True)
    with pytest.raises(ValueError, match="read-only"):
        back.update_slots({0: b"y"})
    old = back.data
    back.update_slots({0: b"y"}, copy_on_write=True)  # a patched copy replaces the map
    assert back.data is not old and back.data[0, 0] == ord("y") and old[0, 0] == db.data[0, 0]


@pytest.mark.parametrize("writer", ["pir_tpu", "port"])
@pytest.mark.parametrize("mmap_capable,mmap", [(False, False), (True, False), (True, True)])
def test_checkpoints_load_across_packages(tmp_path, writer, mmap_capable, mmap):
    jdb = _keyword_db(300, 5, 1)
    tdb = _port_db(jdb)
    path = str(tmp_path / "db")  # no suffix: both add .npz and .data.npy
    (jdb if writer == "pir_tpu" else tdb).save(path, mmap_capable=mmap_capable)
    readers = {"pir_tpu": JDatabase.load, "port": Database.load}
    for name, load in readers.items():
        back = load(path, mmap=mmap)
        assert (back.slot_bytes, back.db_size) == (5, 300), name
        assert back.data.tobytes() == jdb.data.tobytes(), name
        assert np.array_equal(back.keywords, jdb.keywords), name
        assert isinstance(back.data, np.memmap) == (mmap_capable and mmap), name
        assert back.data.flags.writeable == (not (mmap_capable and mmap)), name


def test_pack_rows_u32_is_pack_table_u32_of_the_rows():
    data = np.random.default_rng(2).integers(0, 256, (40, 7), dtype=np.uint8)
    rows = np.array([0, 3, 19])
    assert np.array_equal(pack_rows_u32(data, rows, 2, 7), pack_table_u32(data, 20, 2)[rows])


# ---- every cached table equals a rebuild ----------------------------------------

def _populate(tdb, g, rng):
    """A stacked and a per-query tail server with every table kind of
    group size g: storage tables (stacked, classic, compat), the natural
    word table and, for g = 1, keyword planes."""
    md = tdb.metadata()
    h = tdb.db_size // g
    idx = [int(i) for i in rng.integers(0, h, size=BATCH)]
    servers = [TorchPirServer(tdb, device="cpu", min_device_nodes=MDN),
               TorchPirServer(tdb, device="cpu", min_device_nodes=MDN, fast_stacked=False)]
    fast = tq.new_index_query_shares_batch(md, idx, g, fast=True, rand_bytes=rng.bytes)
    compat = tq.new_index_query_shares_batch(md, idx, g, rand_bytes=rng.bytes)
    for srv in servers:
        srv.private_secret_shared_query_batch([p[0] for p in fast])
    srv = servers[0]
    srv.private_secret_shared_query_batch([p[0] for p in compat])
    srv.private_secret_shared_query(compat[0][0])
    if g == 1:
        srv.private_secret_shared_query(
            tq.new_keyword_query_shares(md, int(tdb.keywords[5]), 1, rand_bytes=rng.bytes)[0])
    return servers


@pytest.mark.parametrize("rows,slot,g", [(HEIGHT, SLOT, 1), (HEIGHT, 4, 2), (HEIGHT, 3, 1)],
                         ids=["1-slot groups", "2-slot groups", "3-byte slots"])
def test_apply_updates_patches_equal_rebuild(rows, slot, g):
    tdb = _port_db(_keyword_db(rows, slot, 3))
    servers = _populate(tdb, g, np.random.default_rng(4))
    kinds = {k[0] if isinstance(k[0], str) else "stacked" for k in servers[0]._tables}
    assert {"stacked", "compat", "words"} <= kinds
    assert any(k[0] == "classic" for k in servers[1]._tables)
    planes = {k: v for k, v in servers[0]._tables.items() if k[0] == "keyword planes"}
    updates = _updates(np.random.default_rng(5), rows, slot, 40)
    for srv in servers:
        srv.apply_updates(updates)
    for i, b in updates.items():
        assert tdb.data[i].tobytes() == b + bytes(slot - len(b))
    fresh = _populate(tdb, g, np.random.default_rng(4))
    for srv, new in zip(servers, fresh):
        assert set(srv._tables) == set(new._tables)
        for key, table in new._tables.items():
            assert torch.equal(srv._tables[key], table), key
    for key, table in planes.items():  # keyword planes derive from keywords alone
        assert servers[0]._tables[key] is table


# ---- answers after updates vs TpuPirServer ---------------------------------------

# path -> (its shares in _path_shares, its port server in the updated fixture)
PATHS = {"fast batch": ("fast batch", "stacked"), "fast batch pertail": ("fast batch", "pertail"),
         "compat batch": ("compat batch", "stacked"), "fast single": ("fast single", "stacked"),
         "compat single": ("compat single", "stacked"),
         "keyword single": ("keyword single", "stacked")}


@pytest.fixture(scope="module")
def updated():
    """One pir_tpu server and the port's stacked and per-query tail
    servers over one keyword table, every path run once before the
    update (so each cached table is patched, not rebuilt), and the update
    applied to all three: (jax db, port db, jax server, {"stacked": port,
    "pertail": port}, updated rows)."""
    db = _keyword_db(HEIGHT, SLOT, 6)
    tdb = _port_db(db)
    jsrv = TpuPirServer(db, use_pallas=True, min_device_nodes=MDN)
    servers = {"stacked": TorchPirServer(tdb, device="cpu", min_device_nodes=MDN),
               "pertail": TorchPirServer(tdb, device="cpu", fast_stacked=False,
                                         min_device_nodes=MDN)}
    rng = np.random.default_rng(7)
    updates = _updates(rng, HEIGHT, SLOT, 64)
    rows = sorted(updates)
    shares, _ = _path_shares(db, rows, rng)
    for share_key, server_key in PATHS.values():
        _reference(jsrv, shares[share_key], 0)
        _answer(servers[server_key], shares[share_key], 0)
    jsrv.apply_updates(updates)
    for tsrv in servers.values():
        tsrv.apply_updates(updates)
    return db, tdb, jsrv, servers, rows


def _path_shares(db, rows, rng):
    """Share pairs of every path, half the fast batch's queries and all
    others on updated rows; and each path's target rows."""
    md = db.metadata()
    idx = [int(i) for i in rng.integers(0, HEIGHT, size=BATCH)]
    idx[: BATCH // 2] = rows[: BATCH // 2]
    kw_row = rows[2]
    shares = {"fast batch": jq.new_index_query_shares_batch(md, idx, 1, 2, fast=True),
              "compat batch": jq.new_index_query_shares_batch(md, idx[:8], 1, 2),
              "fast single": [jq.new_index_query_shares(md, rows[3], 1, 2, fast=True)],
              "compat single": [jq.new_index_query_shares(md, rows[4], 1, 2)],
              "keyword single": [jq.new_keyword_query_shares(md, int(db.keywords[kw_row]),
                                                             1, 2)]}
    targets = {"fast batch": idx, "compat batch": idx[:8], "fast single": [rows[3]],
               "compat single": [rows[4]], "keyword single": [kw_row]}
    return shares, targets


def _answer(tsrv, pairs, part):
    """The port server's answers through the path the shares pick: one
    share a single query, more a batch."""
    shares = [p[part] for p in pairs]
    shares = ([port_keyword_share(s) for s in shares] if shares[0].is_keyword_based
              else to_port(shares))
    if len(shares) == 1:
        return _rows([tsrv.private_secret_shared_query(shares[0])])
    return _rows(tsrv.private_secret_shared_query_batch(shares))


def _reference(jsrv, pairs, part):
    """TpuPirServer's answers, share by share: compat and keyword shares
    through its single-query API, fast shares through its expand + scan
    API, as tests/test_torch_single.py takes them. Its batch paths give
    equal bytes (tests/test_torch_server.py, tests/test_torch_compat.py)
    but compile ~15-50 s each in interpret mode."""
    return np.concatenate([np.stack([np.frombuffer(a, np.uint8)
                                     for a in _pir_tpu_answer(jsrv, p[part])])
                           for p in pairs])


@pytest.mark.parametrize("path", list(PATHS))
def test_answers_after_updates_match_pir_tpu(updated, path):
    db, tdb, jsrv, servers, rows = updated
    shares, targets = _path_shares(db, rows, np.random.default_rng(8))
    share_key, server_key = PATHS[path]
    pairs, targets = shares[share_key], targets[share_key]
    got = [_answer(servers[server_key], pairs, part) for part in (0, 1)]
    for part in (0, 1):
        assert (got[part] == _reference(jsrv, pairs, part)).all(), f"share {part} differs"
    assert (tdb.data == db.data).all()
    assert ((got[0] ^ got[1]) == tdb.data[targets]).all()
    assert sum(t in rows for t in targets) >= len(targets) // 2


# ---- concurrent queries ----------------------------------------------------------------

def test_concurrent_queries_see_old_or_new_rows():
    """A thread answers both shares of a query for one row while the main
    thread applies 10 updates to it: each answer is the old row or one
    of the new ones, never a mix; once quiet, the last update."""
    jdb = generate_random_db(1 << 9, 8)
    tdb = _port_db(jdb)
    srv = TorchPirServer(tdb, device="cpu")
    md = tdb.metadata()
    idx = 123
    allowed = {tdb.data[idx].tobytes()} | {bytes([k]) * 8 for k in range(10)}
    stop = threading.Event()
    seen, errors = [], []

    def hammer():
        rng = np.random.default_rng(10)
        while not stop.is_set():
            try:
                for fast in (True, False):
                    shares = tq.new_index_query_shares(md, idx, 1, fast=fast, rand_bytes=rng.bytes)
                    answers = [srv.private_secret_shared_query(s) for s in shares]
                    seen.append(bytes(tq.recover(answers)[0].data))
            except Exception as e:  # surfaced by the assertion below
                errors.append(e)
                return

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        worker = threading.Thread(target=hammer)
        worker.start()
        for k in range(10):
            while len(seen) <= k and worker.is_alive():  # a read between updates
                time.sleep(1e-3)
            srv.apply_updates({idx: bytes([k]) * 8})
        stop.set()
        worker.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not worker.is_alive()
    assert not errors, errors
    assert seen and set(seen) <= allowed, set(seen) - allowed
    shares = tq.new_index_query_shares(md, idx, 1, fast=True)
    assert bytes(tq.recover([srv.private_secret_shared_query(s) for s in shares])[0].data) == \
        bytes([9]) * 8
