"""pir_tpu_torch.service (PirService / PirClient) against pir_tpu.service.

Port services run the torch engine on the CPU (``PirConfig(device="cpu")``,
cPIR in CPython unless a test asks for the "torch" cPIR engine),
pir_tpu services their host engine; both serve the same tables. Over
real sockets:

* a client of each package recovers every row from the other package's
  services (and a port client from port services), through every
  protocol family: index (fast and compat; single, batch and stream),
  keyword (DPF single and batch, the sqrt tree, the BST), multi-party
  index, cPIR (plain and recursive), and both ASPIR variants;
* raw frames made by pir_tpu get byte-equal response frames from both
  packages' services, for every opcode whose answer is deterministic;
* the port's engine choice: ``PirService()`` with no config and no GPU
  raises, ``pick_engine`` resolves "auto" to "torch", the mesh
  configs to "mesh" (a mesh service on 2 x 2 CPU shards answers every
  batch kind) and "native" to "native", pir_tpu's engines with no port
  are refused, a failure in the stream's kernel path
  reaches the client as OP_ERROR (only the stream's refusal of a batch
  falls back to emulation), and concurrent first queries on one service
  are answered right.

The tables are 2^10 rows of 16 B (keywords, an 8 B auth-key table) and,
for the stream's device path, 2^15 rows of 8 B: the stacked stream takes
fast keys of depth >= 5, 2^15 rows at the default 1024-bit leaves (as
tests/test_service_stream.py). No TpuPirServer is built.
"""

import random
import socket
import struct
import sys
import threading

import numpy as np
import pytest
import torch

import pir_tpu.config as jcfg
import pir_tpu.keyword as jkw
import pir_tpu.service as jsvc
from pir_tpu import query as jq
from pir_tpu import wire as jw
from pir_tpu.aspir import auth_prove, new_authenticated_query
from pir_tpu.aspir_shared import AuditTokenShare, new_authenticated_index_query_shares
from pir_tpu.crypto import paillier as jp
from pir_tpu.database import generate_random_db as j_random_db
from pir_tpu.encrypted import new_doubly_encrypted_query, new_encrypted_query
from pir_tpu.slot import Slot as JSlot
from pir_tpu_torch import config as tcfg
from pir_tpu_torch import keyword as tkw
from pir_tpu_torch import service as tsvc
from pir_tpu_torch import state
from pir_tpu_torch.crypto import paillier as tp
from pir_tpu_torch.server import TorchPirServer

from torch_threads import one_torch_thread  # noqa: F401

HEIGHT, SLOT, KEY_BYTES = 1 << 10, 16, 8
STREAM_HEIGHT, STREAM_SLOT = 1 << 15, 8
TREE_KEYS = 256
CPU = tcfg.PirConfig(device="cpu", paillier_engine="python")


class Tables:
    """The same tables in both packages' Database types."""

    def __init__(self):
        rng = np.random.default_rng(31)
        self.data = rng.integers(0, 256, size=(HEIGHT, SLOT), dtype=np.uint8)
        self.keys = rng.integers(0, 256, size=(HEIGHT, KEY_BYTES), dtype=np.uint8)
        self.keywords = rng.choice(1 << 32, size=HEIGHT, replace=False).astype(np.uint64)
        self.stream = rng.integers(0, 256, size=(STREAM_HEIGHT, STREAM_SLOT), dtype=np.uint8)
        self.tree = sorted((f"key-{i:04d}" for i in range(TREE_KEYS)), reverse=True)

    def db(self, pkg, data, keywords=None):
        if pkg == "torch":
            return state.database_from_numpy(data, data.shape[1], keywords=keywords)
        db = j_random_db(*data.shape)
        db.data = data.copy()
        if keywords is not None:
            db.set_keywords(keywords)
        return db


@pytest.fixture(scope="module")
def tables():
    return Tables()


class Services:
    """One package's services over the tables: a pair hosting the data
    (with keywords) and the auth keys, service 0 the audit leader; a
    third data service for 3-party shares; pairs hosting the sqrt tree,
    the BST and the stream table."""

    def __init__(self, pkg, t: Tables):
        svc = tsvc if pkg == "torch" else jsvc
        kw = tkw if pkg == "torch" else jkw
        extra = {"config": CPU} if pkg == "torch" else {}
        self.pkg = pkg
        self.db = t.db(pkg, t.data, t.keywords)
        self.key_db = t.db(pkg, t.keys)
        lead = svc.PirService(self.db, key_db=self.key_db, **extra).start()
        peer = svc.PirService(self.db, key_db=self.key_db, audit_leader=lead.address,
                              **extra).start()
        self.main = [lead, peer]
        self.third = [svc.PirService(self.db, **extra).start()]
        tree_kw = {"device": "cpu"} if pkg == "torch" else {}
        st = kw.new_private_sqrt_st(**tree_kw)
        st.build_for_data(t.tree)
        self.sqrt = [svc.PirService(sqrt_st=st, **extra).start() for _ in range(2)]
        bst = kw.new_private_bst(**tree_kw)
        bst.build_for_data(t.tree)
        self.bst = [svc.PirService(bst=bst, **extra).start() for _ in range(2)]
        self.stream_db = t.db(pkg, t.stream)
        self.stream = [svc.PirService(self.stream_db, **extra).start() for _ in range(2)]
        self.all = self.main + self.third + self.sqrt + self.bst + self.stream

    def addresses(self, group):
        return [s.address for s in getattr(self, group)]

    def close(self):
        _close_all(self.all)


def _close_all(services):
    """Close services at once (each shutdown waits out a 0.5 s poll)."""
    threads = [threading.Thread(target=s.close) for s in services]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


@pytest.fixture(scope="module")
def services(tables):
    made = {pkg: Services(pkg, tables) for pkg in ("jax", "torch")}
    yield made
    for s in made.values():
        s.close()


def _row(res):
    return bytes(res[0].data)


def _flows(client_pkg, srv: Services, t: Tables):
    """Every protocol family through a `client_pkg` client against `srv`;
    every answer must recover its row."""
    svc = tsvc if client_pkg == "torch" else jsvc
    pai = tp if client_pkg == "torch" else jp
    rnd = random.Random(7)
    data = t.data
    c = svc.PirClient(srv.addresses("main"))
    try:
        assert (c.metadata.slot_bytes, c.metadata.db_size) == (SLOT, HEIGHT)
        for fast in (False, True):
            for i in (0, HEIGHT - 1, rnd.randrange(HEIGHT)):
                assert _row(c.query_index(i, fast=fast)) == data[i].tobytes()
            idx = [rnd.randrange(HEIGHT) for _ in range(9)]
            got = c.query_index_batch(idx, fast=fast)
            assert [_row(r) for r in got] == [data[i].tobytes() for i in idx]
        g = c.query_index(5, group_size=2)
        assert [bytes(s.data) for s in g] == [data[10].tobytes(), data[11].tobytes()]
        # the serving stream on a table too shallow for the device stream
        # (emulated in the shell on every engine)
        stream = c.open_stream()
        assert stream.submit([1, 2, 3]) is None
        got = stream.submit([4, 5, 6])
        assert [_row(r) for r in got] == [data[i].tobytes() for i in (1, 2, 3)]
        assert [_row(r) for r in stream.flush()] == [data[i].tobytes() for i in (4, 5, 6)]
        # keyword DPF
        rows = [rnd.randrange(HEIGHT) for _ in range(8)]
        got = c.query_keyword_dpf_batch([int(t.keywords[r]) for r in rows])
        assert [_row(r) for r in got] == [data[r].tobytes() for r in rows]
        assert _row(c.query_keyword_dpf(int(t.keywords[rows[0]]))) == data[rows[0]].tobytes()
        # cPIR, plain and recursive, on one server
        sk, pk = pai.keygen(128)
        width, _ = c.metadata.get_dimensions_for_database(int(np.ceil(np.sqrt(HEIGHT))), 1)
        slots = c.query_encrypted(3, sk, pk)
        assert [bytes(s.data) for s in slots] == [data[3 * width + j].tobytes()
                                                  for j in range(width)]
        assert _row(c.query_encrypted_recursive(1000, sk, pk, server=1)) == data[1000].tobytes()
        # ASPIR, shared variant: single, batch (one wrong key), audit shares
        keys = t.keys
        slot_cls = type(g[0])
        key = slot_cls(keys[77].tobytes())
        assert _row(c.query_index_authenticated(77, key, fast=True)) == data[77].tobytes()
        with pytest.raises(PermissionError):
            c.query_index_authenticated(78, key)
        idx = [11, 12, 13]
        got = c.query_index_authenticated_batch(
            idx, [slot_cls(keys[i].tobytes()) for i in (11, 99, 13)], strict=False)
        assert got[1] is None
        assert [_row(got[0]), _row(got[2])] == [data[11].tobytes(), data[13].tobytes()]
        audits = c.fetch_audit_shares(40, slot_cls(keys[40].tobytes()))
        acc = bytearray(KEY_BYTES)
        for a in audits:
            acc = bytearray(x ^ y for x, y in zip(acc, a.t.data))
        assert not any(acc)
        # ASPIR, AHE variant: the right key, then a wrong one
        assert _row(c.query_authenticated(9, sk, slot_cls(keys[9].tobytes()))) == \
            data[9].tobytes()
        with pytest.raises(PermissionError):
            c.query_authenticated(9, sk, slot_cls(keys[8].tobytes()))
        stats = c.get_metrics()
        assert stats["queries"] > 0
        if srv.pkg == "torch":  # the port's span totals ride along
            assert stats["spans"]["pir.dispatch"]["count"] > 0
    finally:
        c.close()
    # multi-party (3 servers) index queries
    c3 = svc.PirClient(srv.addresses("main") + srv.addresses("third"))
    try:
        for i in (0, rnd.randrange(HEIGHT)):
            assert _row(c3.query_index(i)) == data[i].tobytes()
        idx = [rnd.randrange(HEIGHT) for _ in range(2)]
        assert [_row(r) for r in c3.query_index_batch(idx, fast=False)] == [
            data[i].tobytes() for i in idx]
    finally:
        c3.close()
    # keyword search trees
    for group in ("sqrt", "bst"):
        ck = svc.PirClient(srv.addresses(group))
        try:
            for i in (0, TREE_KEYS - 1, 100):
                key = t.tree[i]
                present, gidx, slots = (ck.query_keyword(key) if group == "sqrt"
                                        else ck.query_keyword_bst(key))
                assert present and gidx == i
            present, _, _ = (ck.query_keyword("absent") if group == "sqrt"
                             else ck.query_keyword_bst("absent"))
            assert not present
        finally:
            ck.close()
    # the stream on the 2^15-row table (the port's device stream)
    cs = svc.PirClient(srv.addresses("stream"))
    try:
        stream = cs.open_stream()
        batches = [[rnd.randrange(STREAM_HEIGHT) for _ in range(8)] for _ in range(3)]
        outs = [stream.submit(b) for b in batches][1:] + [stream.flush()]
        for b, out in zip(batches, outs):
            assert [_row(r) for r in out] == [t.stream[i].tobytes() for i in b]
    finally:
        cs.close()


@pytest.mark.parametrize("client,server", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_every_family_recovers_across_packages(services, tables, client, server):
    _flows(client, services[server], tables)


# ---- raw frames: pir_tpu's bytes in, equal bytes out ----

def _fan(addresses, frames):
    """Send frames[k] to addresses[k] on fresh connections, all before
    any answer is read (the shared ASPIR rendezvous needs every server),
    and return the (opcode, payload) answers."""
    socks = [socket.create_connection(a) for a in addresses]
    try:
        for s, (op, payload) in zip(socks, frames):
            jsvc._send_frame(s, op, payload)
        return [jsvc._recv_frame(s) for s in socks]
    finally:
        for s in socks:
            s.close()


def _conversation(address, frames):
    """Frames sent one after the other on one connection; the answers."""
    with socket.create_connection(address) as s:
        out = []
        for op, payload in frames:
            jsvc._send_frame(s, op, payload)
            out.append(jsvc._recv_frame(s))
        return out


def _blobs(blobs):
    return jsvc._pack_blobs(blobs)


def test_raw_frames_get_byte_equal_answers(tables):
    """Every deterministic opcode: frames made by pir_tpu, sent to fresh
    services of both packages, get equal response frames."""
    t = tables
    fresh = {pkg: Services(pkg, t) for pkg in ("jax", "torch")}
    try:
        md = fresh["jax"].db.metadata()
        sk, pk = jp.keygen(128)
        rnd = random.Random(3)
        S = jw.serialize_query_share

        def pairs(fast, n):
            return jq.new_index_query_shares_batch(md, [rnd.randrange(HEIGHT) for _ in range(n)],
                                                   1, 2, fast=fast)

        fast8, compat8 = pairs(True, 8), pairs(False, 8)
        kw8 = jq.new_keyword_query_shares_batch(
            md, [int(t.keywords[rnd.randrange(HEIGHT)]) for _ in range(8)], 1)
        mp = jq.new_index_query_shares(md, 17, 1, 3)
        mixed = [fast8[0][0], compat8[0][0], kw8[0][0], mp[0]]
        single = [(jsvc.OP_METADATA, b""),
                  (jsvc.OP_QUERY, S(fast8[1][0])), (jsvc.OP_QUERY, S(compat8[1][1])),
                  (jsvc.OP_QUERY, S(kw8[1][0])), (jsvc.OP_QUERY, S(mp[2])),
                  (jsvc.OP_QUERY, S(jq.new_index_query_shares(md, 6, 4, 2)[0])),
                  (jsvc.OP_QUERY_BATCH, _blobs([S(p[0]) for p in fast8])),
                  (jsvc.OP_QUERY_BATCH, _blobs([S(p[1]) for p in compat8])),
                  (jsvc.OP_QUERY_BATCH, _blobs([S(p[0]) for p in kw8])),
                  (jsvc.OP_QUERY_BATCH, _blobs([S(s) for s in mixed])),
                  (jsvc.OP_STREAM_SUBMIT, _blobs([S(p[0]) for p in fast8[:3]])),
                  (jsvc.OP_STREAM_SUBMIT, _blobs([S(p[0]) for p in fast8[3:6]])),
                  (jsvc.OP_STREAM_FLUSH, b""),
                  (jsvc.OP_STREAM_FLUSH, b""),
                  (jsvc.OP_ENCRYPTED_QUERY,
                   jw.serialize_encrypted_query(new_encrypted_query(md, pk, 2, 5))),
                  (jsvc.OP_ENCRYPTED_QUERY_REC, jw.serialize_doubly_encrypted_query(
                      new_doubly_encrypted_query(md, pk, 1, 1000)))]
        auth_share = new_authenticated_index_query_shares(
            md, 21, JSlot(t.keys[21].tobytes()), 1, 2, fast=True)
        single += [(jsvc.OP_ASPIR_AUDIT, jw.serialize_auth_share(auth_share[0])),
                   (jsvc.OP_ASPIR_AUDIT_SUBMIT, struct.pack("<QB", 5, 1)
                    + jw.serialize_audit_share(AuditTokenShare(JSlot(bytes(KEY_BYTES))))),
                   (jsvc.OP_ASPIR_AUDIT_SUBMIT_BATCH,
                    struct.pack("<QBIH", 6, 1, 2, KEY_BYTES) + bytes(KEY_BYTES) + b"\x01" * 8)]
        aq, ast = new_authenticated_query(md, sk, 1, 30, JSlot(t.keys[30].tobytes()))
        chal_frame = (jsvc.OP_ASPIR_CHAL, struct.pack("<I", 8) + jw.serialize_auth_query(aq))
        answers = {pkg: _conversation(fresh[pkg].main[0].address, single + [chal_frame])
                   for pkg in fresh}
        assert [op for op, _ in answers["torch"]] == [op for op, _ in single + [chal_frame]]
        assert answers["torch"] == answers["jax"]
        chal_resp = answers["jax"][-1][1]
        (chal_id,) = struct.unpack_from("<Q", chal_resp, 0)
        proof = auth_prove(ast, jw.deserialize_chal_token(chal_resp[8:]))
        proof_frame = (jsvc.OP_ASPIR_PROOF,
                       struct.pack("<Q", chal_id) + jw.serialize_proof_token(proof))
        got = {pkg: _conversation(fresh[pkg].main[0].address, [proof_frame])[0]
               for pkg in fresh}
        assert got["torch"] == got["jax"] and got["jax"][1][:1] == b"\x01"
        # the shared ASPIR opcodes need both servers of a pair
        for right in (True, False):
            key = JSlot(t.keys[44 if right else 45].tobytes())
            sh = new_authenticated_index_query_shares(md, 44, key, 1, 2)
            bsh = [new_authenticated_index_query_shares(md, i, JSlot(t.keys[i].tobytes()), 1, 2,
                                                        fast=True) for i in (1, 2, 3)]
            got = {}
            for pkg in fresh:
                one = _fan(fresh[pkg].addresses("main"), [
                    (jsvc.OP_ASPIR_SHARED_QUERY,
                     struct.pack("<QB", 100 + right, 2) + jw.serialize_auth_share(sh[k]))
                    for k in (0, 1)])
                batch = _fan(fresh[pkg].addresses("main"), [
                    (jsvc.OP_ASPIR_SHARED_QUERY_BATCH,
                     struct.pack("<QB", 200 + right, 2)
                     + _blobs([jw.serialize_auth_share(b[k]) for b in bsh]))
                    for k in (0, 1)])
                got[pkg] = one + batch
            assert got["torch"] == got["jax"]
            assert got["jax"][0][0] == (jsvc.OP_ASPIR_SHARED_QUERY if right else jsvc.OP_DENIED)
        # keyword trees and the stream table's device stream
        for group, frames in (
                ("sqrt", [(jsvc.OP_SQRTST_META, b"")]),
                ("bst", [(jsvc.OP_BST_META, b"")] + [
                    (jsvc.OP_BST_LEVEL, struct.pack("<I", lvl) + S(jq.new_index_query_shares(
                        type(md)(SLOT, 1 << lvl), (1 << lvl) - 1, 1, 2)[0])) for lvl in (0, 3)]),
                ("stream", [(jsvc.OP_STREAM_SUBMIT, _blobs([S(p[0]) for p in s_batch]))
                            for s_batch in [jq.new_index_query_shares_batch(
                                type(md)(STREAM_SLOT, STREAM_HEIGHT),
                                [rnd.randrange(STREAM_HEIGHT) for _ in range(8)], 1, 2,
                                fast=True) for _ in range(2)]] + [(jsvc.OP_STREAM_FLUSH, b"")])):
            got = {pkg: _conversation(fresh[pkg].addresses(group)[0], frames) for pkg in fresh}
            assert got["torch"] == got["jax"]
            assert [op for op, _ in got["torch"]] == [op for op, _ in frames]
    finally:
        for s in fresh.values():
            s.close()


# ---- the port's engine choice ----

def test_no_config_means_the_card():
    db = state.database_from_numpy(np.zeros((64, 4), np.uint8), 4)
    if torch.cuda.is_available():
        svc = tsvc.PirService(db).start()
        try:
            assert svc.engine_name == "torch" and svc._engine.device.type == "cuda"
        finally:
            svc.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsvc.PirService(db)
    host = tsvc.PirService(db, config=tcfg.PirConfig(engine="host")).start()
    try:
        assert host.engine_name == "host" and host._engine is None
    finally:
        host.close()


def test_pick_engine_and_refused_engines(tables):
    """pick_engine: "auto" is "torch"; the mesh configs resolve to "mesh"
    as pir_tpu's do (its "tpu" is the port's "torch"); "native" and
    paillier_engine "native" resolve as named; pir_tpu's engines with no
    port are refused. A PirService over PirConfig(engine="mesh",
    mesh_tp=2, mesh_dp=2, device="cpu") answers a client's fast, compat,
    keyword and 3-party batches and a stream, every row recovered."""
    from pir_tpu_torch.parallel.mesh import MeshPirServer

    assert tcfg.pick_engine(tcfg.PirConfig()) == "torch"
    assert tcfg.pick_engine(tcfg.PirConfig(engine="torch")) == "torch"
    assert tcfg.pick_engine(tcfg.PirConfig(engine="host")) == "host"
    # pir_tpu resolves the same config to its host or native engine on a CPU
    assert jcfg.pick_engine(jcfg.PirConfig(engine="host")) == "host"
    for kwargs in (dict(engine="mesh"), dict(mesh_tp=2), dict(mesh_dp=4, engine="torch"),
                   dict(mesh_tp=2, mesh_dp=2, engine="mesh")):
        assert tcfg.pick_engine(tcfg.PirConfig(**kwargs)) == "mesh"
        jkw = dict(kwargs, engine="tpu") if kwargs.get("engine") == "torch" else kwargs
        assert jcfg.pick_engine(jcfg.PirConfig(**jkw)) == "mesh"
    # pir_tpu's native engines are ported: chosen by name, never by "auto"
    assert tcfg.pick_engine(tcfg.PirConfig(engine="native")) == "native"
    assert tcfg.pick_engine(tcfg.PirConfig(paillier_engine="native")) == "torch"
    assert tcfg.PirConfig(paillier_engine="native").validate().paillier_engine == "native"
    for kwargs, item in ((dict(paillier_engine="tpu"), "'torch'"),):
        with pytest.raises(ValueError, match=item.replace("[", r"\[").replace("]", r"\]")):
            tcfg.pick_engine(tcfg.PirConfig(**kwargs))
    for kwargs in (dict(engine="tpu"), dict(engine="bogus"), dict(paillier_engine="bogus"),
                   dict(mesh_compat_w=48), dict(mesh_tp=0)):
        with pytest.raises(ValueError):
            tcfg.PirConfig(**kwargs).validate()
    cfg = tcfg.PirConfig(engine="mesh", mesh_tp=2, mesh_dp=2, device="cpu",
                         paillier_engine="python")
    svcs = [tsvc.PirService(tables.db("torch", tables.data, tables.keywords),
                            config=cfg).start() for _ in range(3)]
    try:
        for s in svcs:
            assert s.engine_name == "mesh" and isinstance(s._engine, MeshPirServer)
            assert s._engine.mesh.shape == {"dp": 2, "tp": 2}
        client = tsvc.PirClient([s.address for s in svcs[:2]])
        client3 = tsvc.PirClient([s.address for s in svcs])
        rows = [0, HEIGHT - 1, 77, 512, 300]

        def check(got, want_rows):
            assert [bytes(r[0].data) for r in got] == [tables.data[i].tobytes()
                                                       for i in want_rows]

        check(client.query_index_batch(rows, fast=True), rows)
        check(client.query_index_batch(rows, fast=False), rows)
        check(client.query_keyword_dpf_batch([int(tables.keywords[i]) for i in rows]), rows)
        check(client3.query_index_batch(rows[:3], fast=False), rows[:3])
        stream = client.open_stream()
        assert stream.submit(rows[:2]) is None
        check(stream.submit(rows[2:4]), rows[:2])
        check(stream.flush(), rows[2:4])
        eng = svcs[0]._engine
        assert {key[0] for key in eng._tables} == {"words"}  # compat host prefix, points
        assert eng._kw_planes
        client.close()
        client3.close()
    finally:
        _close_all(svcs)


def test_stream_kernel_failure_reaches_the_client(services, tables, monkeypatch):
    """A fault in the stream's device path is an OP_ERROR on the client,
    never a silent emulation; the stream's refusal of a batch (ValueError)
    is what emulation is for."""
    srv = services["torch"]

    def broken(self, queries, shared_rk=None):
        raise RuntimeError("stacked_tail: CUDA error 700 at launch")

    monkeypatch.setattr(TorchPirServer, "_dispatch_fast_root", broken)
    c = tsvc.PirClient(srv.addresses("stream"))
    try:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            c.open_stream().submit([1, 2, 3])
    finally:
        c.close()
    monkeypatch.undo()

    def refuse(self, queries):
        raise ValueError("stream refuses the batch")

    monkeypatch.setattr(tsvc.TorchPirServer, "fast_serving_stream",
                        lambda self: type("Refusing", (), {"submit": refuse})())
    c = tsvc.PirClient(srv.addresses("stream"))
    try:
        stream = c.open_stream()
        assert stream.submit([1, 2]) is None
        assert [_row(r) for r in stream.flush()] == [tables.stream[i].tobytes() for i in (1, 2)]
    finally:
        c.close()


def test_concurrent_first_queries_on_one_service(tables):
    """Clients on threads reach a cold port service pair at once (fast
    batches, fast singles, compat singles): the first builds of the
    natural table and the permutations race, the answers may not."""
    db = tables.db("torch", tables.data)
    pair = [tsvc.PirService(db, config=CPU).start() for _ in range(2)]
    kinds = [(True, True), (True, True), (True, False), (True, False), (False, False),
             (False, False)]  # (fast, batch) of each client
    errors = []
    barrier = threading.Barrier(len(kinds))

    def run(seed):
        try:
            r = random.Random(seed)
            fast, batch = kinds[seed]
            c = tsvc.PirClient([s.address for s in pair])
            try:
                barrier.wait()
                idx = [r.randrange(HEIGHT) for _ in range(8 if batch else 2)]
                got = (c.query_index_batch(idx, fast=fast) if batch
                       else [c.query_index(i, fast=fast) for i in idx])
                for i, out in zip(idx, got):
                    assert _row(out) == tables.data[i].tobytes(), (seed, i)
            finally:
                c.close()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in range(len(kinds))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert pair[0].metrics.summary()["queries"] == 2 * 8 + 4 * 2
        assert {k[0] for k in pair[0]._engine._tables} >= {"words", "perm"}
    finally:
        _close_all(pair)


def test_launch_counts_survive_threads():
    """The kernel wrappers' launch counts, bumped by handler threads at
    once (on the card), lose no update: _build.count_launch locks."""
    from pir_tpu_torch import _build

    def wrapper():
        pass

    wrapper.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper)
                                                    for _ in range(20000)])
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert wrapper.launches == 16 * 20000


def test_server_metrics_survive_threads():
    """ServerMetrics, updated by a service's handler threads at once, loses
    no query, byte or latency: timed_query locks."""
    from pir_tpu_torch.utils.metrics import ServerMetrics

    m = ServerMetrics()

    def record():
        for _ in range(2000):
            with m.timed_query(3, n=2):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=record) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert (m.queries, m.bytes_scanned, len(m.latencies_s)) == (8 * 2000 * 2, 8 * 2000 * 3,
                                                                 10000)
    assert m.summary()["queries"] == 8 * 2000 * 2


# ---- the cPIR engine "torch" (the device Montgomery engine) ----

def test_torch_paillier_engine_serves_as_pir_tpu_tpu_engine():
    """A port service with PirConfig(paillier_engine="torch", device="cpu")
    and a pir_tpu service with paillier_engine="tpu" give byte-equal
    answers to the same encrypted, recursive, AHE ASPIR challenge and
    proof frames (test_mont_tpu.py's keygen(128) and 64 x 3 B table); a
    port client's encrypted round through the port service recovers its
    row."""
    rng = np.random.default_rng(41)
    data = rng.integers(0, 256, size=(64, 3), dtype=np.uint8)
    keys = rng.integers(0, 256, size=(64, KEY_BYTES), dtype=np.uint8)
    t = Tables.__new__(Tables)
    sk, pk = jp.keygen(128)
    svcs = {"jax": jsvc.PirService(t.db("jax", data), key_db=t.db("jax", keys),
                                   config=jcfg.PirConfig(paillier_engine="tpu")).start(),
            "torch": tsvc.PirService(t.db("torch", data), key_db=t.db("torch", keys),
                                     config=tcfg.PirConfig(paillier_engine="torch",
                                                           device="cpu")).start()}
    try:
        md = svcs["jax"].db.metadata()
        aq, ast = new_authenticated_query(md, sk, 1, 30, JSlot(keys[30].tobytes()))
        frames = [(jsvc.OP_ENCRYPTED_QUERY,
                   jw.serialize_encrypted_query(new_encrypted_query(md, pk, 1, 3))),
                  (jsvc.OP_ENCRYPTED_QUERY_REC, jw.serialize_doubly_encrypted_query(
                      new_doubly_encrypted_query(md, pk, 1, 29))),
                  (jsvc.OP_ASPIR_CHAL, struct.pack("<I", 8) + jw.serialize_auth_query(aq))]
        got = {pkg: _conversation(svc.address, frames) for pkg, svc in svcs.items()}
        assert got["torch"] == got["jax"]
        assert [op for op, _ in got["torch"]] == [op for op, _ in frames]
        chal_resp = got["jax"][-1][1]
        proof = auth_prove(ast, jw.deserialize_chal_token(chal_resp[8:]))
        proof_frame = (jsvc.OP_ASPIR_PROOF, chal_resp[:8] + jw.serialize_proof_token(proof))
        got = {pkg: _conversation(svc.address, [proof_frame])[0] for pkg, svc in svcs.items()}
        assert got["torch"] == got["jax"] and got["jax"][1][:1] == b"\x01"
        tsk = state.paillier_secret_key(sk.p, sk.q)
        client = tsvc.PirClient([svcs["torch"].address])
        try:
            got = client.query_encrypted(2, tsk, tsk.public_key)
            assert [bytes(s.data) for s in got] == [data[2 * len(got) + j].tobytes()
                                                    for j in range(len(got))]
        finally:
            client.close()
    finally:
        _close_all(list(svcs.values()))


def test_torch_paillier_engine_with_no_device_needs_the_card():
    """paillier_engine="torch" with no device runs on the card, and so does
    the default None: with no CUDA, a served cPIR query is refused with
    the reason."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; tests/test_torch_cuda.py serves there")
    db = state.database_from_numpy(np.zeros((64, 3), np.uint8), 3)
    sk, pk = tp.keygen(128)
    for paillier_engine in ("torch", None):
        svc = tsvc.PirService(db, config=tcfg.PirConfig(
            engine="host", paillier_engine=paillier_engine)).start()
        try:
            client = tsvc.PirClient([svc.address])
            with pytest.raises(RuntimeError, match="CUDA"):
                client.query_encrypted(1, sk, pk)
            client.close()
        finally:
            svc.close()
