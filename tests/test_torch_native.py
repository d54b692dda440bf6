"""pir_tpu_torch.native (the C++/AES-NI host engine) and the port's
NativePirServer, native cPIR scan, native modexp route and native service
against pir_tpu's.

The port compiles its own copies of pir_tpu's C++ sources
(``pir_tpu_torch/native/*.cpp``) into ``pir_tpu_torch/_build/``. The same
shares (pir_tpu's keygen, carried across with pir_tpu_torch.state) and
the same ints go through both packages: equal bits, equal answer bytes,
equal ciphertext ints, and equal response frames from the two packages'
native services. pir_tpu's tests/test_native.py cases come first, each
also held against pir_tpu's NativePirServer.
"""

import random
import socket
import struct
import threading
from pathlib import Path

import numpy as np
import pytest
from test_torch_multiparty import port_share as port_share_of
from test_torch_single import to_port

import pir_tpu.config as jcfg
import pir_tpu.encrypted as je
import pir_tpu.service as jsvc
from pir_tpu import native as jnat
from pir_tpu import query as jq
from pir_tpu import wire as jw
from pir_tpu.aspir import auth_prove, new_authenticated_query
from pir_tpu.crypto import paillier as jp
from pir_tpu.database import generate_random_db
from pir_tpu.dpf import host as jdpf
from pir_tpu.server import NativePirServer as JNativePirServer
from pir_tpu.slot import Slot as JSlot
from pir_tpu_torch import _build, native
from pir_tpu_torch import config as tcfg
from pir_tpu_torch import encrypted as te
from pir_tpu_torch import server as tsrv
from pir_tpu_torch import service as tsvc
from pir_tpu_torch import state
from pir_tpu_torch import wire as tw
from pir_tpu_torch.crypto import mont
from pir_tpu_torch.crypto import paillier as tp
from pir_tpu_torch.server import NativePirServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def port_share(s):
    """A pir_tpu share of any kind -> the port's."""
    return to_port([s])[0] if s.key_fast is not None else port_share_of(s)


def port_db(db):
    return state.database_from_numpy(db.data, db.slot_bytes, keywords=db.keywords)


def _bytes(res):
    return [bytes(s.data) for s in res.shares]


# ---- pir_tpu's tests/test_native.py, held against pir_tpu's engine too ----------

def test_native_expand_matches_host():
    rng = random.Random(0)
    for height in (64, 1000, 1 << 12):
        db = generate_random_db(height, 5)
        tdb = port_db(db)
        shares = jq.new_index_query_shares(db.metadata(), rng.randrange(height), 1, 2)
        for s in shares:
            ps = port_share(s)
            got = NativePirServer(tdb).expand_shared_query(ps)
            assert got.dtype == np.uint8
            assert (got == JNativePirServer(db).expand_shared_query(s)).all(), height
            assert (got.astype(bool) == tsrv.expand_shared_query(tdb, ps)).all(), height


def test_native_full_query_roundtrip():
    rng = random.Random(1)
    db = generate_random_db(1 << 10, 24)
    server, jserver = NativePirServer(port_db(db)), JNativePirServer(db)
    for group_size in (1, 4):
        idx = rng.randrange(db.db_size // group_size)
        shares = jq.new_index_query_shares(db.metadata(), idx, group_size, 2)
        answers = [_bytes(server.private_secret_shared_query(port_share(s))) for s in shares]
        assert answers == [_bytes(jserver.private_secret_shared_query(s)) for s in shares]
        for j in range(group_size):
            rec = np.frombuffer(answers[0][j], np.uint8) ^ np.frombuffer(answers[1][j], np.uint8)
            assert rec.tobytes() == db.data[idx * group_size + j].tobytes()


def test_native_keyword_mode():
    rng = random.Random(2)
    db = generate_random_db(512, 6)
    db.set_keywords(np.array(rng.sample(range(1 << 32), 512), dtype=np.uint64))
    server, jserver = NativePirServer(port_db(db)), JNativePirServer(db)
    row = rng.randrange(512)
    shares = jq.new_keyword_query_shares(db.metadata(), int(db.keywords[row]), 1, 2)
    answers = [_bytes(server.private_secret_shared_query(port_share(s))) for s in shares]
    assert answers == [_bytes(jserver.private_secret_shared_query(s)) for s in shares]
    assert answers == [_bytes(tsrv.private_secret_shared_query(server.db, port_share(s)))
                       for s in shares]
    rec = np.frombuffer(answers[0][0], np.uint8) ^ np.frombuffer(answers[1][0], np.uint8)
    assert rec.tobytes() == db.data[row].tobytes()


def test_native_fast_expand_matches_host():
    rng = random.Random(3)
    for height in (200, 1 << 12, 5000):
        target = rng.randrange(height)
        client = jdpf.client_initialize(jdpf.fast_depth_for_height(height))
        keys = jdpf.generate_two_server_fast(client, target, height)
        server = jdpf.server_initialize(client.prf_keys, client.num_bits)
        db = generate_random_db(height, 4)
        nat, jnat_srv = NativePirServer(port_db(db)), JNativePirServer(db)
        for snum in (0, 1):
            want = jdpf.eval_full_domain_fast_bits(server, keys[snum])
            share = jq.new_index_query_shares(db.metadata(), 0, 1, 2, fast=True)[0]
            share.key_fast = keys[snum]
            share.prf_keys = client.prf_keys
            got = nat.expand_shared_query(port_share(share))
            assert (got.astype(bool) == want).all(), (height, snum)
            assert (got == jnat_srv.expand_shared_query(share)).all(), (height, snum)


def test_native_scan_xor_batch_matches_single():
    rng = np.random.default_rng(3)
    for h, row_bytes, nq in ((257, 24, 5), (1 << 12, 96, 17), (500, 7, 3)):
        rows = rng.integers(0, 256, size=(h, row_bytes), dtype=np.uint8)
        bits = rng.integers(0, 2, size=(nq, h), dtype=np.uint8)
        batch = native.scan_xor_batch(rows, bits)
        assert (batch == jnat.scan_xor_batch(rows, bits)).all()
        for i in range(nq):
            single = native.scan_xor(rows, bits[i])
            assert (batch[i] == single).all(), (h, row_bytes, i)
            assert (single == np.bitwise_xor.reduce(rows[bits[i] == 1], axis=0)).all()


def test_native_batch_query_roundtrip():
    rng = random.Random(5)
    db = generate_random_db(1 << 10, 16)
    server, jserver = NativePirServer(port_db(db)), JNativePirServer(db)
    idxs = [rng.randrange(db.db_size) for _ in range(9)]
    share_lists = [jq.new_index_query_shares(db.metadata(), i, 1, 2, fast=(i % 2 == 0))
                   for i in idxs]
    per_server = [[sl[k] for sl in share_lists] for k in range(2)]
    answers = [[_bytes(r) for r in server.private_secret_shared_query_batch(
        [port_share(s) for s in p])] for p in per_server]
    assert answers == [[_bytes(r) for r in jserver.private_secret_shared_query_batch(p)]
                       for p in per_server]
    for i, idx in enumerate(idxs):
        rec = np.frombuffer(answers[0][i][0], np.uint8) ^ np.frombuffer(answers[1][i][0],
                                                                          np.uint8)
        assert rec.tobytes() == db.data[idx].tobytes(), idx


# ---- beyond pir_tpu's cases ---------------------------------------------------------

def test_native_multiparty_and_refused_shares():
    """A 3-party index share answers on the host golden's expansion, as
    pir_tpu's NativePirServer does; a fast key of the wrong geometry is
    refused before the C++ walk, and so are keys too short for it."""
    db = generate_random_db(1 << 9, 8)
    server, jserver = NativePirServer(port_db(db)), JNativePirServer(db)
    shares = jq.new_index_query_shares(db.metadata(), 77, 1, 3)
    answers = [_bytes(server.private_secret_shared_query(port_share(s))) for s in shares]
    assert answers == [_bytes(jserver.private_secret_shared_query(s)) for s in shares]
    rec = np.bitwise_xor.reduce([np.frombuffer(a[0], np.uint8) for a in answers])
    assert rec.tobytes() == db.data[77].tobytes()
    other = generate_random_db(1 << 12, 8)
    bad = jq.new_index_query_shares(other.metadata(), 5, 1, 2, fast=True)[0]
    with pytest.raises(ValueError, match="geometry"):
        server.private_secret_shared_query(port_share(bad))
    # the loader checks what the C walk reads before it passes pointers
    compat = port_share(jq.new_index_query_shares(db.metadata(), 5, 1, 2)[0])
    nb = len(compat.key_two_party.cw)
    with pytest.raises(ValueError, match="domain"):
        native.expand_bits(compat, nb, (1 << nb) + 1)
    compat.key_two_party.cw = compat.key_two_party.cw[:-1]
    with pytest.raises(ValueError, match="geometry"):
        native.expand_bits(compat, nb, 1 << 9)
    fast = port_share(jq.new_index_query_shares(db.metadata(), 5, 1, 2, fast=True)[0])
    fast.key_fast.final_cw_block = fast.key_fast.final_cw_block[:15]
    with pytest.raises(ValueError, match="geometry"):
        native.expand_fast_bits(fast)


def test_powmod_and_scan_equal_pir_tpu_and_cpython():
    """native.powmod, powmod_batch (a base a row and one common base) and
    paillier_scan give pir_tpu.native's ints and CPython pow's."""
    rng = random.Random(9)
    for bits in (256, 1031):
        m = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        bases = [rng.getrandbits(bits + 8) for _ in range(13)]
        exps = [rng.getrandbits(rng.choice((1, 64, 300, 2 * bits))) for _ in range(13)]
        exps[3] = 0
        assert native.powmod(bases[0], exps[1], m) == jnat.powmod(bases[0], exps[1], m) == pow(
            bases[0], exps[1], m)
        want = [pow(b, e, m) for b, e in zip(bases, exps)]
        assert native.powmod_batch(bases, exps, m) == want == jnat.powmod_batch(bases, exps, m)
        want = [pow(bases[0], e, m) for e in exps]
        assert native.powmod_batch(bases[0], exps, m, common_base=True, nthreads=3) == want
        assert jnat.powmod_batch(bases[0], exps, m, common_base=True) == want
        h, w = 7, 3
        vals = [rng.getrandbits(40) if rng.random() < 0.8 else 0 for _ in range(h * w)]
        want = [1] * w
        for r in range(h):
            for j in range(w):
                want[j] = want[j] * pow(bases[r], vals[r * w + j], m) % m
        assert native.paillier_scan(bases[:h], vals, w, m, nthreads=2) == want
        assert jnat.paillier_scan(bases[:h], vals, w, m) == want
    with pytest.raises(ValueError, match="odd"):
        native.powmod(3, 5, 1 << 256)


def test_native_modexp_route():
    """paillier's _powmod and _powmod_batch on the native route (scoped to
    the calling thread) give CPython's ints, take the C++ engine only where
    named and where the modulus qualifies, and leave batches the device
    route takes to it."""
    rng = random.Random(4)
    m = rng.getrandbits(512) | (1 << 511) | 1
    bases = [rng.getrandbits(520) for _ in range(20)]
    exps = [rng.getrandbits(512) for _ in range(20)]
    want = [pow(b, e, m) for b, e in zip(bases, exps)]
    calls = []
    real = native.powmod_batch

    def spy(*a, **k):
        calls.append(len(a[1]))
        return real(*a, **k)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(native, "powmod_batch", spy)
        assert tp._powmod_batch(bases, exps, m) == want and calls == []
        with tp.native_modexp():
            assert tp._powmod_batch(bases, exps, m) == want and calls == [20]
            assert tp._powmod(bases[1], exps[1], m) == want[1]
            assert tp._powmod_batch(bases[0], exps[:4], m, common_base=True) == [
                pow(bases[0], e, m) for e in exps[:4]]
            small = (1 << 127) | 1  # under 256 bits: CPython
            assert tp._powmod_batch(bases[:3], exps[:3], small) == [
                pow(b, e, small) for b, e in zip(bases[:3], exps[:3])]
            assert calls == [20, 4]
            # the device route keeps precedence over the batches it takes
            mp.setattr(mont, "device_powmod_batch",
                       lambda bs, es, mod, e_max, device: [pow(b, e, mod) for b, e in zip(bs, es)])
            with tp.device_modexp(True, "cpu"):
                assert tp._powmod_batch(bases, exps, m) == want and calls == [20, 4]
                assert tp._powmod_batch(bases[:5], exps[:5], m) == want[:5]
                assert calls == [20, 4, 5]
            with tp.native_modexp(False):  # off again inside, and on after
                assert tp._powmod_batch(bases[:2], exps[:2], m) == want[:2]
                assert calls == [20, 4, 5]
            assert tp._powmod_batch(bases[:2], exps[:2], m) == want[:2]
            assert calls == [20, 4, 5, 2]
        # another thread keeps its own route (off)
        other = []
        with tp.native_modexp():
            th = threading.Thread(target=lambda: other.append(
                tp._powmod_batch(bases[:3], exps[:3], m)))
            th.start()
            th.join(timeout=60)
        assert not th.is_alive() and other == [want[:3]] and len(calls) == 4
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def cpir():
    """keygen(128) and the 2^10 x 3 B table of tests/test_encrypted.py."""
    sk, pk = jp.keygen(128)
    db = generate_random_db(1 << 10, 3)
    return sk, pk, db, port_db(db)


def test_native_scan_engine_equals_pir_tpu_and_python(cpir):
    """scan_engine("native"): an encrypted and a recursive query give
    pir_tpu's native engine's ints and the CPython loop's, with nprocs
    threads."""
    sk, pk, db, tdb = cpir
    md = db.metadata()
    q = je.new_encrypted_query(md, pk, 2, 77)
    tq = tw.deserialize_encrypted_query(jw.serialize_encrypted_query(q))
    want = je.private_encrypted_query(db, q, engine="native")
    for engine, nprocs in (("native", 3), ("native", None), ("python", None)):
        got = te.private_encrypted_query(tdb, tq, nprocs=nprocs, engine=engine)
        assert [[c.c for c in s.cts] for s in got.slots] == [[c.c for c in s.cts]
                                                            for s in want.slots]
    dq = je.new_doubly_encrypted_query(md, pk, 1, 500)
    tdq = tw.deserialize_doubly_encrypted_query(jw.serialize_doubly_encrypted_query(dq))
    want = je.private_doubly_encrypted_query(db, dq, engine="native")
    for engine in ("native", "python"):
        got = te.private_doubly_encrypted_query(tdb, tdq, engine=engine)
        assert [[c.c for c in s.cts] for s in got.slots] == [[c.c for c in s.cts]
                                                            for s in want.slots]
    tsk = state.paillier_secret_key(sk.p, sk.q)
    got = te.recover_doubly_encrypted(
        te.private_doubly_encrypted_query(tdb, tdq, engine="native"), tsk)
    assert bytes(got[0].data) == db.data[500].tobytes()


def _conversation(address, frames):
    with socket.create_connection(address) as s:
        out = []
        for op, payload in frames:
            jsvc._send_frame(s, op, payload)
            out.append(jsvc._recv_frame(s))
        return out


def test_native_service_equals_pir_tpu_native_service():
    """A port PirService with PirConfig(engine="native",
    paillier_engine="native") and a pir_tpu service with the same engines
    give equal response frames to the same frames: index singles (fast,
    compat, keyword, 3-party), batches (fast, compat, keyword), a stream,
    cPIR (plain and recursive) and an AHE ASPIR challenge and proof; a
    port client recovers a fast batch through the port services."""
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, size=(1 << 10, 16), dtype=np.uint8)
    keys = rng.integers(0, 256, size=(1 << 10, 8), dtype=np.uint8)
    keywords = rng.choice(1 << 32, size=1 << 10, replace=False).astype(np.uint64)
    jdb, jkeys = generate_random_db(1 << 10, 16), generate_random_db(1 << 10, 8)
    jdb.data, jkeys.data = data.copy(), keys.copy()
    jdb.set_keywords(keywords)
    tdb = state.database_from_numpy(data, 16, keywords=keywords)
    tkeys = state.database_from_numpy(keys, 8)
    svcs = {"jax": [jsvc.PirService(jdb, key_db=jkeys, config=jcfg.PirConfig(
                engine="native", paillier_engine="native")).start() for _ in range(2)],
            "torch": [tsvc.PirService(tdb, key_db=tkeys, config=tcfg.PirConfig(
                engine="native", paillier_engine="native")).start() for _ in range(2)]}
    try:
        assert all(s.engine_name == "native" and isinstance(s._engine, NativePirServer)
                   for s in svcs["torch"])
        md = jdb.metadata()
        rnd = random.Random(8)
        S = jw.serialize_query_share
        blobs = jsvc._pack_blobs
        fast = jq.new_index_query_shares_batch(md, [rnd.randrange(1024) for _ in range(9)], 1, 2,
                                               fast=True)
        compat = jq.new_index_query_shares_batch(md, [rnd.randrange(1024) for _ in range(3)], 1,
                                                 2)
        kw = jq.new_keyword_query_shares_batch(md, [int(keywords[i]) for i in (4, 900)], 1)
        mp3 = jq.new_index_query_shares(md, 17, 1, 3)
        sk, pk = jp.keygen(128)
        aq, ast = new_authenticated_query(md, sk, 1, 30, JSlot(keys[30].tobytes()))
        frames = [(jsvc.OP_QUERY, S(fast[0][0])), (jsvc.OP_QUERY, S(compat[0][1])),
                  (jsvc.OP_QUERY, S(kw[1][0])), (jsvc.OP_QUERY, S(mp3[2])),
                  (jsvc.OP_QUERY_BATCH, blobs([S(p[0]) for p in fast])),
                  (jsvc.OP_QUERY_BATCH, blobs([S(p[1]) for p in compat])),
                  (jsvc.OP_QUERY_BATCH, blobs([S(p[0]) for p in kw])),
                  (jsvc.OP_STREAM_SUBMIT, blobs([S(p[1]) for p in fast[:4]])),
                  (jsvc.OP_STREAM_FLUSH, b""),
                  (jsvc.OP_ENCRYPTED_QUERY,
                   jw.serialize_encrypted_query(je.new_encrypted_query(md, pk, 2, 5))),
                  (jsvc.OP_ENCRYPTED_QUERY_REC, jw.serialize_doubly_encrypted_query(
                      je.new_doubly_encrypted_query(md, pk, 1, 1000))),
                  (jsvc.OP_ASPIR_CHAL, struct.pack("<I", 8) + jw.serialize_auth_query(aq))]
        got = {pkg: _conversation(s[0].address, frames) for pkg, s in svcs.items()}
        assert [op for op, _ in got["torch"]] == [op for op, _ in frames]
        assert got["torch"] == got["jax"]
        chal = got["jax"][-1][1]
        proof = (jsvc.OP_ASPIR_PROOF, chal[:8] + jw.serialize_proof_token(
            auth_prove(ast, jw.deserialize_chal_token(chal[8:]))))
        got = {pkg: _conversation(s[0].address, [proof])[0] for pkg, s in svcs.items()}
        assert got["torch"] == got["jax"] and got["jax"][1][:1] == b"\x01"
        client = tsvc.PirClient([s.address for s in svcs["torch"]])
        try:
            res = client.query_index_batch([3, 1023, 512])
            assert [bytes(r[0].data) for r in res] == [data[i].tobytes() for i in (3, 1023, 512)]
        finally:
            client.close()
        # updates follow the host rule: the rows swap copy-on-write
        svcs["torch"][0].apply_updates({7: bytes(range(16))})
        assert tdb.data[7].tobytes() == bytes(range(16))
    finally:
        for s in svcs["jax"] + svcs["torch"]:
            s.close()


def test_auto_stays_torch_where_native_builds():
    """pir_tpu's "auto" falls back to its native engine on a host with no
    accelerator; the port's stays "torch" even where the library builds."""
    assert native.available() and native.bigmod_available()
    assert tcfg.pick_engine(tcfg.PirConfig()) == "torch"
    assert tcfg.pick_engine(tcfg.PirConfig(engine="auto")) == "torch"
    assert tcfg.pick_engine(tcfg.PirConfig(engine="native")) == "native"
    assert te.scan_engine(None) == "torch"
    with pytest.raises(ValueError):
        tcfg.PirConfig(engine="tpu").validate()
    with pytest.raises(ValueError):
        tcfg.PirConfig(paillier_engine="tpu").validate()


# ---- the build --------------------------------------------------------------------

def test_native_sources_lie_in_the_port(tmp_path, monkeypatch):
    """Every source the loader compiles lies under pir_tpu_torch/native/,
    every library goes to the build directory (here a fresh one), and
    nothing is written beside the sources."""
    before = sorted(p.name for p in (ROOT / "pir_tpu_torch" / "native").iterdir())
    commands = []
    real_run = _build.subprocess.run

    def run(cmd, *a, **k):
        commands.append(cmd)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.subprocess, "run", run)
    for name in _build.HOST_SOURCES:
        assert _build.build_host(name) is not None
        assert _build.host_lib_path(name).exists()
        assert _build.build_host(name) == ""  # built: nothing to do
    assert len(commands) == len(_build.HOST_SOURCES)
    for cmd in commands:
        srcs = [Path(a) for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
        assert srcs and all(s.resolve().is_relative_to(ROOT / "pir_tpu_torch" / "native")
                            for s in srcs)
        assert Path(cmd[cmd.index("-o") + 1]).parent == tmp_path / "build"
    assert sorted(p.name for p in (ROOT / "pir_tpu_torch" / "native").iterdir()) == before
    assert _build.BUILD_DIR.resolve() != (ROOT / "pir_tpu_torch" / "native")


def test_native_build_is_safe_in_parallel_and_fails_loudly(tmp_path, monkeypatch):
    """Four threads building one library into a fresh directory all load a
    whole library; a source that does not compile raises with the
    compiler's log, and no library is left."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    errors = []

    def build():
        try:
            _build.build_host("bigmod")
        except Exception as e:  # noqa: BLE001 (collected for the assert)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        _build.host_lib_path("bigmod").name]
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "bad", (bad, ("-shared", "-fPIC")))
    with pytest.raises(RuntimeError, match="native build of bad failed") as err:
        _build.build_host("bad")
    assert "error" in str(err.value)
    assert not _build.host_lib_path("bad").exists()
