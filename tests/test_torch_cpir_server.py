"""TorchPirServer's single-server cPIR path on the CPU: the async batch
entry ``private_encrypted_query_batch_async`` against the level-1
exponent matrix it keeps on its device.

* A batch of queries under two moduli gives the ciphertext ints of the
  port's CPython engine and of pir_tpu's, and each recovers its row
  (2^12 x 3 B, 256-bit keys: a 64 x 64 grid).
* At a 1024-bit key the batch gives pir_tpu's ciphertext ints.
* The cached matrix equals ``encrypted._level1_exponents`` and is built
  once (``pir.table``) over two batches, whose five batch spans are
  counted once a batch.
* Only the table's own square-root grid is cached, in one entry that a
  key of another chunk count replaces; another grid is built per call.
* ``apply_updates`` patches the matrix by a clone swapped in: the answers
  read the new rows, a query holding the old matrix keeps it.
* The batch path, the single query through a server and the single query
  with none raise the single query's errors, and a refused batch
  launches nothing.
* The service's OP_ENCRYPTED_QUERY with ``paillier_engine="torch"``
  answers through its server.

The other tables are 2^10 x 3 B with 128-bit keys (a 32 x 32 grid).
"""

import numpy as np
import pytest
import torch

import pir_tpu.database as jdbm
from pir_tpu import encrypted as je
from pir_tpu import wire as jw
from pir_tpu_torch import config as tcfg
from pir_tpu_torch import encrypted as te
from pir_tpu_torch import service as tsvc
from pir_tpu_torch import state
from pir_tpu_torch import wire as tw
from pir_tpu_torch.crypto import paillier
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.utils.metrics import reset_spans, span_totals
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLOT = 3
BATCH_SPANS = ("pir.dispatch", "pir.cpir.bases", "pir.cpir.scan", "pir.answers.copy",
               "pir.cpir.results")


@pytest.fixture(autouse=True)
def clean_totals():
    reset_spans()
    yield
    reset_spans()


def _data(rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(rows, SLOT), dtype=np.uint8)


@pytest.fixture(scope="module")
def small():
    """A 2^10 x 3 B database, its CPU server and two 128-bit keys."""
    data = _data(1 << 10, 3)
    db = state.database_from_numpy(data, SLOT)
    return data, db, TorchPirServer(db, device="cpu"), paillier.keygen(128), paillier.keygen(128)


def _ints(res):
    return [[(c.c, c.level) for c in s.cts] for s in res.slots]


def _counts():
    return {name: t["count"] for name, t in span_totals().items()}


def test_batch_equals_the_python_engines_under_two_moduli():
    data = _data(1 << 12, 1)
    db = state.database_from_numpy(data, SLOT)
    jdb = jdbm.generate_random_db(1 << 12, SLOT)
    jdb.data = data.copy()
    keys = [paillier.keygen(256), paillier.keygen(256)]
    asks = [(0, 5), (1, 40), (0, 63)]  # (key, grid row)
    qs = [te.new_encrypted_query(db.metadata(), keys[k][1], 1, row) for k, row in asks]
    res = TorchPirServer(db, device="cpu").private_encrypted_query_batch_async(qs)()
    width = qs[0].db_width
    assert (width, qs[0].db_height) == (64, 64)
    for (k, row), q, r in zip(asks, qs, res):
        assert _ints(r) == _ints(te.private_encrypted_query(db, q, engine="python"))
        jq = jw.deserialize_encrypted_query(tw.serialize_encrypted_query(q))
        assert _ints(r) == _ints(je.private_encrypted_query(jdb, jq, engine="python"))
        assert (r.slot_bytes, r.num_bytes_per_ciphertext) == (SLOT, SLOT)
        assert [bytes(s.data) for s in te.recover_encrypted(r, keys[k][0])] == [
            data[row * width + j].tobytes() for j in range(width)]


def test_batch_equals_pir_tpu_at_the_benchmark_key_size(small):
    """At a 1024-bit key (64 words a residue mod N^2, the words the card
    scans in the benchmark) through the wire round trip."""
    data, db, srv, _, _ = small
    jdb = jdbm.generate_random_db(1 << 10, SLOT)
    jdb.data = data.copy()
    sk, pk = paillier.keygen(1024)
    q = te.new_encrypted_query(db.metadata(), pk, 1, 21)
    res = srv.private_encrypted_query_batch_async([q])()[0]
    jq = jw.deserialize_encrypted_query(tw.serialize_encrypted_query(q))
    assert _ints(res) == _ints(je.private_encrypted_query(jdb, jq, engine="python"))
    assert bytes(te.recover_encrypted(res, sk)[30].data) == data[21 * 32 + 30].tobytes()


def test_cached_matrix_is_built_once_and_spans_count_a_batch(small):
    data, db, _, (sk, pk), _ = small
    srv = TorchPirServer(db, device="cpu")
    qs = [te.new_encrypted_query(db.metadata(), pk, 1, row) for row in (2, 30)]
    for _ in range(2):
        res = srv.private_encrypted_query_batch_async(qs)()
    key = ("cpir", 32, 32, 1)
    want, e_max, per = te._level1_exponents(db, 32, 32, 1)
    assert (e_max, per) == (24, 3)
    assert np.array_equal(srv._tables[key].numpy().view(np.uint32), want)
    counts = _counts()
    assert counts["pir.table"] == 1
    assert all(counts[name] == 2 for name in BATCH_SPANS), counts
    assert bytes(te.recover_encrypted(res[1], sk)[7].data) == data[30 * 32 + 7].tobytes()
    # the single query through the server rides the same cache
    one = te.private_encrypted_query(db, qs[0], engine="torch", server=srv)
    assert _ints(one) == _ints(res[0]) and _counts()["pir.table"] == 1
    other = state.database_from_numpy(data.copy(), SLOT)
    with pytest.raises(ValueError, match="another database"):
        te.private_encrypted_query(other, qs[0], engine="torch", server=srv)


def test_updates_patch_the_matrix_by_a_swapped_clone():
    data = _data(1 << 10, 4)
    db = state.database_from_numpy(data.copy(), SLOT)
    srv = TorchPirServer(db, device="cpu")
    sk, pk = paillier.keygen(128)
    q = te.new_encrypted_query(db.metadata(), pk, 1, 9)
    srv.private_encrypted_query_batch_async([q])()
    key = ("cpir", 32, 32, 1)
    old = srv._tables[key]
    before = old.clone()
    updates = {9 * 32 + 4: b"\x01\x02\x03", 9 * 32 + 31: b"\xff\x00\xff", 1000: b"abc"}
    srv.apply_updates(updates)
    assert srv._tables[key] is not old and torch.equal(old, before)
    assert np.array_equal(srv._tables[key].numpy().view(np.uint32),
                          te._level1_exponents(db, 32, 32, 1)[0])
    got = te.recover_encrypted(srv.private_encrypted_query_batch_async([q])()[0], sk)
    assert bytes(got[4].data) == b"\x01\x02\x03" and bytes(got[31].data) == b"\xff\x00\xff"
    assert bytes(got[5].data) == data[9 * 32 + 5].tobytes()
    assert _counts()["pir.table"] == 1


def test_only_the_own_grid_is_cached_in_one_entry(small):
    """A client's grid or key size must not grow the device cache: another
    width is built for its call alone, another num_cts replaces the entry."""
    data, db, _, (sk, pk), _ = small
    srv = TorchPirServer(db, device="cpu")
    own = te.new_encrypted_query(db.metadata(), pk, 1, 6)
    srv.private_encrypted_query_batch_async([own])()
    assert [k for k in srv._tables if k[0] == "cpir"] == [("cpir", 32, 32, 1)]
    for width in (16, 48):
        q = te.new_encrypted_query_with_dimensions(pk, width, 20, 1, 3)
        res = srv.private_encrypted_query_batch_async([q])()[0]
        assert _ints(res) == _ints(te.private_encrypted_query(db, q, engine="python"))
        assert bytes(te.recover_encrypted(res, sk)[2].data) == data[3 * width + 2].tobytes()
    assert [k for k in srv._tables if k[0] == "cpir"] == [("cpir", 32, 32, 1)]
    sk3, pk3 = paillier.keygen(24)  # one plaintext byte a chunk: 3 chunks a slot
    q = te.new_encrypted_query(db.metadata(), pk3, 1, 6)
    res = srv.private_encrypted_query_batch_async([q])()[0]
    assert _ints(res) == _ints(te.private_encrypted_query(db, q, engine="python"))
    assert bytes(te.recover_encrypted(res, sk3)[9].data) == data[6 * 32 + 9].tobytes()
    assert [k for k in srv._tables if k[0] == "cpir"] == [("cpir", 32, 32, 3)]
    assert _counts()["pir.table"] == 4


def _mutations(pk):
    """(name, mutate, message) of queries the single query refuses."""
    return [
        ("short ebits", lambda q: setattr(q, "ebits", q.ebits[:-1]), "height"),
        ("zero width", lambda q: setattr(q, "db_width", 0), "invalid query dimensions"),
        ("wide", lambda q: setattr(q, "db_width", 1 << 11), "exceed"),
        ("tall grid", lambda q: (setattr(q, "db_height", 64),
                                 setattr(q, "ebits", q.ebits * 2)), "exceed"),
        ("even modulus", lambda q: setattr(q, "pk", paillier.PublicKey(pk.n + 1)),
         "odd modulus"),
        ("tiny modulus", lambda q: setattr(q, "pk", paillier.PublicKey(35)), "too small"),
        ("huge modulus", lambda q: setattr(q, "pk", paillier.PublicKey((1 << 8200) + 1)),
         "serving bound"),
    ]


@pytest.mark.parametrize("case", range(7))
def test_batch_checks_raise_the_single_query_errors(small, case):
    _, db, srv, (_, pk), _ = small
    name, mutate, match = _mutations(pk)[case]
    good = te.new_encrypted_query(db.metadata(), pk, 1, 1)
    bad = te.new_encrypted_query(db.metadata(), pk, 1, 1)
    mutate(bad)
    with pytest.raises(ValueError, match=match):
        te.private_encrypted_query(db, bad, engine="torch", device="cpu")
    with pytest.raises(ValueError, match=match):
        te.private_encrypted_query(db, bad, engine="torch", server=srv)
    reset_spans()
    with pytest.raises(ValueError, match=match):
        srv.private_encrypted_query_batch_async([good, bad])
    assert "pir.cpir.scan" not in _counts(), name
    if name != "even modulus":  # the CPython engine takes an even N
        with pytest.raises(ValueError, match=match):
            te.private_encrypted_query(db, bad, engine="python")


def test_empty_batch_is_refused(small):
    with pytest.raises(ValueError, match="empty batch"):
        small[2].private_encrypted_query_batch_async([])


def test_service_answers_through_its_server(small):
    data, db, _, _, (sk, pk) = small
    svc = tsvc.PirService(db, config=tcfg.PirConfig(device="cpu",
                                                    paillier_engine="torch")).start()
    try:
        client = tsvc.PirClient([svc.address])
        slots = client.query_encrypted(17, sk, pk)
        assert [bytes(s.data) for s in slots] == [data[17 * 32 + j].tobytes()
                                                  for j in range(32)]
        assert ("cpir", 32, 32, 1) in svc._engine._tables
        assert _counts()["pir.dispatch"] == 1
    finally:
        svc.close()
