"""pir_tpu_torch.encrypted (single-server cPIR under Paillier) against
pir_tpu.encrypted.

The same query (made by one package, carried across as wire bytes) on
the same database gives equal ciphertext ints in both packages: the
plain scan, the recursive scan, and the column pass over an encrypted
row result; each package recovers the other's answers. The port's
geometry checks raise as pir_tpu's do, and pir_tpu's "tpu" scan engine
is refused by name (its native engine is ported:
tests/test_torch_native.py). The port's engine "torch" (its device
Montgomery engine, here its plain version with device="cpu") gives the
ciphertexts of pir_tpu's engine "tpu" and of the CPython loop. 128-bit
keys and the 2^10 x 3 B table of tests/test_encrypted.py.
"""

import random

import numpy as np
import pytest

import pir_tpu.database as jdbm
import pir_tpu_torch.database as tdbm
from pir_tpu import encrypted as je
from pir_tpu import keyword as jkw
from pir_tpu import wire as jw
from pir_tpu.crypto import paillier as jp
from pir_tpu.database import generate_random_db as j_random_db
from pir_tpu.slot import Slot as JSlot
from pir_tpu_torch import encrypted as te
from pir_tpu_torch import keyword as tkw
from pir_tpu_torch import state
from pir_tpu_torch import wire as tw
from pir_tpu_torch.slot import Slot as TSlot

from torch_threads import one_torch_thread  # noqa: F401

DB_SIZE, SLOT = 1 << 10, 3


@pytest.fixture(scope="module")
def ctx():
    sk_j, _ = jp.keygen(128)
    sk_t = state.paillier_secret_key(sk_j.p, sk_j.q)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(DB_SIZE, SLOT), dtype=np.uint8)
    jdb = j_random_db(DB_SIZE, SLOT)
    jdb.data = data.copy()
    return sk_j, sk_t, jdb, state.database_from_numpy(data, SLOT)


def _ints(res):
    return [[(c.c, c.level) for c in s.cts] for s in res.slots]


def _to_port_query(q):
    return tw.deserialize_encrypted_query(jw.serialize_encrypted_query(q))


def _to_port_dquery(q):
    return tw.deserialize_doubly_encrypted_query(jw.serialize_doubly_encrypted_query(q))


@pytest.mark.parametrize("group_size", [1, 3])
def test_plain_scan_equal_ciphertexts(ctx, group_size):
    sk_j, sk_t, jdb, tdb = ctx
    pk = sk_j.public_key
    rnd = random.Random(group_size)
    for index in (rnd.randrange(8), -1):
        q = je.new_encrypted_query(jdb.metadata(), pk, group_size, index)
        rj = je.private_encrypted_query(jdb, q)
        rt = te.private_encrypted_query(tdb, _to_port_query(q), engine="python")
        assert _ints(rt) == _ints(rj)
        assert (rt.slot_bytes, rt.num_bytes_per_ciphertext) == (rj.slot_bytes,
                                                                rj.num_bytes_per_ciphertext)
        got = [bytes(s.data) for s in te.recover_encrypted(rt, sk_t)]
        assert got == [bytes(s.data) for s in je.recover_encrypted(rj, sk_j)]
        width = q.db_width
        for j, b in enumerate(got):
            want = (bytes(SLOT) if index < 0 or index * width + j >= DB_SIZE
                    else jdb.data[index * width + j].tobytes())
            assert b == want


@pytest.mark.parametrize("group_size", [1, 2])
def test_recursive_scan_equal_ciphertexts(ctx, group_size):
    sk_j, sk_t, jdb, tdb = ctx
    pk = sk_j.public_key
    for index in (random.Random(group_size).randrange(DB_SIZE // group_size), -1):
        q = je.new_doubly_encrypted_query(jdb.metadata(), pk, group_size, index)
        rj = je.private_doubly_encrypted_query(jdb, q)
        rt = te.private_doubly_encrypted_query(tdb, _to_port_dquery(q), engine="python")
        assert _ints(rt) == _ints(rj)
        got = [bytes(s.data) for s in te.recover_doubly_encrypted(rt, sk_t)]
        assert got == [bytes(s.data) for s in je.recover_doubly_encrypted(rj, sk_j)]
        if index < 0:
            assert got == [bytes(SLOT)] * group_size


def test_column_pass_over_an_encrypted_result_equal(ctx):
    """The column pass over a row result that came from the other
    package (the ASPIR challenge's second pass)."""
    sk_j, _, jdb, tdb = ctx
    pk = sk_j.public_key
    q = je.new_doubly_encrypted_query(jdb.metadata(), pk, 2, 77)
    row_j = je.private_encrypted_query(jdb, q.row)
    row_t = tw.deserialize_encrypted_result(jw.serialize_encrypted_result(row_j),
                                            state.paillier_public_key(pk.n))
    tq = _to_port_dquery(q)
    rt = te.private_encrypted_query_over_encrypted_result(tdb, tq.col, row_t, engine="python")
    rj = je.private_encrypted_query_over_encrypted_result(jdb, q.col, row_j)
    assert _ints(rt) == _ints(rj)


def test_port_queries_answer_in_pir_tpu(ctx):
    """A port-made query answered by pir_tpu recovers in the port."""
    _, sk_t, jdb, tdb = ctx
    pk = sk_t.public_key
    q = te.new_doubly_encrypted_query(tdb.metadata(), pk, 1, 500)
    jq = jw.deserialize_doubly_encrypted_query(tw.serialize_doubly_encrypted_query(q))
    rj = je.private_doubly_encrypted_query(jdb, jq)
    rt = tw.deserialize_doubly_encrypted_result(jw.serialize_doubly_encrypted_result(rj), pk)
    assert bytes(te.recover_doubly_encrypted(rt, sk_t)[0].data) == jdb.data[500].tobytes()


def test_int_array_packing_equal():
    rnd = random.Random(5)
    for n in (1, 3, 14, 33):
        for chunks in (1, 2, 3, 5):
            raw = bytes(rnd.randrange(256) for _ in range(n))
            raw = b"\x00" + raw[1:] if rnd.random() < 0.5 else raw  # leading zeros
            ti, tper = TSlot(raw).to_int_array(chunks)
            assert (ti, tper) == JSlot(raw).to_int_array(chunks)
            assert bytes(TSlot.from_int_array(ti, n, tper).data) == bytes(
                JSlot.from_int_array(ti, n, tper).data)
    with pytest.raises(ValueError):
        TSlot(b"abc").to_int_array(0)


def test_geometry_checks_raise_as_pir_tpu(ctx):
    sk_j, _, jdb, tdb = ctx
    pk = sk_j.public_key

    def both(mutate, match):
        q = je.new_doubly_encrypted_query(jdb.metadata(), pk, 1, 0)
        tq = _to_port_dquery(q)
        mutate(q)
        mutate(tq)
        with pytest.raises(ValueError, match=match):
            je.private_doubly_encrypted_query(jdb, q)
        with pytest.raises(ValueError, match=match):
            te.private_doubly_encrypted_query(tdb, tq, engine="python")

    both(lambda q: setattr(q.row, "group_size", 0), "group size")
    both(lambda q: setattr(q.col, "ebits", q.col.ebits[:-1]), "geometry")
    both(lambda q: setattr(q.col, "ebits", q.col.ebits + q.col.ebits[:1]), "geometry")
    both(lambda q: setattr(q.row, "ebits", q.row.ebits[:-1]), "height")
    both(lambda q: setattr(q.row, "db_width", DB_SIZE + 1), "exceed")


@pytest.mark.parametrize("engine,item", [("tpu", "'torch'")])
def test_unported_scan_engines_raise(ctx, engine, item):
    sk_j, _, jdb, tdb = ctx
    q = _to_port_query(je.new_encrypted_query(jdb.metadata(), sk_j.public_key, 1, 2))
    with pytest.raises(ValueError, match=item.replace("[", r"\[").replace("]", r"\]")):
        te.private_encrypted_query(tdb, q, engine=engine)
    dq = _to_port_dquery(je.new_doubly_encrypted_query(jdb.metadata(), sk_j.public_key, 1, 2))
    with pytest.raises(ValueError, match="not ported"):
        te.private_doubly_encrypted_query(tdb, dq, engine=engine)
    with pytest.raises(ValueError, match="unknown"):
        te.scan_engine("gpu")
    assert [te.scan_engine(e) for e in (None, "python", "torch", "native")] == [
        "torch", "python", "torch", "native"]


@pytest.mark.parametrize("group_size", [1, 3])
def test_torch_engine_equals_pir_tpu_tpu_engine(ctx, group_size):
    """Level-1 scans: engine "torch" on the CPU, pir_tpu's engine "tpu" on
    JAX's CPU backend and the CPython loop give equal ciphertexts; a
    ragged last grid row keeps exponent 0 (the identity)."""
    sk_j, sk_t, jdb, tdb = ctx
    q = je.new_encrypted_query(jdb.metadata(), sk_j.public_key, group_size, 5)
    rj = je.private_encrypted_query(jdb, q, engine="tpu")
    rt = te.private_encrypted_query(tdb, _to_port_query(q), engine="torch", device="cpu")
    assert _ints(rt) == _ints(rj) == _ints(te.private_encrypted_query(tdb, _to_port_query(q),
                                                                      engine="python"))
    assert (rt.slot_bytes, rt.num_bytes_per_ciphertext) == (rj.slot_bytes,
                                                            rj.num_bytes_per_ciphertext)
    got = [bytes(s.data) for s in te.recover_encrypted(rt, sk_t)]
    width = q.db_width
    assert got == [jdb.data[5 * width + j].tobytes() if 5 * width + j < DB_SIZE else bytes(SLOT)
                   for j in range(width)]


@pytest.mark.parametrize("group_size", [1, 2])
def test_torch_engine_recursive_equals_pir_tpu_tpu_engine(ctx, group_size):
    """Level-2 column blocks (exponents of bits(N^2), 4-bit windows): the
    recursive scan; the column pass refuses a ciphertext outside N^2."""
    sk_j, sk_t, jdb, tdb = ctx
    index = 37 * group_size
    q = je.new_doubly_encrypted_query(jdb.metadata(), sk_j.public_key, group_size, index)
    rj = je.private_doubly_encrypted_query(jdb, q, engine="tpu")
    rt = te.private_doubly_encrypted_query(tdb, _to_port_dquery(q), engine="torch", device="cpu")
    assert _ints(rt) == _ints(rj)
    got = [bytes(s.data) for s in te.recover_doubly_encrypted(rt, sk_t)]
    assert jdb.data[index].tobytes() in got
    row_t = te.private_encrypted_query(tdb, _to_port_dquery(q).row, engine="python")
    bad = te.EncryptedQueryResult([te.EncryptedSlot([te.Ciphertext(-1, 1)])] * len(row_t.slots),
                                  row_t.pk, SLOT, 3)
    with pytest.raises(ValueError, match="N\\^2"):
        te.private_encrypted_query_over_encrypted_result(
            tdb, _to_port_dquery(q).col, bad, engine="torch", device="cpu")


def test_level1_exponent_matrix_equals_the_slot_packing():
    """The vectorised exponent matrix from the database's bytes equals the
    per-slot to_int_array packing (pir_tpu/encrypted.py:234-262), for
    chunks of several words, a short last chunk and slots past the table."""
    rng = np.random.default_rng(5)
    for size, slot, num_cts, width, height in ((30, 17, 2, 4, 8), (10, 3, 1, 3, 4),
                                               (6, 9, 4, 6, 1), (5, 40, 1, 2, 3)):
        db = state.database_from_numpy(rng.integers(0, 256, size=(size, slot), dtype=np.uint8),
                                       slot)
        emat, e_max, per = te._level1_exponents(db, width, height, num_cts)
        assert per == max(1, -(-slot // num_cts)) and e_max == 8 * -(-slot // num_cts)
        for r in range(height):
            for c in range(width):
                idx = r * width + c
                want = db.slot(idx).to_int_array(num_cts)[0] if idx < size else [0] * num_cts
                got = [int.from_bytes(emat[r, c * num_cts + j].tobytes(), "little")
                       for j in range(num_cts)]
                assert got == want


def test_sqrt_tree_encrypted_query_equal(ctx):
    """PrivateSqrtST.private_encrypted_query (keyword.go:84-90) answers a
    query over the second layer with pir_tpu's ciphertexts."""
    sk_j = ctx[0]
    data = sorted((f"k{i:03d}" for i in range(64)), reverse=True)
    jst, tst = jkw.new_private_sqrt_st(), tkw.new_private_sqrt_st(device="cpu")
    jst.build_for_data(data)
    tst.build_for_data(data)
    q = je.new_encrypted_query(jst.get_second_layer_metadata(), sk_j.public_key, jst.height, 3)
    assert _ints(tst.private_encrypted_query(_to_port_query(q))) == _ints(
        jst.private_encrypted_query(q))


@pytest.mark.parametrize("size,slot", [(1 << 10, 3), (1000, 17), (7, 64)])
def test_database_sizing_helpers_equal(size, slot):
    """The grid helpers the cPIR queries size themselves with, and the
    database's build_for_data and generate_empty_db, equal pir_tpu's."""
    jm, tm = jdbm.DBMetadata(slot, size), tdbm.DBMetadata(slot, size)
    for height, group in ((32, 1), (10, 3), (1, 1)):
        assert tm.get_dimensions_for_database(height, group) == \
            jm.get_dimensions_for_database(height, group)
    assert tm.get_sqrt_of_db_size() == jm.get_sqrt_of_db_size()
    assert tm.index_to_coordinates(size - 1, 9, 4) == jm.index_to_coordinates(size - 1, 9, 4)
    assert tdbm.get_optimal_db_dimensions(slot, size) == jdbm.get_optimal_db_dimensions(slot, size)
    assert tdbm.get_optimal_weighted_db_dimensions(slot, size, 3) == \
        jdbm.get_optimal_weighted_db_dimensions(slot, size, 3)
    empty, jempty = tdbm.generate_empty_db(size, slot), jdbm.generate_empty_db(size, slot)
    assert (empty.slot_bytes, empty.db_size) == (jempty.slot_bytes, jempty.db_size)
    assert np.array_equal(empty.data, np.asarray(jempty.data)) and empty.data.shape == (size, slot)
    words = [f"w{i}" * (i % 4) for i in range(9)]
    jd, td = jdbm.new_database(), tdbm.new_database()
    jd.build_for_data(words)
    td.build_for_data(words)
    assert (td.slot_bytes, td.db_size) == (jd.slot_bytes, jd.db_size)
    assert np.array_equal(td.data, jd.data) and td.slot(5).equal(TSlot(jd.slot(5).data))
