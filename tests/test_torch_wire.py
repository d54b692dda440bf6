"""pir_tpu_torch.wire against pir_tpu.wire: every message's bytes equal
in both directions, and the port's decoders refuse malformed frames.

Each message is built by one package, serialized, decoded by the other
and serialized again: the bytes must come back equal (so each package's
encoder gives the other's bytes for the same content), and the decoded
fields must equal the originals. The malformed frames are those of
tests/test_wire_fuzz.py (truncations, byte flips, a sweep of the flags
byte, huge counts at every offset), for every message kind here: where
pir_tpu's decoder raises, the port's raises ValueError in bounded time;
where pir_tpu's parses, the port's parses to the same bytes.
"""

import functools
import random
import time
import zlib

import numpy as np
import pytest

from pir_tpu import aspir as j_aspir
from pir_tpu import aspir_shared as j_ash
from pir_tpu import encrypted as j_enc
from pir_tpu import keyword as j_kw
from pir_tpu import query as j_query
from pir_tpu import wire as j_wire
from pir_tpu.crypto import paillier as j_pai
from pir_tpu.database import DBMetadata as JMeta
from pir_tpu.database import generate_random_db as j_random_db
from pir_tpu.server import private_secret_shared_query as j_answer
from pir_tpu_torch import aspir as t_aspir
from pir_tpu_torch import aspir_shared as t_ash
from pir_tpu_torch import encrypted as t_enc
from pir_tpu_torch import keyword as t_kw
from pir_tpu_torch import query as t_query
from pir_tpu_torch import state
from pir_tpu_torch import wire as t_wire
from pir_tpu_torch.crypto import paillier as t_pai  # noqa: F401
from pir_tpu_torch.database import DBMetadata as TMeta
from pir_tpu_torch.server import private_secret_shared_query as t_answer

from torch_threads import one_torch_thread  # noqa: F401

HEIGHT, SLOT, SEC = 1 << 8, 12, 8
SECPARAM = 2  # DDLEQ repetitions 8 * SECPARAM: a 2 KB proof token to fuzz
MUTATION_TIME_BUDGET_S = 2.0


@functools.lru_cache(maxsize=1)
def _keys():
    sk_j, _ = j_pai.keygen(128)
    return sk_j, state.paillier_secret_key(sk_j.p, sk_j.q)


@functools.lru_cache(maxsize=1)
def _dbs():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(HEIGHT, SLOT), dtype=np.uint8)
    jdb = j_random_db(HEIGHT, SLOT)
    jdb.data = data.copy()
    return jdb, state.database_from_numpy(data, SLOT)


def _messages(pkg: str) -> dict:
    """name -> (bytes, decode, encode) of every message kind, built by the
    package `pkg` ("jax" or "torch"); decode/encode are the OTHER
    package's, as (bytes -> object) and (object -> bytes)."""
    jdb, tdb = _dbs()
    sk_j, sk_t = _keys()
    q, enc, ash, aspir, wire, kw, answer, db, sk, meta = (
        (j_query, j_enc, j_ash, j_aspir, j_wire, j_kw, j_answer, jdb, sk_j, JMeta)
        if pkg == "jax"
        else (t_query, t_enc, t_ash, t_aspir, t_wire, t_kw, t_answer, tdb, sk_t, TMeta))
    other = t_wire if pkg == "jax" else j_wire
    opk = sk_t.public_key if pkg == "jax" else sk_j.public_key
    md = db.metadata()
    pk = sk.public_key
    msgs = {
        "share_compat": q.new_index_query_shares(md, 7, 1, num_shares=2)[0],
        "share_fast": q.new_index_query_shares(md, 7, 1, num_shares=2, fast=True)[1],
        "share_fast_wide": q.new_index_query_shares(meta(SLOT, 1 << 12), 9, 1, num_shares=2,
                                                    fast=True, leaf_bits=1024)[0],
        "share_mp": q.new_index_query_shares(md, 7, 1, num_shares=3)[2],
        "share_kw": q.new_keyword_query_shares(md, 1234, 2, num_shares=2)[1],
    }
    out = {name: (wire.serialize_query_share(s), other.deserialize_query_share,
                  other.serialize_query_share) for name, s in msgs.items()}
    res = answer(db, msgs["share_compat"])
    out["shared_result"] = (wire.serialize_shared_result(res), other.deserialize_shared_result,
                            other.serialize_shared_result)
    out["metadata"] = (wire.serialize_metadata(SLOT, HEIGHT, 15),
                       other.deserialize_metadata, lambda t: other.serialize_metadata(*t))
    eq = enc.new_encrypted_query(md, pk, 2, 3)
    out["encrypted_query"] = (wire.serialize_encrypted_query(eq),
                              other.deserialize_encrypted_query, other.serialize_encrypted_query)
    er = enc.private_encrypted_query(db, eq, engine="python")
    out["encrypted_result"] = (wire.serialize_encrypted_result(er),
                               lambda b: other.deserialize_encrypted_result(b, opk),
                               other.serialize_encrypted_result)
    dq = enc.new_doubly_encrypted_query(md, pk, 2, 40)
    out["doubly_encrypted_query"] = (wire.serialize_doubly_encrypted_query(dq),
                                     other.deserialize_doubly_encrypted_query,
                                     other.serialize_doubly_encrypted_query)
    dr = enc.private_doubly_encrypted_query(db, dq, engine="python")
    out["doubly_encrypted_result"] = (wire.serialize_doubly_encrypted_result(dr),
                                      lambda b: other.deserialize_doubly_encrypted_result(b, opk),
                                      other.serialize_doubly_encrypted_result)
    st = kw.new_private_sqrt_st()
    st.build_for_data(sorted((f"k{i:03d}" for i in range(64)), reverse=True))
    out["sqrt_st_meta"] = (wire.serialize_sqrt_st_meta(st), other.deserialize_sqrt_st_meta,
                           other.serialize_sqrt_st_meta)
    bst = kw.new_private_bst()
    bst.build_for_data(sorted((f"k{i:03d}" for i in range(64)), reverse=True))
    out["bst_meta"] = (wire.serialize_bst_meta(bst), other.deserialize_bst_meta,
                       lambda t: other.serialize_bst_meta(_BstGeometry(*t)))
    key_db = db.__class__(slot_bytes=SEC, db_size=HEIGHT // 2,
                          data=np.asarray(db.data[: HEIGHT // 2, :SEC].copy()))
    aq, st_ = aspir.new_authenticated_query(md, sk, 2, 11, key_db.slot(11))
    out["auth_query"] = (wire.serialize_auth_query(aq), other.deserialize_auth_query,
                         other.serialize_auth_query)
    chal = aspir.generate_auth_chal_for_query(SECPARAM, key_db, aq, engine="python")
    out["chal_token"] = (wire.serialize_chal_token(chal), other.deserialize_chal_token,
                         other.serialize_chal_token)
    proof = aspir.auth_prove(st_, chal)
    out["proof_token"] = (wire.serialize_proof_token(proof), other.deserialize_proof_token,
                          other.serialize_proof_token)
    a_share = ash.new_authenticated_index_query_shares(key_db.metadata(), 5, key_db.slot(5), 1,
                                                       2)[1]
    out["auth_share"] = (wire.serialize_auth_share(a_share), other.deserialize_auth_share,
                         other.serialize_auth_share)
    audit = ash.generate_audit_for_shared_query(key_db, a_share)
    out["audit_share"] = (wire.serialize_audit_share(audit), other.deserialize_audit_share,
                          other.serialize_audit_share)
    return out


class _BstGeometry:
    """What serialize_bst_meta reads of a PrivateBST."""

    def __init__(self, depth, num_keys, slot_bytes):
        self.depth, self.num_keys = depth, num_keys
        self.data_layer = type("Layer", (), {"slot_bytes": slot_bytes})()


@functools.lru_cache(maxsize=2)
def _cached_messages(pkg):
    return _messages(pkg)


NAMES = ["share_compat", "share_fast", "share_fast_wide", "share_mp", "share_kw",
         "shared_result", "metadata", "encrypted_query", "encrypted_result",
         "doubly_encrypted_query", "doubly_encrypted_result", "sqrt_st_meta", "bst_meta",
         "auth_query", "chal_token", "proof_token", "auth_share", "audit_share"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_bytes_cross_both_ways_unchanged(pkg, name):
    """pkg's bytes decode in the other package and re-encode to the same
    bytes."""
    blob, decode, encode = _cached_messages(pkg)[name]
    assert encode(decode(blob)) == blob


def test_decoded_fields_equal_the_originals():
    """A pir_tpu share, result and proof decoded by the port hold the
    same fields."""
    jdb, _ = _dbs()
    md = jdb.metadata()
    for share in (j_query.new_index_query_shares(md, 3, 1, 2)[0],
                  j_query.new_index_query_shares(md, 3, 1, 2, fast=True)[0],
                  j_query.new_index_query_shares(md, 3, 1, num_shares=3)[1]):
        got = t_wire.deserialize_query_share(j_wire.serialize_query_share(share))
        assert [k.bytes for k in got.prf_keys] == [k.bytes for k in share.prf_keys]
        assert (got.is_keyword_based, got.is_two_party, got.share_number, got.group_size) == (
            share.is_keyword_based, share.is_two_party, share.share_number, share.group_size)
        if share.key_fast is not None:
            a, b = got.key_fast, share.key_fast
            assert (a.s_init, a.t_init, a.cw, a.final_cw_block, a.depth, a.height) == (
                b.s_init, b.t_init, b.cw, b.final_cw_block, b.depth, b.height)
        elif share.key_two_party is not None:
            a, b = got.key_two_party, share.key_two_party
            assert (a.s_init, a.t_init, a.cw, a.final_cw) == (b.s_init, b.t_init, b.cw,
                                                              b.final_cw)
        else:
            a, b = got.key_multi_party, share.key_multi_party
            assert a.num_parties == b.num_parties and a.sigma == b.sigma
            assert all(np.array_equal(x, y) for x, y in zip(a.cw, b.cw))
    res = j_answer(jdb, j_query.new_index_query_shares(md, 9, 2, 2)[0])
    got = t_wire.deserialize_shared_result(j_wire.serialize_shared_result(res))
    assert got.slot_bytes == res.slot_bytes
    assert [bytes(s.data) for s in got.shares] == [bytes(s.data) for s in res.shares]


def _mutations(blob: bytes, rng: np.random.Generator):
    yield b""
    yield blob[:1]
    yield blob[: len(blob) // 2]
    yield blob[:-1]
    yield blob + b"\x00" * 7
    for v in range(256):
        b = bytearray(blob)
        if len(b) > 6:
            b[6] = v
            yield bytes(b)
    for _ in range(40):
        b = bytearray(blob)
        i = int(rng.integers(0, len(b)))
        b[i] ^= int(rng.integers(1, 256))
        yield bytes(b)
    for huge in (0xFFFFFF7F, 0xFFFFFFFF, 0x7FFFFFFF):
        for off in range(0, len(blob) - 4):
            b = bytearray(blob)
            b[off:off + 4] = huge.to_bytes(4, "little")
            yield bytes(b)


def _decoders(name):
    """(pir_tpu decode + encode, port decode + encode) of a message kind."""
    sk_j, sk_t = _keys()
    j_de, t_de = (getattr(j_wire, f"deserialize_{name}", None),
                  getattr(t_wire, f"deserialize_{name}", None))
    if name.startswith("share_"):
        j_de, t_de = j_wire.deserialize_query_share, t_wire.deserialize_query_share
        j_en, t_en = j_wire.serialize_query_share, t_wire.serialize_query_share
    elif name in ("encrypted_result", "doubly_encrypted_result"):
        j_en, t_en = getattr(j_wire, f"serialize_{name}"), getattr(t_wire, f"serialize_{name}")
        j_de = functools.partial(j_de, pk=sk_j.public_key)
        t_de = functools.partial(t_de, pk=sk_t.public_key)
    elif name in ("metadata", "bst_meta"):
        j_en = t_en = repr
    else:
        j_en, t_en = getattr(j_wire, f"serialize_{name}"), getattr(t_wire, f"serialize_{name}")
    return (j_de, j_en), (t_de, t_en)


FUZZED = [n for n in NAMES if n not in ("share_fast_wide",)]
_REFUSED = object()


def _encoded(encode, obj):
    """encode(obj), or the name of the exception a half-valid parse
    raises there (a truncated correction word fails an encoder assert)."""
    try:
        return encode(obj)
    except Exception as e:
        return type(e).__name__


@pytest.mark.parametrize("name", FUZZED)
def test_malformed_frames_raise_value_error(name):
    blob = _cached_messages("jax")[name][0]
    (j_de, j_en), (t_de, t_en) = _decoders(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    refused = parsed = 0
    for mut in _mutations(blob, rng):
        try:
            j_obj = j_de(mut)
        except Exception:
            j_obj = _REFUSED
        t0 = time.monotonic()
        if j_obj is _REFUSED:
            with pytest.raises(ValueError):
                t_de(mut)
            refused += 1
        else:
            assert _encoded(t_en, t_de(mut)) == _encoded(j_en, j_obj)
            parsed += 1
        assert time.monotonic() - t0 < MUTATION_TIME_BUDGET_S
    assert refused > 0 and refused + parsed > 40


def test_port_decoders_accept_their_own_shares_at_random():
    """Port-made shares of random indices and group sizes decode in
    pir_tpu to the same bytes (the keygen randomness differs per call)."""
    _, tdb = _dbs()
    rnd = random.Random(3)
    for _ in range(8):
        g = rnd.choice([1, 2, 4])
        fast = rnd.random() < 0.5
        share = t_query.new_index_query_shares(tdb.metadata(), rnd.randrange(HEIGHT // g), g,
                                               fast=fast)[rnd.randrange(2)]
        blob = t_wire.serialize_query_share(share)
        assert j_wire.serialize_query_share(j_wire.deserialize_query_share(blob)) == blob
