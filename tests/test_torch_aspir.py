"""pir_tpu_torch's ASPIR (both variants) against pir_tpu's.

Shared variant: the same authenticated shares (made by pir_tpu, carried
across as wire bytes) give byte-equal audit tokens in both packages,
from the host expansion and from a TorchPirServer's (device="cpu"), for
fast and reference-exact keys; audits pass for the right key and fail
for a wrong one. AHE variant: a client of one package and a server of
the other (every message through the wire) complete the challenge and
proof for the right key, give equal challenge tokens for the same
query, and stay sound: a wrong key proves only the null side, and a
swapped token or a tampered proof fails auth_check. 128-bit keys as in
tests/test_aspir.py.
"""

import random
import zlib

import numpy as np
import pytest

from pir_tpu import aspir as ja
from pir_tpu import aspir_shared as jsh
from pir_tpu import wire as jw
from pir_tpu.crypto import paillier as jp
from pir_tpu.database import generate_random_db as j_random_db
from pir_tpu_torch import aspir as ta
from pir_tpu_torch import aspir_shared as tsh
from pir_tpu_torch import state
from pir_tpu_torch import wire as tw
from pir_tpu_torch.server import TorchPirServer

from torch_threads import one_torch_thread  # noqa: F401

SEC = 8
KEY_ROWS = 1 << 10
AHE_ROWS = 1 << 6


def _jdb(data):
    db = j_random_db(*data.shape)
    db.data = data.copy()
    return db


@pytest.fixture(scope="module")
def key_dbs():
    data = np.random.default_rng(21).integers(0, 256, size=(KEY_ROWS, SEC), dtype=np.uint8)
    tdb = state.database_from_numpy(data, SEC)
    return _jdb(data), tdb, TorchPirServer(tdb, device="cpu")


def _audit_bytes(audit):
    return bytes(audit.t.data)


@pytest.mark.parametrize("fast", [False, True])
def test_shared_audit_tokens_equal(key_dbs, fast):
    jdb, tdb, tsrv = key_dbs
    rnd = random.Random(int(fast))
    for right in (True, False):
        index = rnd.randrange(1, KEY_ROWS)
        key = jdb.slot(index if right else 0)
        shares = jsh.new_authenticated_index_query_shares(jdb.metadata(), index, key, 1, 2,
                                                          fast=fast)
        j_audits, t_audits = [], []
        for s in shares:
            ts = tw.deserialize_auth_share(jw.serialize_auth_share(s))
            ja_ = jsh.generate_audit_for_shared_query(jdb, s)
            host = tsh.generate_audit_for_shared_query(tdb, ts)
            dev = tsh.generate_audit_for_shared_query(tdb, ts, server=tsrv)
            assert _audit_bytes(host) == _audit_bytes(ja_) == _audit_bytes(dev)
            j_audits.append(ja_)
            t_audits.append(dev)
        assert jsh.check_audit(*j_audits) == tsh.check_audit(*t_audits) == right


def test_port_made_shares_audit_in_both(key_dbs):
    """Shares the port makes (three servers, group size 2) pass the audit
    in both packages for the right key and fail for a wrong one."""
    jdb, tdb, _ = key_dbs
    data_md = type(tdb.metadata())(16, 2 * KEY_ROWS)  # one key per group of 2
    for right in (True, False):
        key = tdb.slot(9 if right else 10)
        shares = tsh.new_authenticated_index_query_shares(data_md, 9, key, 2, 3)
        t_audits = [tsh.generate_audit_for_shared_query(tdb, s) for s in shares]
        j_audits = [jsh.generate_audit_for_shared_query(
            jdb, jw.deserialize_auth_share(tw.serialize_auth_share(s))) for s in shares]
        assert [_audit_bytes(a) for a in t_audits] == [_audit_bytes(a) for a in j_audits]
        assert tsh.check_audit(*t_audits) == jsh.check_audit(*j_audits) == right


@pytest.fixture(scope="module")
def ahe():
    sk_j, _ = jp.keygen(128)
    sk_t = state.paillier_secret_key(sk_j.p, sk_j.q)
    rng = np.random.default_rng(22)
    key_data = rng.integers(0, 256, size=(AHE_ROWS, SEC), dtype=np.uint8)
    return sk_j, sk_t, _jdb(key_data), state.database_from_numpy(key_data, SEC)


PKGS = {"jax": (ja, jw), "torch": (ta, tw)}


def _round(ahe, client, server, index, key_index, tamper=None):
    """One AHE round, a `client` package's query and proof against a
    `server` package's challenge and check, every message as wire bytes.
    Returns (check verdict, proven side == real side)."""
    sk_j, sk_t, jkeys, tkeys = ahe
    (ca, cw), (sa, sw) = PKGS[client], PKGS[server]
    sk = sk_j if client == "jax" else sk_t
    keys = jkeys if server == "jax" else tkeys
    md = jkeys.metadata()
    q, st = ca.new_authenticated_query(md, sk, 1, index, jkeys.slot(key_index))
    sq = sw.deserialize_auth_query(cw.serialize_auth_query(q))
    chal = sa.generate_auth_chal_for_query(SEC, keys, sq, engine="python")
    proof = ca.auth_prove(st, cw.deserialize_chal_token(sw.serialize_chal_token(chal)))
    if tamper == "token":
        proof.auth_token = sk.public_key.encrypt_zero()
    if tamper == "commitment":
        proof.p.commitments[0] = proof.p.commitments[0] * 2 % sk.n3
    sp = sw.deserialize_proof_token(cw.serialize_proof_token(proof))
    ok = sa.auth_check(sq.query0.row.pk, sq, chal, sp)
    return ok, proof.q_bit == st.bit


@pytest.mark.parametrize("client,server", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_ahe_completeness_and_soundness_across_packages(ahe, client, server):
    index = random.Random(zlib.crc32(f"{client}-{server}".encode())).randrange(1, AHE_ROWS)
    assert _round(ahe, client, server, index, index) == (True, True)
    # wrong key: only the null side can be proven, and it checks
    assert _round(ahe, client, server, index, 0) == (True, False)
    for tamper in ("token", "commitment"):
        assert not _round(ahe, client, server, index, index, tamper)[0]


def test_challenge_tokens_equal_for_one_query(ahe):
    """Both packages' servers answer the same auth query with the same
    challenge bytes (the challenge is a deterministic cPIR scan)."""
    sk_j, _, jkeys, tkeys = ahe
    q, _ = ja.new_authenticated_query(jkeys.metadata(), sk_j, 1, 7, jkeys.slot(7))
    blob = jw.serialize_auth_query(q)
    cj = ja.generate_auth_chal_for_query(SEC, jkeys, jw.deserialize_auth_query(blob))
    ct = ta.generate_auth_chal_for_query(SEC, tkeys, tw.deserialize_auth_query(blob),
                                        engine="python")
    assert tw.serialize_chal_token(ct) == jw.serialize_chal_token(cj)


def test_auth_chal_geometry_bounds_as_pir_tpu(ahe):
    _, sk_t, _, tkeys = ahe

    def fresh():
        return ta.new_authenticated_query(tkeys.metadata(), sk_t, 1, 3, tkeys.slot(3))[0]

    q = fresh()
    q.query1.col.group_size = 2
    with pytest.raises(ValueError, match="group size"):
        ta.generate_auth_chal_for_query(SEC, tkeys, q, engine="python")
    q = fresh()
    q.query0.col.ebits = q.query0.col.ebits[:-1]
    with pytest.raises(ValueError, match="geometry"):
        ta.generate_auth_chal_for_query(SEC, tkeys, q, engine="python")
    wide = state.database_from_numpy(np.zeros((AHE_ROWS, 33), np.uint8), 33)
    with pytest.raises(ValueError, match="exactly one ciphertext"):
        ta.generate_auth_chal_for_query(SEC, wide, fresh(), engine="python")
