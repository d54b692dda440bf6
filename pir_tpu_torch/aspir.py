"""ASPIR, single-server AHE variant (counterpart of ``pir_tpu/aspir.py``;
reference: aspir.go:10-209), copied over the port's Paillier and cPIR.

Four-message authenticated retrieval: the client sends a (real, null)
doubly-encrypted query pair with commitments to auth-token ciphertexts;
the server answers both over the *key* database as a challenge; the
client proves the challenge for its real query decrypts to zero (it knows
the per-item auth key) via re-randomization + DDLEQ + opened randomness.

**Deliberate divergence:** the reference commits to token.C at query time
(query.go:264-265) but checks the commitment against the *subtracted*
challenge value (aspir.go:187-191) — which only "passes" because its
digest ignores the value entirely (see commitment.py). Here the
commitment binds the token ciphertext and AuthCheck opens it against
``proof.auth_token.c``, the evident intent.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from .commitment import ROCommitment, commit
from .crypto.paillier import (
    ENC_LEVEL_ONE,
    ENC_LEVEL_TWO,
    Ciphertext,
    DDLEQProof,
    PublicKey,
    SecretKey,
)
from .database import Database, DBMetadata
from .encrypted import (
    DoublyEncryptedQuery,
    new_doubly_encrypted_query,
    private_encrypted_query,
    private_encrypted_query_over_encrypted_result,
)
from .slot import Slot


@dataclass
class AuthenticatedEncryptedQuery:
    """aspir.go:14-26: one real + one null query, order random."""

    query0: DoublyEncryptedQuery
    query1: DoublyEncryptedQuery
    auth_token_comm0: ROCommitment
    auth_token_comm1: ROCommitment


@dataclass
class AuthQueryPrivateState:
    """aspir.go:36-42."""

    sk: SecretKey
    bit: int
    auth_token0: Ciphertext
    auth_token1: Ciphertext


@dataclass
class ChalToken:
    """aspir.go:44-49."""

    token0: Ciphertext
    token1: Ciphertext
    secparam: int


@dataclass
class ProofToken:
    """aspir.go:51-60."""

    auth_token: Ciphertext
    t: Ciphertext
    p: DDLEQProof
    q_bit: int
    r: int
    s: int


def new_authenticated_query(
    dbmd: DBMetadata, sk: SecretKey, group_size: int, index: int, auth_key: Slot
) -> tuple[AuthenticatedEncryptedQuery, AuthQueryPrivateState]:
    """query.go:223-275."""
    pk = sk.public_key

    query_real = new_doubly_encrypted_query(dbmd, pk, group_size, index)
    query_fake = new_doubly_encrypted_query(dbmd, pk, group_size, -1)

    real_token = pk.encrypt(int.from_bytes(bytes(auth_key.data), "big"))
    fake_token = pk.encrypt_zero()

    bit = secrets.randbelow(2)
    if bit == 0:
        query0, token0, query1, token1 = query_real, real_token, query_fake, fake_token
    else:
        query0, token0, query1, token1 = query_fake, fake_token, query_real, real_token

    auth_query = AuthenticatedEncryptedQuery(
        query0, query1, commit(token0.c), commit(token1.c)
    )
    state = AuthQueryPrivateState(sk, bit, token0, token1)
    return auth_query, state


def generate_auth_chal_for_query(
    secparam: int, key_db: Database, query: AuthenticatedEncryptedQuery,
    engine: str | None = None, device=None,
) -> ChalToken:
    """aspir.go:62-108.

    The key DB has one entry per group, so the column query runs with
    group size 1 and the row width divided by the data group size. The
    reference mutates the query struct and restores it (aspir.go:69-76,
    100-105); we adjust copies instead. `engine` selects the cPIR scan
    engine (encrypted.scan_engine) for both passes, `device` its device.
    """
    from dataclasses import replace

    group_size = query.query0.col.group_size
    # served auth queries are attacker-controlled: the narrowing below
    # divides by the col group size, and the challenge must be exactly
    # one level-2 ciphertext per side (the reference asserts the same
    # exactly-one shape for the shared variant, aspir.go:272-274) —
    # bound both here so malformed frames die as clean protocol errors.
    if group_size < 1 or query.query1.col.group_size != group_size:
        raise ValueError("invalid group size provided in auth query")

    def narrowed(dq: DoublyEncryptedQuery) -> DoublyEncryptedQuery:
        return DoublyEncryptedQuery(
            row=replace(dq.row, db_width=dq.row.db_width // group_size),
            col=replace(dq.col, group_size=1),
        )

    q0, q1 = narrowed(query.query0), narrowed(query.query1)

    row_res0 = private_encrypted_query(key_db, q0.row, engine=engine, device=device)
    row_res1 = private_encrypted_query(key_db, q1.row, engine=engine, device=device)
    res0 = private_encrypted_query_over_encrypted_result(
        key_db, q0.col, row_res0, engine=engine, device=device
    )
    res1 = private_encrypted_query_over_encrypted_result(
        key_db, q1.col, row_res1, engine=engine, device=device
    )

    for res in (res0, res1):
        if len(res.slots) != 1 or len(res.slots[0].cts) != 1:
            raise ValueError(
                "auth challenge must reduce to exactly one ciphertext"
            )

    return ChalToken(res0.slots[0].cts[0], res1.slots[0].cts[0], secparam)


def auth_prove(state: AuthQueryPrivateState, chal_token: ChalToken) -> ProofToken:
    """aspir.go:110-171."""
    sk = state.sk

    token0 = sk.nested_sub(chal_token.token0, state.auth_token0)
    token1 = sk.nested_sub(chal_token.token1, state.auth_token1)

    dec0 = sk.nested_decrypt(token0)
    dec1 = sk.nested_decrypt(token1)

    if dec0 != 0 and dec1 != 0:
        raise ValueError("both tokens non-zero -- server likely cheating")

    # if the server cheated on one side, prove whichever token is zero to
    # avoid leaking which query was real (aspir.go:131-154)
    if dec0 != 0 or dec1 != 0:
        if dec0 == 0:
            chal, sel_token, q_bit = token0, state.auth_token0, 0
        else:
            chal, sel_token, q_bit = token1, state.auth_token1, 1
    else:
        if state.bit == 0:
            chal, sel_token, q_bit = token0, state.auth_token0, 0
        else:
            chal, sel_token, q_bit = token1, state.auth_token1, 1

    chal2, a, b = sk.nested_randomize(chal)
    proof = sk.prove_ddleq(chal_token.secparam, chal, chal2, a, b)

    s = sk.extract_randomness(chal2)
    ct_inner = sk.decrypt_nested_layer(chal2)
    r = sk.extract_randomness(ct_inner)

    return ProofToken(sel_token, chal2, proof, q_bit, r, s)


def auth_check(
    pk: PublicKey,
    query: AuthenticatedEncryptedQuery,
    chal_token: ChalToken,
    proof_token: ProofToken,
) -> bool:
    """aspir.go:173-209 (with the binding-commitment fix, see module doc)."""
    if proof_token.q_bit == 0:
        ct1, comm = chal_token.token0, query.auth_token_comm0
    else:
        ct1, comm = chal_token.token1, query.auth_token_comm1

    # the client must use the auth token it committed to at query time
    if not comm.check_open(proof_token.auth_token.c):
        return False

    ct1 = pk.nested_sub(ct1, proof_token.auth_token)
    ct2 = proof_token.t

    if not pk.verify_ddleq(ct1, ct2, proof_token.p):
        return False

    # ct2 must be exactly a double encryption of zero with the provided
    # randomness ==> ct1's inner plaintext is zero (aspir.go:199-205)
    check = pk.encrypt_with_r_at_level(0, proof_token.r, ENC_LEVEL_ONE)
    check = pk.encrypt_with_r_at_level(check.c, proof_token.s, ENC_LEVEL_TWO)
    return check.c == ct2.c
