"""ASPIR, secret-shared (multi-server) variant (counterpart of
``pir_tpu/aspir_shared.py``; reference: aspir.go:211-295).

The client attaches XOR shares of the auth key for the queried item; each
server computes an audit share = (PIR answer over the *key* database,
reusing the query's expanded DPF bits) XOR (its auth-token share). The
audit passes iff all audit shares XOR to zero — which happens exactly when
the client's auth key matches the key stored for the queried row.

The key-database answer is the host numpy scan
(``server.private_secret_shared_query_with_expanded_bits``), as in
pir_tpu; a ``TorchPirServer`` may expand the bits on its device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .database import Database, DBMetadata
from .query import QueryShare, new_index_query_shares
from .slot import Slot, new_empty_slot, new_random_slot, xor_slots


@dataclass
class AuthTokenShare:
    """A share of the key associated with the queried item (aspir.go:219-224)."""

    t: Slot


@dataclass
class AuditTokenShare:
    """A share of an audit token (aspir.go:213-217)."""

    t: Slot


@dataclass
class AuthenticatedQueryShare:
    """QueryShare + auth token share (aspir.go:28-34)."""

    query_share: QueryShare
    auth_token: AuthTokenShare


def new_auth_token_shares_for_key(auth_key: Slot, num_shares: int) -> list[AuthTokenShare]:
    """share[1..n-1] random; share[0] = key XOR others (aspir.go:226-243)."""
    num_bytes = len(auth_key.data)
    shares: list[AuthTokenShare | None] = [None] * num_shares
    acc = new_empty_slot(num_bytes)
    for i in range(1, num_shares):
        share = new_random_slot(num_bytes)
        xor_slots(acc, share)
        shares[i] = AuthTokenShare(share)
    xor_slots(acc, auth_key)
    shares[0] = AuthTokenShare(acc)
    return shares


def new_authenticated_index_query_shares(
    dbmd: DBMetadata, index: int, auth_key: Slot, group_size: int,
    num_shares: int, fast: bool = False,
) -> list[AuthenticatedQueryShare]:
    """query.go:103-116. fast=True uses the early-termination DPF
    (audit reuse requires group_size == 1 in fast mode)."""
    query_shares = new_index_query_shares(dbmd, index, group_size, fast=fast,
                                          num_shares=num_shares)
    token_shares = new_auth_token_shares_for_key(auth_key, num_shares)
    return [
        AuthenticatedQueryShare(q, t) for q, t in zip(query_shares, token_shares)
    ]


def generate_audit_for_shared_query(
    key_db: Database, query: AuthenticatedQueryShare, server=None
) -> AuditTokenShare:
    """aspir.go:245-264.

    The reference temporarily forces group size 1 for the key-DB
    expansion; we expand a group-1 copy of the share instead of mutating.
    `server` may be a TorchPirServer bound to key_db: it expands on its
    device, and the bits come to the host once.
    """
    group1 = replace(query.query_share, group_size=1)
    if server is not None:
        bits = server.expand_shared_query(group1).cpu().numpy().astype(bool)
    else:
        from . import server as srv

        bits = srv.expand_shared_query(key_db, group1)
    return generate_audit_for_shared_query_with_expanded_bits(key_db, query, bits)


def generate_audit_for_shared_query_with_expanded_bits(
    key_db: Database, query: AuthenticatedQueryShare, bits: np.ndarray
) -> AuditTokenShare:
    """aspir.go:266-279: audit = keyDB answer share XOR auth token share.

    Group size is forced to 1 for the key-DB answer as well as the
    expansion (the reference mutates query.GroupSize before both steps,
    aspir.go:251-254): the key DB holds ONE auth key per group."""
    from . import server as srv

    res = srv.private_secret_shared_query_with_expanded_bits(
        key_db, replace(query.query_share, group_size=1), bits
    )
    if len(res.shares) != 1:
        raise ValueError("Invalid challenge ciphertext result")
    key_slot_share = res.shares[0]
    xor_slots(key_slot_share, query.auth_token.t)
    return AuditTokenShare(key_slot_share)


def check_audit(*audit_tokens: AuditTokenShare) -> bool:
    """True iff all audit tokens XOR to zero (aspir.go:281-295)."""
    res = new_empty_slot(len(audit_tokens[0].t.data))
    for tok in audit_tokens:
        xor_slots(res, tok.t)
    return not any(res.data)
