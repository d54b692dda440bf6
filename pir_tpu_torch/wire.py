"""Wire format for queries, shares, and results (counterpart of
``pir_tpu/wire.py``), copied over the port's types: every message's bytes
equal pir_tpu's, in both directions.

Little-endian, length-prefixed, versioned. Layout of a two-party DPF key
mirrors the reference's implicit structure (dpf/common.go:29-35):
SInit(16) ‖ TInit(1) ‖ num_bits(u16) ‖ CW[num_bits]·18 ‖ FinalCW(i64).

Every decoder raises ValueError on a malformed frame (pir_tpu's let a
short buffer's struct.error out).
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from .dpf.host import FastKey2P, Key2P, KeyMP, PrfKey
from .query import QueryShare, SecretSharedQueryResult
from .slot import Slot

MAGIC = b"PIRT"
VERSION = 1

MSG_QUERY_SHARE = 1
MSG_SHARED_RESULT = 2
MSG_METADATA = 3


def _header(msg_type: int) -> bytes:
    return MAGIC + struct.pack("<BB", VERSION, msg_type)


def _check_header(buf: memoryview, msg_type: int) -> memoryview:
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("bad magic")
    version, mt = struct.unpack_from("<BB", buf, 4)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    if mt != msg_type:
        raise ValueError(f"expected message type {msg_type}, got {mt}")
    return buf[6:]


def _need(buf: memoryview, off: int, nbytes: int) -> None:
    """Bound a count-driven loop by the bytes actually present.

    Every deserializer loop whose body only slices (slicing past the end
    silently yields b\"\") must pre-check count * item_size against the
    remaining payload: a corrupted or malicious count field (u32) would
    otherwise drive billions of empty iterations — a CPU/memory DoS the
    wire fuzzer caught live (tests/test_wire_fuzz.py). Callers pass
    max(1, item_size) so zero-size items cannot defeat the bound."""
    if nbytes > len(buf) - off:
        raise ValueError("truncated or corrupt message")


def _malformed(fn):
    """A decoder that raises ValueError on any malformed frame: struct's
    short-buffer error (pir_tpu lets struct.error out) becomes ValueError
    with the same message."""
    @functools.wraps(fn)
    def decode(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except struct.error as e:
            raise ValueError(str(e)) from e

    return decode


# ---- Key2P ----

def serialize_key2p(key: Key2P) -> bytes:
    num_bits = len(key.cw)
    parts = [bytes(key.s_init), struct.pack("<BH", key.t_init, num_bits)]
    for cw in key.cw:
        assert len(cw) == 18
        parts.append(bytes(cw))
    parts.append(struct.pack("<q", key.final_cw))
    return b"".join(parts)


@_malformed
def deserialize_key2p(buf: memoryview) -> tuple[Key2P, int]:
    s_init = bytes(buf[:16])
    t_init, num_bits = struct.unpack_from("<BH", buf, 16)
    off = 19
    _need(buf, off, num_bits * 18 + 8)
    cw = []
    for _ in range(num_bits):
        cw.append(bytes(buf[off:off + 18]))
        off += 18
    (final_cw,) = struct.unpack_from("<q", buf, off)
    off += 8
    return Key2P(s_init, t_init, cw, final_cw), off


# ---- FastKey2P ----

def serialize_fast_key(key) -> bytes:
    """128-bit-leaf keys keep the original fixed-fcw encoding; wide-leaf
    keys (leaf_bits > 128, flagged by bit 4 of the QueryShare flags) add
    a u8 block count before the cw list and carry a 16*n_blk-byte fcw."""
    n_blk = len(key.final_cw_block) // 16
    parts = [bytes(key.s_init)]
    if n_blk == 1:
        parts.append(struct.pack("<BH", key.t_init, key.depth))
    else:
        parts.append(struct.pack("<BHB", key.t_init, key.depth, n_blk))
    parts += [bytes(cw) for cw in key.cw]
    parts.append(bytes(key.final_cw_block))
    parts.append(struct.pack("<Q", key.height))
    return b"".join(parts)


@_malformed
def deserialize_fast_key(buf: memoryview, wide: bool = False):
    s_init = bytes(buf[:16])
    if wide:
        t_init, depth, n_blk = struct.unpack_from("<BHB", buf, 16)
        off = 20
        if n_blk < 2:
            raise ValueError("wide fast key must have >= 2 leaf blocks")
    else:
        t_init, depth = struct.unpack_from("<BH", buf, 16)
        off, n_blk = 19, 1
    _need(buf, off, depth * 18 + 16 * n_blk + 8)
    cw = []
    for _ in range(depth):
        cw.append(bytes(buf[off:off + 18]))
        off += 18
    fcw = bytes(buf[off:off + 16 * n_blk])
    off += 16 * n_blk
    (height,) = struct.unpack_from("<Q", buf, off)
    off += 8
    return FastKey2P(s_init, t_init, cw, fcw, depth, height), off


# ---- KeyMP ----

def serialize_key_mp(key) -> bytes:
    """num_parties, p2 correction words of mu uint32s, n_gamma sigma rows."""
    # p2 = 2^(num_parties-1) and n_gamma = 2^ceil(num_bits/2) both exceed
    # uint16 in real configurations (keyword MP keys have num_bits=32 so
    # n_gamma = 2^16; num_parties >= 17 overflows p2), so all three counts
    # are u32.
    p2, mu = len(key.cw), (len(key.cw[0]) if key.cw else 0)
    parts = [struct.pack("<BIII", key.num_parties, p2, mu, len(key.sigma))]
    parts += [np.asarray(c, dtype="<u4").tobytes() for c in key.cw]
    if key.sigma:
        row_len = len(key.sigma[0])
        parts.append(struct.pack("<I", row_len))
        parts += [bytes(s) for s in key.sigma]
    else:
        parts.append(struct.pack("<I", 0))
    return b"".join(parts)


@_malformed
def deserialize_key_mp(buf: memoryview):
    num_parties, p2, mu, n_gamma = struct.unpack_from("<BIII", buf, 0)
    off = 13
    _need(buf, off, p2 * max(1, mu * 4))
    cw = []
    for _ in range(p2):
        cw.append(np.frombuffer(buf[off:off + mu * 4], dtype="<u4").copy())
        off += mu * 4
    (row_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    _need(buf, off, n_gamma * max(1, row_len))
    sigma = []
    for _ in range(n_gamma):
        sigma.append(bytes(buf[off:off + row_len]))
        off += row_len
    return KeyMP(num_parties, cw, sigma), off


# ---- QueryShare ----

def serialize_query_share(qs: QueryShare) -> bytes:
    flags = (1 if qs.is_keyword_based else 0)
    if qs.is_two_party:
        flags |= 2
    if qs.key_fast is not None:
        flags |= 4  # bit2: early-termination (fast) key
        if len(qs.key_fast.final_cw_block) != 16:
            flags |= 16  # bit4: wide-leaf fast key (leaf_bits > 128)
    if qs.key_multi_party is not None:
        flags |= 8  # bit3: multi-party (>=3 server) key
    head = _header(MSG_QUERY_SHARE) + struct.pack(
        "<BBI", flags, qs.share_number, qs.group_size
    )
    prf = b"".join(bytes(k.bytes) for k in qs.prf_keys)
    assert len(prf) == 64
    if qs.key_fast is not None:
        return head + prf + serialize_fast_key(qs.key_fast)
    if qs.key_multi_party is not None:
        return head + prf + serialize_key_mp(qs.key_multi_party)
    return head + prf + serialize_key2p(qs.key_two_party)


@_malformed
def deserialize_query_share(data: bytes) -> QueryShare:
    buf = _check_header(memoryview(data), MSG_QUERY_SHARE)
    flags, share_number, group_size = struct.unpack_from("<BBI", buf, 0)
    off = 6
    prf_keys = [PrfKey(bytes(buf[off + 16 * i:off + 16 * (i + 1)])) for i in range(4)]
    off += 64
    key2p, key_fast, key_mp = None, None, None
    if flags & 4:
        key_fast, _ = deserialize_fast_key(buf[off:], wide=bool(flags & 16))
    elif flags & 8:
        key_mp, _ = deserialize_key_mp(buf[off:])
    else:
        key2p, _ = deserialize_key2p(buf[off:])
    return QueryShare(
        key_two_party=key2p,
        key_multi_party=key_mp,
        prf_keys=prf_keys,
        is_keyword_based=bool(flags & 1),
        is_two_party=bool(flags & 2),
        share_number=share_number,
        group_size=group_size,
        key_fast=key_fast,
    )


# ---- SecretSharedQueryResult ----

def serialize_shared_result(res: SecretSharedQueryResult) -> bytes:
    head = _header(MSG_SHARED_RESULT) + struct.pack(
        "<II", res.slot_bytes, len(res.shares)
    )
    body = b"".join(bytes(s.data) for s in res.shares)
    return head + body


@_malformed
def deserialize_shared_result(data: bytes) -> SecretSharedQueryResult:
    buf = _check_header(memoryview(data), MSG_SHARED_RESULT)
    slot_bytes, n = struct.unpack_from("<II", buf, 0)
    off = 8
    _need(buf, off, n * max(1, slot_bytes))
    shares = []
    for _ in range(n):
        shares.append(Slot(bytes(buf[off:off + slot_bytes])))
        off += slot_bytes
    return SecretSharedQueryResult(slot_bytes, shares)


# ---- Paillier / encrypted queries (cPIR) ----

MSG_ENCRYPTED_QUERY = 4
MSG_ENCRYPTED_RESULT = 5


def _int_out(v: int) -> bytes:
    b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    return struct.pack("<I", len(b)) + b


def _int_in(buf: memoryview, off: int) -> tuple[int, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return int.from_bytes(bytes(buf[off:off + n]), "big"), off + n


def serialize_encrypted_query(q) -> bytes:
    """EncryptedQuery (encrypted.py) -> bytes; carries pk.n inline."""
    parts = [
        _header(MSG_ENCRYPTED_QUERY),
        struct.pack("<III", q.group_size, q.db_width, q.db_height),
        _int_out(q.pk.n),
        struct.pack("<I", len(q.ebits)),
    ]
    for ct in q.ebits:
        parts.append(struct.pack("<B", ct.level))
        parts.append(_int_out(ct.c))
    return b"".join(parts)


@_malformed
def deserialize_encrypted_query(data: bytes):
    from .crypto.paillier import Ciphertext, PublicKey
    from .encrypted import EncryptedQuery

    buf = _check_header(memoryview(data), MSG_ENCRYPTED_QUERY)
    group_size, width, height = struct.unpack_from("<III", buf, 0)
    n, off = _int_in(buf, 12)
    (count,) = struct.unpack_from("<I", buf, off)
    off += 4
    _need(buf, off, count * 5)  # each ct: level byte + u32 length
    ebits = []
    for _ in range(count):
        (level,) = struct.unpack_from("<B", buf, off)
        off += 1
        c, off = _int_in(buf, off)
        ebits.append(Ciphertext(c, level))
    return EncryptedQuery(PublicKey(n), ebits, group_size, width, height)


def serialize_encrypted_result(res) -> bytes:
    """EncryptedQueryResult -> bytes (ciphertexts only; pk travels with
    the query)."""
    parts = [
        _header(MSG_ENCRYPTED_RESULT),
        struct.pack("<III", res.slot_bytes, res.num_bytes_per_ciphertext,
                    len(res.slots)),
    ]
    for slot in res.slots:
        parts.append(struct.pack("<I", len(slot.cts)))
        for ct in slot.cts:
            parts.append(struct.pack("<B", ct.level))
            parts.append(_int_out(ct.c))
    return b"".join(parts)


@_malformed
def deserialize_encrypted_result(data: bytes, pk):
    from .crypto.paillier import Ciphertext
    from .encrypted import EncryptedQueryResult, EncryptedSlot

    buf = _check_header(memoryview(data), MSG_ENCRYPTED_RESULT)
    slot_bytes, per_ct, n_slots = struct.unpack_from("<III", buf, 0)
    off = 12
    _need(buf, off, n_slots * 4)
    slots = []
    for _ in range(n_slots):
        (n_cts,) = struct.unpack_from("<I", buf, off)
        off += 4
        _need(buf, off, n_cts * 5)
        cts = []
        for _ in range(n_cts):
            (level,) = struct.unpack_from("<B", buf, off)
            off += 1
            c, off = _int_in(buf, off)
            cts.append(Ciphertext(c, level))
        slots.append(EncryptedSlot(cts))
    return EncryptedQueryResult(slots, pk, slot_bytes, per_ct)


# ---- recursive (doubly-encrypted) queries ----

MSG_DOUBLY_ENCRYPTED_QUERY = 6
MSG_DOUBLY_ENCRYPTED_RESULT = 7


def serialize_doubly_encrypted_query(q) -> bytes:
    """DoublyEncryptedQuery -> bytes: two nested EncryptedQuery messages."""
    row = serialize_encrypted_query(q.row)
    col = serialize_encrypted_query(q.col)
    return (_header(MSG_DOUBLY_ENCRYPTED_QUERY)
            + struct.pack("<I", len(row)) + row
            + struct.pack("<I", len(col)) + col)


@_malformed
def deserialize_doubly_encrypted_query(data: bytes):
    from .encrypted import DoublyEncryptedQuery

    buf = _check_header(memoryview(data), MSG_DOUBLY_ENCRYPTED_QUERY)
    (n,) = struct.unpack_from("<I", buf, 0)
    row = deserialize_encrypted_query(bytes(buf[4:4 + n]))
    off = 4 + n
    (n2,) = struct.unpack_from("<I", buf, off)
    col = deserialize_encrypted_query(bytes(buf[off + 4:off + 4 + n2]))
    return DoublyEncryptedQuery(row=row, col=col)


def serialize_doubly_encrypted_result(res) -> bytes:
    """DoublyEncryptedQueryResult -> bytes (level-2 ciphertexts)."""
    parts = [
        _header(MSG_DOUBLY_ENCRYPTED_RESULT),
        struct.pack("<III", res.slot_bytes, res.num_bytes_per_ciphertext,
                    len(res.slots)),
    ]
    for slot in res.slots:
        parts.append(struct.pack("<I", len(slot.cts)))
        for ct in slot.cts:
            parts.append(struct.pack("<B", ct.level))
            parts.append(_int_out(ct.c))
    return b"".join(parts)


@_malformed
def deserialize_doubly_encrypted_result(data: bytes, pk):
    from .crypto.paillier import Ciphertext
    from .encrypted import DoublyEncryptedQueryResult, DoublyEncryptedSlot

    buf = _check_header(memoryview(data), MSG_DOUBLY_ENCRYPTED_RESULT)
    slot_bytes, per_ct, n_slots = struct.unpack_from("<III", buf, 0)
    off = 12
    _need(buf, off, n_slots * 4)
    slots = []
    for _ in range(n_slots):
        (n_cts,) = struct.unpack_from("<I", buf, off)
        off += 4
        _need(buf, off, n_cts * 5)
        cts = []
        for _ in range(n_cts):
            (level,) = struct.unpack_from("<B", buf, off)
            off += 1
            c, off = _int_in(buf, off)
            cts.append(Ciphertext(c, level))
        slots.append(DoublyEncryptedSlot(cts))
    return DoublyEncryptedQueryResult(slots, pk, slot_bytes, per_ct)


# ---- keyword sqrt-ST first layer ----

MSG_SQRTST = 8


def serialize_sqrt_st_meta(st) -> bytes:
    """PrivateSqrtST client-visible part: boundary keys + geometry.

    The second layer itself is served as an ordinary index-PIR database
    (keyword.go:76-81); only the first layer travels in the clear, as the
    reference's threat model prescribes (SURVEY.md §2.7)."""
    parts = [
        _header(MSG_SQRTST),
        struct.pack("<IIII", st.num_keys, st.width, st.height, st.slot_bytes),
        struct.pack("<I", len(st.first_layer)),
    ]
    for s in st.first_layer:
        b = s.encode("utf-8")
        parts.append(struct.pack("<H", len(b)) + b)
    return b"".join(parts)


@_malformed
def deserialize_sqrt_st_meta(data: bytes):
    """-> a client-side PrivateSqrtST (first layer only; no second_layer)."""
    from .keyword import PrivateSqrtST

    buf = _check_header(memoryview(data), MSG_SQRTST)
    num_keys, width, height, slot_bytes = struct.unpack_from("<IIII", buf, 0)
    (count,) = struct.unpack_from("<I", buf, 16)
    off = 20
    _need(buf, off, count * 2)  # each entry: u16 length prefix
    first = []
    for _ in range(count):
        (n,) = struct.unpack_from("<H", buf, off)
        off += 2
        first.append(bytes(buf[off:off + n]).decode("utf-8"))
        off += n
    st = PrivateSqrtST()
    st.first_layer = first
    st.num_keys = num_keys
    st.width = width
    st.height = height
    st.slot_bytes = slot_bytes
    return st


# ---- ASPIR (authenticated PIR, aspir.go) ----

MSG_AUTH_QUERY = 9
MSG_CHAL_TOKEN = 10
MSG_PROOF_TOKEN = 11
MSG_AUTH_SHARE = 12
MSG_AUDIT_SHARE = 13


def _commitment_out(comm) -> bytes:
    return (struct.pack("<I", len(comm.hash_bytes)) + comm.hash_bytes
            + _int_out(comm.r))


def _commitment_in(buf: memoryview, off: int):
    from .commitment import ROCommitment

    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    hb = bytes(buf[off:off + n])
    off += n
    r, off = _int_in(buf, off)
    return ROCommitment(hb, r), off


def _ct_out(ct) -> bytes:
    return struct.pack("<B", ct.level) + _int_out(ct.c)


def _ct_in(buf: memoryview, off: int):
    from .crypto.paillier import Ciphertext

    (level,) = struct.unpack_from("<B", buf, off)
    c, off = _int_in(buf, off + 1)
    return Ciphertext(c, level), off


def serialize_auth_query(q) -> bytes:
    """AuthenticatedEncryptedQuery (aspir.go:14-26) -> bytes."""
    q0 = serialize_doubly_encrypted_query(q.query0)
    q1 = serialize_doubly_encrypted_query(q.query1)
    return (_header(MSG_AUTH_QUERY)
            + struct.pack("<I", len(q0)) + q0
            + struct.pack("<I", len(q1)) + q1
            + _commitment_out(q.auth_token_comm0)
            + _commitment_out(q.auth_token_comm1))


@_malformed
def deserialize_auth_query(data: bytes):
    from .aspir import AuthenticatedEncryptedQuery

    buf = _check_header(memoryview(data), MSG_AUTH_QUERY)
    (n0,) = struct.unpack_from("<I", buf, 0)
    q0 = deserialize_doubly_encrypted_query(bytes(buf[4:4 + n0]))
    off = 4 + n0
    (n1,) = struct.unpack_from("<I", buf, off)
    off += 4
    q1 = deserialize_doubly_encrypted_query(bytes(buf[off:off + n1]))
    off += n1
    c0, off = _commitment_in(buf, off)
    c1, off = _commitment_in(buf, off)
    return AuthenticatedEncryptedQuery(q0, q1, c0, c1)


def serialize_chal_token(t) -> bytes:
    """ChalToken (aspir.go:44-49) -> bytes."""
    return (_header(MSG_CHAL_TOKEN) + struct.pack("<I", t.secparam)
            + _ct_out(t.token0) + _ct_out(t.token1))


@_malformed
def deserialize_chal_token(data: bytes):
    from .aspir import ChalToken

    buf = _check_header(memoryview(data), MSG_CHAL_TOKEN)
    (secparam,) = struct.unpack_from("<I", buf, 0)
    t0, off = _ct_in(buf, 4)
    t1, off = _ct_in(buf, off)
    return ChalToken(t0, t1, secparam)


def serialize_proof_token(p) -> bytes:
    """ProofToken (aspir.go:51-60) -> bytes; carries the DDLEQ proof."""
    parts = [
        _header(MSG_PROOF_TOKEN),
        _ct_out(p.auth_token),
        _ct_out(p.t),
        struct.pack("<B", p.q_bit),
        _int_out(p.r),
        _int_out(p.s),
        struct.pack("<II", p.p.secparam, len(p.p.commitments)),
    ]
    for c in p.p.commitments:
        parts.append(_int_out(c))
    parts.append(struct.pack("<I", len(p.p.responses)))
    for x, y in p.p.responses:
        parts.append(_int_out(x))
        parts.append(_int_out(y))
    return b"".join(parts)


@_malformed
def deserialize_proof_token(data: bytes):
    from .aspir import ProofToken
    from .crypto.paillier import DDLEQProof

    buf = _check_header(memoryview(data), MSG_PROOF_TOKEN)
    auth_token, off = _ct_in(buf, 0)
    t, off = _ct_in(buf, off)
    (q_bit,) = struct.unpack_from("<B", buf, off)
    off += 1
    r, off = _int_in(buf, off)
    s, off = _int_in(buf, off)
    secparam, n_comm = struct.unpack_from("<II", buf, off)
    off += 8
    _need(buf, off, n_comm * 4)
    commitments = []
    for _ in range(n_comm):
        c, off = _int_in(buf, off)
        commitments.append(c)
    (n_resp,) = struct.unpack_from("<I", buf, off)
    off += 4
    _need(buf, off, n_resp * 8)
    responses = []
    for _ in range(n_resp):
        x, off = _int_in(buf, off)
        y, off = _int_in(buf, off)
        responses.append((x, y))
    proof = DDLEQProof(commitments, responses, secparam)
    return ProofToken(auth_token, t, proof, q_bit, r, s)


def serialize_auth_share(s) -> bytes:
    """AuthenticatedQueryShare (aspir.go:28-34) -> bytes."""
    qs = serialize_query_share(s.query_share)
    tok = bytes(s.auth_token.t.data)
    return (_header(MSG_AUTH_SHARE)
            + struct.pack("<I", len(qs)) + qs
            + struct.pack("<I", len(tok)) + tok)


@_malformed
def deserialize_auth_share(data: bytes):
    from .aspir_shared import AuthenticatedQueryShare, AuthTokenShare

    buf = _check_header(memoryview(data), MSG_AUTH_SHARE)
    (n,) = struct.unpack_from("<I", buf, 0)
    qs = deserialize_query_share(bytes(buf[4:4 + n]))
    off = 4 + n
    (tn,) = struct.unpack_from("<I", buf, off)
    off += 4
    tok = Slot(bytes(buf[off:off + tn]))
    return AuthenticatedQueryShare(qs, AuthTokenShare(tok))


def serialize_audit_share(a) -> bytes:
    """AuditTokenShare (aspir.go:213-217) -> bytes."""
    tok = bytes(a.t.data)
    return _header(MSG_AUDIT_SHARE) + struct.pack("<I", len(tok)) + tok


@_malformed
def deserialize_audit_share(data: bytes):
    from .aspir_shared import AuditTokenShare

    buf = _check_header(memoryview(data), MSG_AUDIT_SHARE)
    (n,) = struct.unpack_from("<I", buf, 0)
    return AuditTokenShare(Slot(bytes(buf[4:4 + n])))


# ---- PrivateBST (keyword.go:14-16's stated future work) ----

MSG_BST_META = 14


def serialize_bst_meta(bst) -> bytes:
    """Client-visible BST geometry: depth, num_keys, level slot size.

    Unlike the sqrt tree's first layer, NO keys travel in the clear —
    that is the point of the BST variant (O(slot * log N) bandwidth)."""
    return _header(MSG_BST_META) + struct.pack(
        "<IQI", bst.depth, bst.num_keys, bst.data_layer.slot_bytes
    )


@_malformed
def deserialize_bst_meta(data: bytes) -> tuple[int, int, int]:
    buf = _check_header(memoryview(data), MSG_BST_META)
    depth, num_keys, slot_bytes = struct.unpack_from("<IQI", buf, 0)
    return depth, num_keys, slot_bytes


# ---- DBMetadata ----

META_HAS_KEYWORDS = 1  # server db carries a keyword column (db.go:119-135)
META_HAS_SQRT_ST = 2  # service hosts a keyword sqrt search tree
META_HAS_KEY_DB = 4  # service hosts an ASPIR auth-key database (aspir.go)
META_HAS_BST = 8  # service hosts a PrivateBST keyword index


def serialize_metadata(slot_bytes: int, db_size: int, flags: int = 0) -> bytes:
    return _header(MSG_METADATA) + struct.pack("<IQB", slot_bytes, db_size, flags)


@_malformed
def deserialize_metadata(data: bytes) -> tuple[int, int, int]:
    buf = _check_header(memoryview(data), MSG_METADATA)
    slot_bytes, db_size = struct.unpack_from("<IQ", buf, 0)
    flags = buf[12] if len(buf) > 12 else 0  # r1 peers sent no flags byte
    return slot_bytes, db_size, flags
