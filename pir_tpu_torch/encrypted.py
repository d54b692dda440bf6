"""Single-server computational PIR under additively homomorphic Paillier
(counterpart of ``pir_tpu/encrypted.py``).

Client side (query.go:118-221, 299-334): the query is a vector of
encryptions of 0/1 — a one-hot row indicator (and for recursive queries a
second, level-2 one-hot column indicator). Server side (db.go:176-358):
an encrypted selection, sum_row Enc(bit_row) * slot_chunk, per column and
chunk; the recursive variant re-selects over the level-1 ciphertexts with
level-2 ConstMult/Add.

Three scan engines (``scan_engine``): None and ``"torch"`` run the
batched Montgomery multi-exponentiation of ``crypto/mont.py`` (kernel 10)
on ``device=`` (None is the card, and raises with no CUDA; ``"cpu"`` the
plain version), as pir_tpu's ``"tpu"`` engine runs
``tpu_paillier_scan``: level-1 queries through
``TorchPirServer.private_encrypted_query_batch_async``, the given
server's (its exponent matrix cached on its device) or one made for the
call; ``"native"`` runs the threaded C++ scan on the
host (``native.paillier_scan``, ``nprocs`` threads, all cores by
default), as pir_tpu's ``"native"`` engine does, and raises if its
library does not build; ``"python"`` runs the CPython loop, pir_tpu's
golden engine. The caller asks for the host engines by name. Every
engine gives the same ciphertext ints as every pir_tpu engine. pir_tpu's
``"tpu"`` engine is refused by name in favour of ``"torch"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .crypto.paillier import (
    ENC_LEVEL_ONE,
    ENC_LEVEL_TWO,
    Ciphertext,
    PublicKey,
    SecretKey,
    msg_space_bytes,
)
from .database import Database, DBMetadata
from .slot import Slot

# Serving bound on client-supplied Paillier moduli: scan work is cubic
# in bits(N) on every engine, so an uncapped modulus lets one client stall
# a serving host indefinitely. 8192-bit N (N^3 = 24 kbit, 768 words on the
# device engine) is far beyond any real deployment's key size.
MAX_PAILLIER_BITS = 8192


@dataclass
class EncryptedQuery:
    """query.go:24-32."""

    pk: PublicKey
    ebits: list[Ciphertext]
    group_size: int
    db_width: int
    db_height: int


@dataclass
class DoublyEncryptedQuery:
    """query.go:34-39."""

    row: EncryptedQuery
    col: EncryptedQuery


@dataclass
class EncryptedSlot:
    cts: list[Ciphertext]


@dataclass
class DoublyEncryptedSlot:
    cts: list[Ciphertext]  # level-2 ciphertexts


@dataclass
class EncryptedQueryResult:
    slots: list[EncryptedSlot]
    pk: PublicKey
    slot_bytes: int
    num_bytes_per_ciphertext: int


@dataclass
class DoublyEncryptedQueryResult:
    slots: list[DoublyEncryptedSlot]
    pk: PublicKey
    slot_bytes: int
    num_bytes_per_ciphertext: int


# --------------------------------------------------------------------------
# Client: query generation
# --------------------------------------------------------------------------

def sqrt_grid(dbmd: DBMetadata, group_size: int = 1) -> tuple[int, int]:
    """(width, height) of the default square-root grid (query.go:118-127)."""
    height = int(math.ceil(math.sqrt(dbmd.db_size)))
    return dbmd.get_dimensions_for_database(height, group_size)


def new_encrypted_query(
    dbmd: DBMetadata, pk: PublicKey, group_size: int, index: int
) -> EncryptedQuery:
    """query.go:118-127: sqrt-grid default dimensions."""
    width, height = sqrt_grid(dbmd, group_size)
    return new_encrypted_query_with_dimensions(pk, width, height, group_size, index)


def new_encrypted_query_with_dimensions(
    pk: PublicKey, width: int, height: int, group_size: int, index: int
) -> EncryptedQuery:
    """query.go:129-150: EBits one-hot at `index` (index -1 => all zeros).
    The blinding modexps batch through encrypt_batch."""
    ebits = pk.encrypt_batch([1 if i == index else 0 for i in range(height)])
    return EncryptedQuery(pk, ebits, group_size, width, height)


def new_doubly_encrypted_query(
    dbmd: DBMetadata, pk: PublicKey, group_size: int, index: int
) -> DoublyEncryptedQuery:
    """query.go:152-221."""
    width, height = sqrt_grid(dbmd, group_size)
    return new_doubly_encrypted_query_with_dimensions(
        dbmd, pk, width, height, group_size, index
    )


def new_doubly_encrypted_query_with_dimensions(
    dbmd: DBMetadata, pk: PublicKey, width: int, height: int, group_size: int,
    index: int,
) -> DoublyEncryptedQuery:
    row_index, col_index = dbmd.index_to_coordinates(index, width, height)
    col_index //= group_size
    if index == -1:
        row_index = col_index = -1

    row = pk.encrypt_batch([1 if i == row_index else 0 for i in range(height)])
    grouped_width = width // group_size
    col = pk.encrypt_batch(
        [1 if i == col_index else 0 for i in range(grouped_width)],
        ENC_LEVEL_TWO,
    )
    return DoublyEncryptedQuery(
        row=EncryptedQuery(pk, row, group_size, width, height),
        col=EncryptedQuery(pk, col, group_size, width, 1),
    )


def new_doubly_encrypted_null_query(
    dbmd: DBMetadata, pk: PublicKey, group_size: int
) -> DoublyEncryptedQuery:
    """query.go:152-155: index -1 => all-zero (retrieves nothing)."""
    return new_doubly_encrypted_query(dbmd, pk, group_size, -1)


# --------------------------------------------------------------------------
# Server: encrypted scans
# --------------------------------------------------------------------------

def scan_engine(engine: str | None) -> str:
    """Resolve a cPIR scan engine (pir_tpu/encrypted.py:_scan_fn): None and
    "torch" are the device Montgomery engine ("torch"), "native" the C++
    engine on the host, "python" the CPython loop; pir_tpu's "tpu" engine
    raises, never falling back to the loop."""
    if engine in (None, "torch"):
        return "torch"
    if engine in ("python", "native"):
        return engine
    if engine == "tpu":
        raise ValueError("the TPU cPIR scan engine is not ported: use engine='torch', the "
                         "batched Montgomery engine on the card")
    raise ValueError(f"unknown cPIR scan engine {engine!r}")


def _level1_exponents(db: Database, dim_width: int, dim_height: int, num_cts: int,
                      rows=None):
    """The level-1 exponent matrix (pir_tpu/encrypted.py:234-262) straight
    from the database's bytes: (dim_height, dim_width * num_cts, EW) uint32
    words, slot (row, col)'s chunk j at column col * num_cts + j, each
    chunk the big-endian int of its ceil(slot_bytes / num_cts) bytes
    (Slot.to_int_array); slots past the database keep exponent 0, the
    identity. With `rows`, only those grid rows, in their order (the rows
    an update touches). Returns (matrix, e_max = 8 bits a chunk byte,
    bytes a chunk)."""
    per = max(1, -(-db.slot_bytes // num_cts))
    ew = max(1, -(-per // 4))
    rows = np.arange(dim_height) if rows is None else np.asarray(rows, dtype=np.int64)
    slots = (rows[:, None] * dim_width + np.arange(dim_width)).ravel()
    live = slots < db.db_size
    out = np.zeros((len(slots), num_cts, 4 * ew), dtype=np.uint8)
    data = np.asarray(db.data, dtype=np.uint8)[slots[live]]
    for j in range(num_cts):
        start, end = j * per, min(db.slot_bytes, (j + 1) * per)
        if start < end:  # little-endian bytes of the chunk's big-endian int
            out[live, j, :end - start] = data[:, start:end][:, ::-1]
    words = out.view("<u4").astype(np.uint32).reshape(len(rows), dim_width * num_cts, ew)
    return words, 8 * -(-db.slot_bytes // num_cts), per


def check_encrypted_query(db: Database, query: EncryptedQuery) -> int:
    """Raise ValueError unless `query` may be answered over `db`; returns
    the plaintext chunks a slot (num_cts). Served queries are
    attacker-controlled: the scan's work and allocations are O(width *
    height * num_cts), so the geometry must be bounded by the database it
    claims to address (the wire layer bounds only byte counts; same DoS
    class as wire._need)."""
    pk = query.pk
    dim_width, dim_height = query.db_width, query.db_height
    if dim_height != len(query.ebits):
        raise ValueError("query height does not match its ebits vector")
    if dim_width < 1 or dim_height < 1:
        raise ValueError("invalid query dimensions")
    if dim_width > db.db_size or dim_height > db.db_size:
        # each axis alone is bounded by the database: the product bound
        # below is vacuous at height 1 (w*1 <= db_size + w always holds)
        raise ValueError("query dimensions exceed the database")
    if dim_width * dim_height > db.db_size + dim_width:
        # the reference's dimension sanity bound (db_test.go:211-220)
        raise ValueError("query dimensions exceed the database")
    if msg_space_bytes(pk) < 1:
        raise ValueError("paillier modulus too small for any plaintext")
    if pk.n.bit_length() > MAX_PAILLIER_BITS:
        raise ValueError("paillier modulus exceeds the serving bound")
    return max(1, math.ceil(db.slot_bytes / msg_space_bytes(pk)))


def private_encrypted_query(
    db: Database, query: EncryptedQuery, nprocs: int | None = None,
    engine: str | None = None, device=None, server=None,
) -> EncryptedQueryResult:
    """The AHE scan (db.go:176-271).

    Slots are packed into ceil(slot_bytes / (|N|-2)) plaintext chunks;
    answer[col][chunk] = sum_row Enc(bit_row) * chunk(row, col).

    `engine` is resolved by scan_engine; "torch" (and None) is a batch of
    one through TorchPirServer.private_encrypted_query_batch_async:
    `server`'s (a TorchPirServer over `db`, its exponent matrix cached on
    its device) when given, else a server's on `device` (None: the card)
    made for the call; 8 bits a chunk byte bound the exponents. `nprocs`
    is the reference's goroutine fan-out (db.go:193-261): the "native"
    engine's thread count (None: all cores); the others accept it unused.
    """
    if scan_engine(engine) == "torch":
        if server is None:
            from .crypto.mont import resolve_device
            from .server import TorchPirServer

            server = TorchPirServer(db, device=resolve_device(device))
        elif server.db is not db:
            raise ValueError("the server serves another database")
        return server.private_encrypted_query_batch_async([query])()[0]
    pk = query.pk
    dim_width, dim_height = query.db_width, query.db_height
    num_cts = check_encrypted_query(db, query)

    if scan_engine(engine) == "native":
        from . import native

        emat, _, per = _level1_exponents(db, dim_width, dim_height, num_cts)
        width_cts = dim_width * num_cts
        vals = [int.from_bytes(v.tobytes(), "little")
                for v in emat.reshape(dim_height * width_cts, -1)]
        out = native.paillier_scan([ct.c for ct in query.ebits], vals, width_cts, pk.n2,
                                   nprocs or 0)
        slots = [EncryptedSlot([Ciphertext(out[col * num_cts + j], ENC_LEVEL_ONE)
                                for j in range(num_cts)]) for col in range(dim_width)]
        return EncryptedQueryResult(slots, pk, db.slot_bytes, per)

    num_bytes_per_ciphertext = 0
    slots = [
        EncryptedSlot([pk.null_ciphertext(ENC_LEVEL_ONE) for _ in range(num_cts)])
        for _ in range(dim_width)
    ]
    for row in range(dim_height):
        ebit = query.ebits[row]
        for col in range(dim_width):
            slot_index = row * dim_width + col
            if slot_index >= db.db_size:
                continue
            int_arr, per = db.slot(slot_index).to_int_array(num_cts)
            if num_bytes_per_ciphertext == 0:
                num_bytes_per_ciphertext = per
            for j, val in enumerate(int_arr):
                sel = pk.const_mult(ebit, val)
                slots[col].cts[j] = pk.add(slots[col].cts[j], sel)

    return EncryptedQueryResult(slots, pk, db.slot_bytes, num_bytes_per_ciphertext)


def private_doubly_encrypted_query(
    db: Database, query: DoublyEncryptedQuery, nprocs: int | None = None,
    engine: str | None = None, device=None,
) -> DoublyEncryptedQueryResult:
    """db.go:273-292: row pass then column pass."""
    if query.row.group_size > db.db_size or query.row.group_size == 0:
        raise ValueError("invalid group size provided in query")
    if query.col.group_size > query.row.db_width or query.col.group_size == 0:
        raise ValueError("invalid group size provided in query")
    row_res = private_encrypted_query(db, query.row, nprocs, engine, device)
    return private_encrypted_query_over_encrypted_result(
        db, query.col, row_res, nprocs, engine, device
    )


def private_encrypted_query_over_encrypted_result(
    db: Database, query: EncryptedQuery, result: EncryptedQueryResult,
    nprocs: int | None = None, engine: str | None = None, device=None,
) -> DoublyEncryptedQueryResult:
    """db.go:294-358: level-2 selection over level-1 ciphertext values.
    With engine "torch" one scan over column blocks (pir_tpu/encrypted.py:
    323-345): out[member][j] = prod_block ebits[block]^(slot block * g +
    member's chunk j) mod N^3, exponents bounded by bits(N^2)."""
    pk = query.pk
    g = query.group_size
    # the column query is attacker-controlled when served (db.go:294-358
    # semantics over the wire): bound its geometry against the row result
    # it selects over, with the same ValueError class as the row pass —
    # a short ebits vector must not surface as an IndexError.
    if g < 1:
        raise ValueError("invalid group size provided in query")
    if not result.slots:
        raise ValueError("empty row result")
    num_cts = len(result.slots[0].cts)
    if len(result.slots) % g != 0:
        raise ValueError("row has a size that is not a multiple of the group size")
    if len(query.ebits) != len(result.slots) // g:
        raise ValueError("column query does not match the row result geometry")

    if scan_engine(engine) == "native":
        from . import native

        num_blocks = len(result.slots) // g
        vals = [result.slots[blk * g + member].cts[j].c for blk in range(num_blocks)
                for member in range(g) for j in range(num_cts)]
        out = native.paillier_scan([query.ebits[blk].c for blk in range(num_blocks)], vals,
                                   g * num_cts, pk.n3, nprocs or 0)
        res = [[Ciphertext(out[member * num_cts + j], ENC_LEVEL_TWO) for j in range(num_cts)]
               for member in range(g)]
        return DoublyEncryptedQueryResult([DoublyEncryptedSlot(cts) for cts in res], pk,
                                          db.slot_bytes, result.num_bytes_per_ciphertext)
    if scan_engine(engine) == "torch":
        from .crypto.mont import ints_to_words, paillier_scan_words

        num_blocks = len(result.slots) // g
        e_max = pk.n2.bit_length()
        vals = [result.slots[blk * g + member].cts[j].c for blk in range(num_blocks)
                for member in range(g) for j in range(num_cts)]
        if any(v < 0 or v.bit_length() > e_max for v in vals):
            raise ValueError("a level-1 ciphertext exceeds N^2")
        emat = ints_to_words(vals, -(-e_max // 32)).reshape(num_blocks, g * num_cts, -1)
        out = paillier_scan_words([query.ebits[blk].c for blk in range(num_blocks)], emat,
                                  pk.n3, e_max, device)
        res = [[Ciphertext(out[member * num_cts + j], ENC_LEVEL_TWO) for j in range(num_cts)]
               for member in range(g)]
        return DoublyEncryptedQueryResult([DoublyEncryptedSlot(cts) for cts in res], pk,
                                          db.slot_bytes, result.num_bytes_per_ciphertext)

    res = [
        [pk.null_ciphertext(ENC_LEVEL_TWO) for _ in range(num_cts)]
        for _ in range(g)
    ]
    member = 0
    for col in range(len(result.slots)):
        if col % g == 0:
            member = 0
        bit_ct = query.ebits[col // g]
        for j, slot_ct in enumerate(result.slots[col].cts):
            sel = pk.const_mult(bit_ct, slot_ct.c)
            res[member][j] = pk.add(res[member][j], sel)
        member += 1

    return DoublyEncryptedQueryResult(
        [DoublyEncryptedSlot(cts) for cts in res],
        pk,
        db.slot_bytes,
        result.num_bytes_per_ciphertext,
    )


# --------------------------------------------------------------------------
# Client: recovery
# --------------------------------------------------------------------------

def recover_encrypted(res: EncryptedQueryResult, sk: SecretKey) -> list[Slot]:
    """query.go:299-315. All chunks decrypt in one modexp batch."""
    counts = [len(eslot.cts) for eslot in res.slots]
    flat = sk.decrypt_batch([ct for eslot in res.slots for ct in eslot.cts])
    out, off = [], 0
    for c in counts:
        out.append(
            Slot.from_int_array(
                flat[off:off + c], res.slot_bytes, res.num_bytes_per_ciphertext
            )
        )
        off += c
    return out


def recover_doubly_encrypted(
    res: DoublyEncryptedQueryResult, sk: SecretKey
) -> list[Slot]:
    """query.go:317-334. Both decryption layers run as modexp batches."""
    counts = [len(dslot.cts) for dslot in res.slots]
    flat = sk.nested_decrypt_batch(
        [ct for dslot in res.slots for ct in dslot.cts]
    )
    out, off = [], 0
    for c in counts:
        out.append(
            Slot.from_int_array(
                flat[off:off + c], res.slot_bytes, res.num_bytes_per_ciphertext
            )
        )
        off += c
    return out
