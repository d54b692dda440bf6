"""Service shell: PIR server process + client over TCP (counterpart of
``pir_tpu/service.py``), with the same opcodes, frames and wire messages,
so a client of either package talks to a service of either package.

Each logical PIR server (share holder) runs one PirService; the client
fans a query's shares out to two (or more) services and recovers
locally. Protocol privacy requires the services to be non-colluding, as
in the reference's threat model. Single-server protocols (cPIR under
Paillier, db.go:176-358) talk to one service only.

Served protocol families:
  * secret-shared index PIR (+ batched, + a serving stream), fast and
    compat DPF modes, and multi-party (>= 3 server) shares
  * keyword PIR via DPF over ``db.keywords`` (db.go:119-135)
  * keyword PIR via the sqrt search tree (keyword.go:76-90) and the BST
  * single-server cPIR, single-level and recursive (db.go:176-358)
  * ASPIR, the shared (audit) and the AHE (challenge / proof) variants

Frame format: u32 little-endian length ‖ u8 opcode ‖ payload.

The engine comes from ``config.PirConfig`` / ``pick_engine``: with no
config a service answers on a ``TorchPirServer`` on the card (and raises
when there is none); ``PirConfig(device="cpu")`` runs the same engine on
the CPU, ``PirConfig(engine="mesh", mesh_tp=, mesh_dp=)`` (or mesh_tp *
mesh_dp > 1) a ``MeshPirServer`` over a grid of devices (its serving
stream emulated by the shell, as in pir_tpu), ``PirConfig(engine="native")``
a ``NativePirServer`` (the C++/AES-NI host engine; its stream emulated
too), ``PirConfig(engine="host")`` the numpy golden model. The cPIR
scans and the AHE ASPIR proof checks' modexp batches run on the config's
device too (the card unless ``device="cpu"``), or with
``PirConfig(paillier_engine="native")`` on the native C++ engine, or with
``paillier_engine="python"`` in CPython on the host.
"""

from __future__ import annotations

import json
import secrets
import socket
import socketserver
import struct
import threading
import time

import numpy as np
import torch

from . import encrypted as enc
from . import server as srv
from . import wire
from .aspir import (
    auth_check,
    auth_prove,
    generate_auth_chal_for_query,
    new_authenticated_query,
)
from .aspir_shared import (
    generate_audit_for_shared_query_with_expanded_bits,
    new_authenticated_index_query_shares,
)
from .config import PirConfig, pick_engine
from .crypto.paillier import device_modexp, native_modexp
from .database import Database, DBMetadata
from .query import (
    QueryShare,
    SecretSharedQueryResult,
    new_index_query_shares,
    new_index_query_shares_batch,
    new_keyword_query_shares,
    new_keyword_query_shares_batch,
    recover,
)
from .parallel.mesh import MeshPirServer
from .server import TorchPirServer
from .slot import new_slot_from_string
from .utils.metrics import ServerMetrics, span_totals

OP_METADATA = 1
OP_QUERY = 2
OP_QUERY_BATCH = 3
OP_ENCRYPTED_QUERY = 4
OP_ENCRYPTED_QUERY_REC = 5
OP_SQRTST_META = 6
OP_METRICS = 7
# ASPIR (authenticated PIR, aspir.go; wire formats in wire.py)
OP_ASPIR_CHAL = 8
OP_ASPIR_PROOF = 9
OP_ASPIR_SHARED_QUERY = 10
OP_ASPIR_AUDIT_SUBMIT = 11
OP_ASPIR_AUDIT = 12
# PrivateBST keyword index (keyword.py; the reference's stated future
# work, keyword.go:14-16)
OP_BST_META = 13
OP_BST_LEVEL = 14
# steady-state serving stream (one-batch lag): SUBMIT dispatches a batch
# and returns the PREVIOUS batch's results (empty for the first); FLUSH
# drains the last batch and resets the stream. On the torch engine this
# rides TorchPirServer.fast_serving_stream; batches it refuses, and the
# host engine, emulate the lag so the wire contract is engine-independent.
OP_STREAM_SUBMIT = 15
OP_STREAM_FLUSH = 16

# batched shared-variant ASPIR: one frame and ONE audit rendezvous per
# batch; verdicts are per query (slot slices of the concatenated audit
# blob must XOR to zero individually)
OP_ASPIR_SHARED_QUERY_BATCH = 17
OP_ASPIR_AUDIT_SUBMIT_BATCH = 18
# a protocol-level REFUSAL (failed ASPIR audit/authentication), distinct
# from OP_ERROR so clients never have to classify by error text
OP_DENIED = 254
OP_ERROR = 255


def _send_frame(sock: socket.socket, opcode: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<IB", len(payload) + 1, opcode) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf.extend(chunk)
    return bytes(buf)


_MAX_FRAME = 1 << 30  # framing sanity bound, far above any real payload


def _recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length == 0 or length > _MAX_FRAME:
        # framing violation (no opcode byte / absurd length): orderly
        # close instead of IndexError/OOM escaping the handler
        raise struct.error(f"invalid frame length {length}")
    data = _recv_exact(sock, length)
    return data[0], data[1:]


def _pack_blobs(blobs: list[bytes]) -> bytes:
    """u32 count ‖ (u32 len ‖ blob)* — the batch container format."""
    return struct.pack("<I", len(blobs)) + b"".join(
        struct.pack("<I", len(b)) + b for b in blobs
    )


def _check_count(count: int, payload: bytes, off: int) -> None:
    """Bound a container count by the remaining frame (every element
    carries at least a u32 length prefix) — the service-level twin of
    wire._need (same corrupted-count DoS class)."""
    if count * 4 > len(payload) - off:
        raise ValueError("corrupt count field")


def _unpack_blobs(payload: bytes, off: int = 0) -> list[bytes]:
    """Inverse of _pack_blobs, starting at `off`."""
    (count,) = struct.unpack_from("<I", payload, off)
    off += 4
    _check_count(count, payload, off)
    blobs = []
    for _ in range(count):
        (ln,) = struct.unpack_from("<I", payload, off)
        off += 4
        blobs.append(bytes(payload[off:off + ln]))
        off += ln
    return blobs


def _decode_result_batch(op: int, payload: bytes):
    """Decode a batch-of-shared-results response frame (or raise the
    error it carries) — the one place the container format is parsed."""
    if op == OP_DENIED:
        raise PermissionError(payload.decode())
    if op == OP_ERROR:
        raise RuntimeError(payload.decode())
    return [wire.deserialize_shared_result(b) for b in _unpack_blobs(payload)]


class PirService:
    """One logical PIR server hosting a database share-answering endpoint.

    ``config`` selects the answer engine via ``pick_engine``: with none,
    ``PirConfig()``, a TorchPirServer on the card (pir_tpu's default is
    its host engine). ``sqrt_st`` additionally hosts a keyword sqrt search
    tree whose second layer doubles as the index-PIR database
    (keyword.go:34-90), ``bst`` a PrivateBST whose data layer does.
    """

    def __init__(self, db: Database | None = None, host: str = "127.0.0.1",
                 port: int = 0, config: PirConfig | None = None, sqrt_st=None,
                 key_db: Database | None = None,
                 audit_leader: tuple[str, int] | None = None,
                 audit_timeout: float = 30.0, bst=None):
        if db is None:
            if sqrt_st is not None:
                db = sqrt_st.second_layer
            elif bst is not None:
                db = bst.data_layer
            else:
                raise ValueError(
                    "need a Database, a PrivateSqrtST, or a PrivateBST"
                )
        self.db = db
        self.sqrt_st = sqrt_st
        self.bst = bst
        # ASPIR: parallel database of per-item auth keys (aspir.go:62-108,
        # 245-279). For the shared variant's audit exchange, one service
        # acts as audit leader (audit_leader=None); the others push their
        # audit shares to it and release data only on a pass verdict.
        self.key_db = key_db
        self.audit_leader = audit_leader
        self.audit_timeout = audit_timeout
        self._chal_lock = threading.Lock()
        self._chal_store: dict[int, tuple] = {}  # chal_id -> (auth_query, chal)
        self._chal_next = 1
        self._audit_cond = threading.Condition()
        self._audit_book: dict[int, dict] = {}  # nonce -> {shares, expected, verdict}
        self._audit_dead: dict[int, float] = {}  # timed-out nonce -> expiry
        self.config = (config or PirConfig()).validate()
        self.engine_name = pick_engine(self.config)
        self._engine: TorchPirServer | MeshPirServer | srv.NativePirServer | None = None
        if self.engine_name == "native":
            self._engine = srv.NativePirServer(db)
        elif self.engine_name == "torch":
            self._engine = TorchPirServer(
                db, device=self.config.device,
                min_device_nodes=self.config.min_device_nodes,
            )
        elif self.engine_name == "mesh":
            self._engine = MeshPirServer(
                db, tp=self.config.mesh_tp, dp=self.config.mesh_dp,
                compat_w=self.config.mesh_compat_w, device=self.config.device,
            )
        # the BST's level databases, each answered by an engine of its own
        self._bst_engines: dict[int, TorchPirServer | srv.NativePirServer] = {}
        self._bst_lock = threading.Lock()
        self.metrics = ServerMetrics()

        service = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                ctx: dict = {}  # per-connection state (serving streams)
                while True:
                    try:
                        opcode, payload = _recv_frame(self.request)
                    except (ConnectionError, struct.error):
                        return
                    try:
                        resp_op, resp = service._dispatch(opcode, payload, ctx)
                    except PermissionError as e:  # authentication refusal
                        resp_op, resp = OP_DENIED, str(e).encode()
                    except Exception as e:  # report errors to the client
                        resp_op, resp = OP_ERROR, str(e).encode()
                    _send_frame(self.request, resp_op, resp)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()

    # ---- engine dispatch ----

    def _answer(self, share: QueryShare) -> SecretSharedQueryResult:
        if self._engine is not None:
            return self._engine.private_secret_shared_query(share)
        return srv.private_secret_shared_query(self.db, share)

    @staticmethod
    def _batch_uniform(shares: list[QueryShare]) -> bool:
        """Engine batch paths require uniform 2-party shares of one kind;
        anything else (multi-party, mixed modes/group sizes) answers
        per-share so OP_QUERY_BATCH accepts everything OP_QUERY does."""
        s0 = shares[0]
        return all(
            s.is_two_party
            and s.group_size == s0.group_size
            and s.is_keyword_based == s0.is_keyword_based
            and (s.key_fast is not None) == (s0.key_fast is not None)
            for s in shares
        )

    @staticmethod
    def _batch_uniform_mp(shares: list[QueryShare]) -> bool:
        """A uniform multi-party (>= 3 server) batch of one kind."""
        s0 = shares[0]
        return all(
            not s.is_two_party
            and s.key_multi_party is not None
            and s.group_size == s0.group_size
            and s.is_keyword_based == s0.is_keyword_based
            and s.key_multi_party.num_parties == s0.key_multi_party.num_parties
            for s in shares
        )

    def _answer_batch(self, shares: list[QueryShare]) -> list[SecretSharedQueryResult]:
        """A uniform 2-party batch goes to the engine's batch API, and so
        does a uniform multi-party batch on an engine that takes one whole
        (``batch_accepts_multi_party``: the mesh's sharded point step);
        anything else (mixed kinds, the host engine) per share, so
        OP_QUERY_BATCH accepts everything OP_QUERY does."""
        if not shares:
            return []
        if self._engine is not None and (
                self._batch_uniform(shares)
                or (getattr(self._engine, "batch_accepts_multi_party", False)
                    and self._batch_uniform_mp(shares))):
            return self._engine.private_secret_shared_query_batch(shares)
        return [self._answer(s) for s in shares]

    def _bst_level_answer(self, level: int, share: QueryShare) -> SecretSharedQueryResult:
        """One BST level's boundary-key answer on the service's engine (a
        TorchPirServer a level, or on the native engine a NativePirServer,
        built at first use; or the host golden)."""
        level_db = self.bst.levels[level]
        if self._engine is None:
            return srv.private_secret_shared_query(level_db, share)
        with self._bst_lock:
            eng = self._bst_engines.get(level)
            if eng is None:
                eng = self._bst_engines[level] = (
                    srv.NativePirServer(level_db) if self.engine_name == "native"
                    else TorchPirServer(level_db, device=self.config.device,
                                        min_device_nodes=self.config.min_device_nodes))
        return eng.private_secret_shared_query(share)

    def _metadata_flags(self) -> int:
        flags = 0
        if getattr(self.db, "keywords", None) is not None:
            flags |= wire.META_HAS_KEYWORDS
        if self.sqrt_st is not None:
            flags |= wire.META_HAS_SQRT_ST
        if self.key_db is not None:
            flags |= wire.META_HAS_KEY_DB
        if self.bst is not None:
            flags |= wire.META_HAS_BST
        return flags

    # ---- ASPIR (authenticated PIR) ----

    def _require_key_db(self) -> Database:
        if self.key_db is None:
            raise ValueError("this service hosts no auth-key database")
        return self.key_db

    def _aspir_shared_answer(self, share):
        """Answer + audit share with ONE expansion: the audit reuses the
        data query's expanded bits (aspir.go:259-265 — the key insight
        that makes the shared audit nearly free). On the torch engine the
        bits come to the host once, for the key database's numpy scan."""
        qs = share.query_share
        if self._engine is not None:
            bits = self._engine.expand_shared_query(qs)
            res = self._engine.private_secret_shared_query_with_expanded_bits(
                qs, bits
            )
            # the torch engine's bits are a device tensor, the mesh's numpy
            bits_np = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor)
                                 else bits).astype(bool)
        else:
            bits_np = srv.expand_shared_query(self.db, qs)
            res = srv.private_secret_shared_query_with_expanded_bits(
                self.db, qs, bits_np
            )
        audit = generate_audit_for_shared_query_with_expanded_bits(
            self._require_key_db(), share, bits_np
        )
        return res, audit

    _AUDIT_PENDING = object()

    def _audit_acc(self, nonce: int, expected: int, share_bytes: bytes):
        """Audit-leader rendezvous: collect `expected` audit-share blobs
        for `nonce` and return their XOR accumulator (None on blob-length
        mismatch). Every submitting party blocks until the accumulator is
        known; verdicts are derived by the callers (whole-blob for single
        queries, per-slot-slice for batches).

        A nonce whose rendezvous timed out is tombstoned for
        2*audit_timeout so a straggler fails fast instead of opening an
        orphan book; retries of a timed-out audit must therefore use a
        FRESH nonce (PirClient draws one per query/batch)."""
        deadline = time.monotonic() + self.audit_timeout
        with self._audit_cond:
            # a share arriving after a co-waiter already timed this nonce
            # out would open a fresh book no one else will ever join —
            # fail it fast instead of stalling a second full timeout
            now = time.monotonic()
            self._audit_dead = {k: v for k, v in self._audit_dead.items()
                                if v > now}
            if nonce in self._audit_dead:
                raise TimeoutError(
                    "audit incomplete: rendezvous already timed out"
                )
            book = self._audit_book.setdefault(
                nonce,
                {"shares": [], "acc": self._AUDIT_PENDING, "readers": 0},
            )
            book["shares"].append(share_bytes)
            if len(book["shares"]) == expected:
                if len({len(s) for s in book["shares"]}) == 1:
                    acc = bytearray(len(share_bytes))
                    for s in book["shares"]:
                        for i, b in enumerate(s):
                            acc[i] ^= b
                    book["acc"] = bytes(acc)
                else:
                    book["acc"] = None
                self._audit_cond.notify_all()
            while book["acc"] is self._AUDIT_PENDING:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._audit_book.pop(nonce, None)
                    self._audit_dead[nonce] = (
                        time.monotonic() + 2 * self.audit_timeout
                    )
                    raise TimeoutError(
                        "audit incomplete: not all servers submitted shares"
                    )
                self._audit_cond.wait(remaining)
            acc = book["acc"]
            book["readers"] += 1
            if book["readers"] >= expected:
                self._audit_book.pop(nonce, None)
        return acc

    def _audit_verdict(self, nonce: int, expected: int, share_bytes: bytes) -> int:
        """Verdict = 1 iff all servers' audit shares XOR to zero
        (aspir.go:281-295)."""
        acc = self._audit_acc(nonce, expected, share_bytes)
        return 1 if (acc is not None and not any(acc)) else 0

    def _audit_verdict_vec(self, nonce: int, expected: int, blob: bytes,
                           q: int, slot_len: int) -> bytes:
        """Per-query verdict bitmap for a BATCH audit: each server's blob
        is its Q concatenated audit-share slots (one rendezvous per
        batch); query i passes iff its slot slice XORs to zero across
        servers."""
        acc = self._audit_acc(nonce, expected, blob)
        if acc is None or len(acc) != q * slot_len:
            return bytes(q)
        return bytes(
            0 if any(acc[i * slot_len:(i + 1) * slot_len]) else 1
            for i in range(q)
        )

    def _submit_audit_to_leader(self, nonce: int, expected: int, audit) -> int:
        payload = (struct.pack("<QB", nonce, expected)
                   + wire.serialize_audit_share(audit))
        with socket.create_connection(self.audit_leader,
                                      timeout=self.audit_timeout) as sock:
            _send_frame(sock, OP_ASPIR_AUDIT_SUBMIT, payload)
            op, resp = _recv_frame(sock)
        if op == OP_ERROR:
            raise RuntimeError(f"audit leader error: {resp.decode()}")
        return resp[0]

    def _submit_audit_batch_to_leader(self, nonce: int, expected: int,
                                      q: int, slot_len: int,
                                      blob: bytes) -> bytes:
        payload = struct.pack("<QBIH", nonce, expected, q, slot_len) + blob
        with socket.create_connection(self.audit_leader,
                                      timeout=self.audit_timeout) as sock:
            _send_frame(sock, OP_ASPIR_AUDIT_SUBMIT_BATCH, payload)
            op, resp = _recv_frame(sock)
        if op == OP_ERROR:
            raise RuntimeError(f"audit leader error: {resp.decode()}")
        if len(resp) != q:
            raise RuntimeError("audit leader returned a malformed bitmap")
        return resp

    def apply_updates(self, updates: dict[int, bytes]) -> None:
        """Live slot updates on a running service (admin plane — an
        in-process operator call, deliberately not a wire opcode: the
        query protocol must not let clients mutate the table). Engines
        holding device-resident tables patch them in place
        (TorchPirServer.apply_updates, MeshPirServer.apply_updates); the
        host and native engines read db.data at scan time, so the rows swap
        copy-on-write —
        in-flight scans finish on the old buffer and never see a torn
        row."""
        eng = self._engine
        if eng is not None and hasattr(eng, "apply_updates"):
            eng.apply_updates(updates)
        else:
            self.db.update_slots(updates, copy_on_write=True)

    @staticmethod
    def _parse_share_batch(payload: bytes) -> list[QueryShare]:
        # payload: u32 count ‖ (u32 len ‖ share)*
        return [wire.deserialize_query_share(b) for b in _unpack_blobs(payload)]

    @staticmethod
    def _pack_results(results: list[SecretSharedQueryResult]) -> bytes:
        return _pack_blobs([wire.serialize_shared_result(r) for r in results])

    def _stream_submit(self, ctx: dict, shares: list[QueryShare]) -> bytes:
        """One serving-stream step: dispatch `shares`, answer the batch
        submitted on the previous step (one-batch lag, see OP_STREAM_*)."""
        if not shares:
            raise ValueError("empty stream batch")
        st = ctx.get("stream")
        if st is None:
            st = ctx["stream"] = {"mode": None, "obj": None, "pending": None}
        scan = self.db.db_size * self.db.slot_bytes
        if st["mode"] is None:
            # decide once per stream: the engine's stream when it takes
            # the batch, else shell emulation. Only the stream's refusal
            # of the batch (ValueError: compat, keyword, mixed or shallow
            # shares) falls through; a kernel that fails to build or
            # launch raises on to the client as OP_ERROR. The mesh engine
            # has no stream (as in pir_tpu): emulated.
            if isinstance(self._engine, TorchPirServer):
                stream = self._engine.fast_serving_stream()
                try:
                    stream.submit(shares)  # validates, dispatches, drains nothing
                except ValueError:
                    stream = None
                if stream is not None:
                    st["mode"], st["obj"] = "device", stream
                    st["pending"] = len(shares)
                    return self._pack_results([])
            st["mode"] = "emul"
        if st["mode"] == "device":
            fut = st["obj"].submit(shares)
            n_prev, st["pending"] = st["pending"], len(shares)
            with self.metrics.timed_query(n_prev * scan, n=n_prev):
                results = fut()
            return self._pack_results(results)
        prev, st["pending"] = st["pending"], shares
        if prev is None:
            return self._pack_results([])
        with self.metrics.timed_query(len(prev) * scan, n=len(prev)):
            results = self._answer_batch(prev)
        return self._pack_results(results)

    def _stream_flush(self, ctx: dict) -> bytes:
        st = ctx.pop("stream", None)
        if st is None or st["pending"] is None:
            return self._pack_results([])
        scan = self.db.db_size * self.db.slot_bytes
        if st["mode"] == "device":
            fut, n_prev = st["obj"].flush(), st["pending"]
            with self.metrics.timed_query(n_prev * scan, n=n_prev):
                results = fut()
            return self._pack_results(results)
        prev = st["pending"]
        with self.metrics.timed_query(len(prev) * scan, n=len(prev)):
            results = self._answer_batch(prev)
        return self._pack_results(results)

    def _dispatch(self, opcode: int, payload: bytes,
                  ctx: dict | None = None) -> tuple[int, bytes]:
        scan = self.db.db_size * self.db.slot_bytes
        if opcode == OP_METADATA:
            return OP_METADATA, wire.serialize_metadata(
                self.db.slot_bytes, self.db.db_size, self._metadata_flags()
            )
        if opcode == OP_QUERY_BATCH:
            shares = self._parse_share_batch(payload)
            with self.metrics.timed_query(len(shares) * scan, n=len(shares)):
                results = self._answer_batch(shares)
            return OP_QUERY_BATCH, self._pack_results(results)
        if opcode == OP_STREAM_SUBMIT:
            if ctx is None:
                raise ValueError("serving streams need a connection context")
            return OP_STREAM_SUBMIT, self._stream_submit(
                ctx, self._parse_share_batch(payload)
            )
        if opcode == OP_STREAM_FLUSH:
            if ctx is None:
                raise ValueError("serving streams need a connection context")
            return OP_STREAM_FLUSH, self._stream_flush(ctx)
        if opcode == OP_QUERY:
            share = wire.deserialize_query_share(payload)
            with self.metrics.timed_query(scan):
                res = self._answer(share)
            return OP_QUERY, wire.serialize_shared_result(res)
        if opcode == OP_ENCRYPTED_QUERY:
            q = wire.deserialize_encrypted_query(payload)
            # the torch engine answers through the service's TorchPirServer,
            # whose exponent matrix stays on its device
            server = self._engine if isinstance(self._engine, TorchPirServer) else None
            with self.metrics.timed_query(scan):
                res = enc.private_encrypted_query(
                    self.db, q, engine=self.config.paillier_engine,
                    device=self.config.device, server=server,
                )
            return OP_ENCRYPTED_QUERY, wire.serialize_encrypted_result(res)
        if opcode == OP_ENCRYPTED_QUERY_REC:
            q = wire.deserialize_doubly_encrypted_query(payload)
            with self.metrics.timed_query(scan):
                res = enc.private_doubly_encrypted_query(
                    self.db, q, engine=self.config.paillier_engine,
                    device=self.config.device,
                )
            return OP_ENCRYPTED_QUERY_REC, wire.serialize_doubly_encrypted_result(res)
        if opcode == OP_ASPIR_CHAL:
            # u32 secparam ‖ AuthenticatedEncryptedQuery. The challenge
            # and query are retained server-side under chal_id so the
            # proof is checked against OUR challenge, not one the client
            # claims (aspir.go:62-108 keeps this state in-process).
            (secparam,) = struct.unpack_from("<I", payload, 0)
            q = wire.deserialize_auth_query(payload[4:])
            chal = generate_auth_chal_for_query(
                secparam, self._require_key_db(), q,
                engine=self.config.paillier_engine, device=self.config.device,
            )
            with self._chal_lock:
                chal_id = self._chal_next
                self._chal_next += 1
                self._chal_store[chal_id] = (q, chal)
                while len(self._chal_store) > 256:  # bound retained state
                    self._chal_store.pop(next(iter(self._chal_store)))
            return OP_ASPIR_CHAL, (struct.pack("<Q", chal_id)
                                   + wire.serialize_chal_token(chal))
        if opcode == OP_ASPIR_PROOF:
            # u64 chal_id ‖ ProofToken -> u8 pass ‖ data result. Only the
            # PROVEN query side is answered: a client whose auth key is
            # wrong can only prove the decoy (null) side and so retrieves
            # the null answer — this is what makes the AHE flow sound.
            (chal_id,) = struct.unpack_from("<Q", payload, 0)
            proof = wire.deserialize_proof_token(bytes(payload[8:]))
            with self._chal_lock:
                entry = self._chal_store.pop(chal_id, None)
            if entry is None:
                raise ValueError("unknown or expired challenge id")
            q, chal = entry
            # the DDLEQ check's modexp batches follow the cPIR engine
            # (equal verdicts either way), in this handler's thread only
            engine = enc.scan_engine(self.config.paillier_engine)
            with device_modexp(engine == "torch", self.config.device), \
                    native_modexp(engine == "native"):
                ok = auth_check(q.query0.row.pk, q, chal, proof)
            if not ok:
                return OP_ASPIR_PROOF, struct.pack("<B", 0)
            dq = q.query0 if proof.q_bit == 0 else q.query1
            with self.metrics.timed_query(scan):
                res = enc.private_doubly_encrypted_query(
                    self.db, dq, engine=self.config.paillier_engine,
                    device=self.config.device,
                )
            return OP_ASPIR_PROOF, (
                struct.pack("<B", 1) + wire.serialize_doubly_encrypted_result(res)
            )
        if opcode == OP_ASPIR_AUDIT:
            # library-parity endpoint: compute and return the audit share
            # (the exchange is left to the deployment, matching the
            # reference's in-process CheckAudit posture)
            share = wire.deserialize_auth_share(payload)
            _, audit = self._aspir_shared_answer(share)
            return OP_ASPIR_AUDIT, wire.serialize_audit_share(audit)
        if opcode == OP_ASPIR_AUDIT_SUBMIT:
            nonce, expected = struct.unpack_from("<QB", payload, 0)
            audit = wire.deserialize_audit_share(bytes(payload[9:]))
            verdict = self._audit_verdict(nonce, expected, bytes(audit.t.data))
            return OP_ASPIR_AUDIT_SUBMIT, struct.pack("<B", verdict)
        if opcode == OP_ASPIR_SHARED_QUERY:
            # u64 nonce ‖ u8 num_servers ‖ AuthenticatedQueryShare.
            # The data answer is released ONLY after the servers'
            # audit-share exchange (via the leader) passes; the client
            # never relays audit shares, so it cannot forge the release.
            nonce, expected = struct.unpack_from("<QB", payload, 0)
            share = wire.deserialize_auth_share(bytes(payload[9:]))
            with self.metrics.timed_query(scan):
                res, audit = self._aspir_shared_answer(share)
            if self.audit_leader is None:
                verdict = self._audit_verdict(
                    nonce, expected, bytes(audit.t.data)
                )
            else:
                verdict = self._submit_audit_to_leader(nonce, expected, audit)
            if not verdict:
                raise PermissionError(
                    "audit failed: auth key does not match the queried item"
                )
            return OP_ASPIR_SHARED_QUERY, wire.serialize_shared_result(res)
        if opcode == OP_ASPIR_SHARED_QUERY_BATCH:
            # u64 nonce ‖ u8 num_servers ‖ packed AuthenticatedQueryShares.
            # ONE audit rendezvous covers the batch (each server submits
            # its Q concatenated audit slots under one nonce); data for
            # query i is released only if ITS slot slices XOR to zero —
            # per-query soundness, batch-level round trips.
            nonce, expected = struct.unpack_from("<QB", payload, 0)
            shares = [wire.deserialize_auth_share(b)
                      for b in _unpack_blobs(payload, 9)]
            if not shares:
                raise ValueError("empty authenticated batch")
            outs, audits = [], []
            with self.metrics.timed_query(len(shares) * scan,
                                          n=len(shares)):
                for share in shares:
                    res, audit = self._aspir_shared_answer(share)
                    outs.append(res)
                    audits.append(bytes(audit.t.data))
            slot_len = len(audits[0])
            if any(len(a) != slot_len for a in audits):
                raise ValueError("non-uniform audit share sizes in batch")
            blob = b"".join(audits)
            if self.audit_leader is None:
                verdicts = self._audit_verdict_vec(
                    nonce, expected, blob, len(shares), slot_len
                )
            else:
                verdicts = self._submit_audit_batch_to_leader(
                    nonce, expected, len(shares), slot_len, blob
                )
            items = [
                (b"\x01" + wire.serialize_shared_result(r)) if v else b"\x00"
                for r, v in zip(outs, verdicts)
            ]
            return OP_ASPIR_SHARED_QUERY_BATCH, _pack_blobs(items)
        if opcode == OP_ASPIR_AUDIT_SUBMIT_BATCH:
            # u64 nonce ‖ u8 expected ‖ u32 q ‖ u16 slot_len ‖ blob
            nonce, expected, qn, slot_len = struct.unpack_from(
                "<QBIH", payload, 0
            )
            blob = bytes(payload[15:])
            # slot_len/qn are attacker-chosen: zero-size slots with a
            # huge qn would pass a product-only check and drive a
            # 2^32-iteration bitmap build (the corrupted-count DoS class)
            if slot_len == 0 or qn == 0 or len(blob) != qn * slot_len:
                raise ValueError("malformed batch audit blob")
            return OP_ASPIR_AUDIT_SUBMIT_BATCH, self._audit_verdict_vec(
                nonce, expected, blob, qn, slot_len
            )
        if opcode == OP_BST_META:
            if self.bst is None:
                raise ValueError("this service hosts no BST keyword index")
            return OP_BST_META, wire.serialize_bst_meta(self.bst)
        if opcode == OP_BST_LEVEL:
            # u32 level ‖ QueryShare -> shared result over that level's
            # (tiny) boundary database
            if self.bst is None:
                raise ValueError("this service hosts no BST keyword index")
            (level,) = struct.unpack_from("<I", payload, 0)
            if level >= self.bst.depth:
                raise ValueError(f"level {level} out of range")
            share = wire.deserialize_query_share(bytes(payload[4:]))
            res = self._bst_level_answer(level, share)
            return OP_BST_LEVEL, wire.serialize_shared_result(res)
        if opcode == OP_SQRTST_META:
            if self.sqrt_st is None:
                raise ValueError("this service hosts no sqrt search tree")
            return OP_SQRTST_META, wire.serialize_sqrt_st_meta(self.sqrt_st)
        if opcode == OP_METRICS:
            summary = dict(self.metrics.summary(), engine=self.engine_name,
                           spans=span_totals())
            return OP_METRICS, json.dumps(summary).encode()
        raise ValueError(f"unknown opcode {opcode}")


class _AllLocks:
    """Context manager acquiring a list of locks in fixed order."""

    def __init__(self, locks):
        self._locks = locks

    def __enter__(self):
        for lk in self._locks:
            lk.acquire()
        return self

    def __exit__(self, *exc):
        for lk in reversed(self._locks):
            lk.release()
        return False


class PirClient:
    """Client of N non-colluding PIR services.

    Single-server flows (cPIR, metrics) address one service by index;
    secret-shared flows fan shares out to all of them.
    """

    def __init__(self, addresses: list[tuple[str, int]]):
        self._socks = []
        for host, port in addresses:
            s = socket.create_connection((host, port))
            self._socks.append(s)
        # per-socket locks: independent single-server RPCs to different
        # servers may overlap; fan-outs take every lock (in index order)
        # so frames on one socket never interleave
        self._sock_locks = [threading.Lock() for _ in self._socks]
        self._lock = _AllLocks(self._sock_locks)
        self._sqrt_st = None
        self.metadata, self.db_flags = self._fetch_metadata()

    def _rpc(self, sock_idx: int, opcode: int, payload: bytes) -> bytes:
        with self._sock_locks[sock_idx]:
            sock = self._socks[sock_idx]
            _send_frame(sock, opcode, payload)
            op, resp = _recv_frame(sock)
        if op == OP_DENIED:
            raise PermissionError(resp.decode())
        if op == OP_ERROR:
            raise RuntimeError(resp.decode())
        if op != opcode:
            raise RuntimeError(f"expected opcode {opcode}, got {op}")
        return resp

    def _fetch_metadata(self) -> tuple[DBMetadata, int]:
        resp = self._rpc(0, OP_METADATA, b"")
        slot_bytes, db_size, flags = wire.deserialize_metadata(resp)
        return DBMetadata(slot_bytes, db_size), flags

    # ---- secret-shared index PIR ----

    def query_index(self, index: int, group_size: int = 1, fast: bool = False,
                    leaf_bits: int | None = None):
        """Full private retrieval: keygen, fan out shares, recover.
        leaf_bits (fast mode only) widens the early-termination leaves
        (dpf/host.py wide-leaf note: ~3x less server AES at 1024)."""
        shares = new_index_query_shares(
            self.metadata, index, group_size, fast=fast, leaf_bits=leaf_bits,
            num_shares=len(self._socks),
        )
        return self._fan_out_recover(shares)

    def _fan_out_recover(self, shares: list[QueryShare]):
        results = []
        with self._lock:
            for sock, share in zip(self._socks, shares):
                _send_frame(sock, OP_QUERY, wire.serialize_query_share(share))
            for sock in self._socks:
                op, payload = _recv_frame(sock)
                if op == OP_DENIED:
                    raise PermissionError(payload.decode())
                if op == OP_ERROR:
                    raise RuntimeError(payload.decode())
                results.append(wire.deserialize_shared_result(payload))
        return recover(results)

    def query_index_batch(self, indices: list[int], group_size: int = 1,
                          fast: bool = True, leaf_bits: int | None = None):
        """Batched retrieval: one round trip per server for all indices.
        Fast-mode keygen runs vectorised over the whole batch; leaf_bits
        widens the fast leaves (clamped per height)."""
        share_lists = new_index_query_shares_batch(
            self.metadata, list(indices), group_size, fast=fast,
            leaf_bits=leaf_bits, num_shares=len(self._socks),
        )
        return self._fan_out_recover_batch(share_lists)

    def _fan_out_recover_batch(self, share_lists):
        """One OP_QUERY_BATCH round trip per server; recover per query."""
        per_server: list[list[bytes]] = [[] for _ in self._socks]
        for shares in share_lists:
            for k, share in enumerate(shares):
                per_server[k].append(wire.serialize_query_share(share))
        answers = []
        with self._lock:
            for sock, blobs in zip(self._socks, per_server):
                _send_frame(sock, OP_QUERY_BATCH, _pack_blobs(blobs))
            for sock in self._socks:
                answers.append(self._recv_result_batch(sock))
        return [
            recover([answers[k][i] for k in range(len(self._socks))])
            for i in range(len(share_lists))
        ]

    @staticmethod
    def _recv_result_batch(sock) -> list[SecretSharedQueryResult]:
        return _decode_result_batch(*_recv_frame(sock))

    def open_stream(self, group_size: int = 1) -> "PirClientStream":
        """Open a steady-state serving stream (OP_STREAM_*): each submit
        dispatches a batch and returns the PREVIOUS batch's recovered
        slots, so the servers overlap batch k's scan with batch k+1's
        arrival. One stream
        per client at a time; batches must keep one size."""
        return PirClientStream(self, group_size)

    # ---- keyword PIR ----

    def query_keyword_dpf_batch(self, keywords: list[int],
                                group_size: int = 1):
        """Batched keyword-DPF retrieval: vectorised keygen, one round
        trip per server (server side routes through the batched keyword
        expansion)."""
        if not (self.db_flags & wire.META_HAS_KEYWORDS):
            raise RuntimeError("service database has no keyword column")
        share_lists = new_keyword_query_shares_batch(
            self.metadata, list(keywords), group_size, len(self._socks)
        )
        return self._fan_out_recover_batch(share_lists)

    def query_keyword_dpf(self, keyword: int, group_size: int = 1):
        """Keyword PIR via DPF over the server's keyword column
        (db.go:119-135): shares select the row whose keyword matches."""
        if not (self.db_flags & wire.META_HAS_KEYWORDS):
            raise RuntimeError("service database has no keyword column")
        shares = new_keyword_query_shares(
            self.metadata, keyword, group_size, len(self._socks)
        )
        return self._fan_out_recover(shares)

    def sqrt_st_meta(self):
        """Fetch (and cache) the hosted sqrt search tree's first layer."""
        if self._sqrt_st is None:
            if not (self.db_flags & wire.META_HAS_SQRT_ST):
                raise RuntimeError("service hosts no sqrt search tree")
            self._sqrt_st = wire.deserialize_sqrt_st_meta(
                self._rpc(0, OP_SQRTST_META, b"")
            )
        return self._sqrt_st

    def bst_meta(self):
        """Fetch (and cache) the hosted BST's geometry (depth, N, slot)."""
        if getattr(self, "_bst_meta", None) is None:
            if not (self.db_flags & wire.META_HAS_BST):
                raise RuntimeError("service hosts no BST keyword index")
            self._bst_meta = wire.deserialize_bst_meta(
                self._rpc(0, OP_BST_META, b"")
            )
        return self._bst_meta

    def _bst_level_query(self, level: int, node: int, slot_bytes: int):
        """One PIR query against the 2^level boundary DB of every server."""
        md = DBMetadata(slot_bytes, 1 << level)
        shares = new_index_query_shares(md, node, 1, num_shares=len(self._socks))
        resps = []
        with self._lock:
            for sock, share in zip(self._socks, shares):
                _send_frame(sock, OP_BST_LEVEL,
                            struct.pack("<I", level)
                            + wire.serialize_query_share(share))
            for sock in self._socks:
                resps.append(_recv_frame(sock))
        for op, p in resps:
            if op == OP_ERROR:
                raise RuntimeError(p.decode())
        return recover([wire.deserialize_shared_result(p) for _, p in resps])

    def query_keyword_bst(self, key: str, fast: bool = True):
        """Keyword lookup via the hosted PrivateBST (the reference's
        stated future work, keyword.go:14-16): one single-slot PIR query
        per level — O(slot * log N) bandwidth, no cleartext boundary
        keys — then one data query. Returns (present, index, slot).

        Privacy: every level query is an independent PIR query and the
        one-query-per-level pattern is data-independent."""
        depth, _, slot_bytes = self.bst_meta()
        probe = new_slot_from_string(key, slot_bytes)
        node = 0
        for lvl in range(depth):
            boundary = self._bst_level_query(lvl, node, slot_bytes)[0]
            bit = 0 if boundary.compare(probe) < 0 else 1  # descending order
            node = 2 * node + bit
        slots = self.query_index(node, fast=fast)
        present = slots[0].equal(probe)
        return present, node, slots[0]

    def query_keyword(self, key: str, fast: bool = True):
        """Keyword lookup via the hosted sqrt search tree (keyword.go:76-90
        + the client flow of keyword_test.go:58-95).

        Returns (present, global_index, row_slots): one index-PIR query
        with group_size = tree height retrieves the whole candidate
        bucket; the bucket choice leaks only the first-layer boundary
        interval, exactly as in the reference design.
        """
        st = self.sqrt_st_meta()
        row = st.find_bucket(key)
        slots = self.query_index(row, group_size=st.height, fast=fast)
        col = st.find_in_row(slots, key)
        probe = new_slot_from_string(key, len(slots[col].data))
        present = slots[col].equal(probe)
        return present, row * st.width + col, slots

    # ---- ASPIR (authenticated PIR) ----

    def query_index_authenticated(self, index: int, auth_key,
                                  group_size: int = 1, fast: bool = False):
        """Shared-variant authenticated retrieval (aspir.go:211-295) over
        real sockets: every server computes an audit share from the SAME
        expanded bits as the data answer and exchanges it with the audit
        leader; data is released only if the shares XOR to zero. Raises
        PermissionError when the auth key does not match the item."""
        if not (self.db_flags & wire.META_HAS_KEY_DB):
            raise RuntimeError("services host no auth-key database")
        shares = new_authenticated_index_query_shares(
            self.metadata, index, auth_key, group_size, len(self._socks),
            fast=fast,
        )
        nonce = secrets.randbits(64)
        n = len(self._socks)
        resps = []
        with self._lock:
            for sock, share in zip(self._socks, shares):
                payload = (struct.pack("<QB", nonce, n)
                           + wire.serialize_auth_share(share))
                _send_frame(sock, OP_ASPIR_SHARED_QUERY, payload)
            for sock in self._socks:
                resps.append(_recv_frame(sock))
        # only an actual audit refusal (OP_DENIED) is an authentication
        # failure; timeouts / internal faults must not read as "wrong key"
        refusals = [p.decode() for op, p in resps if op == OP_DENIED]
        if refusals:
            raise PermissionError(refusals[0])
        errors = [p.decode() for op, p in resps if op == OP_ERROR]
        if errors:
            raise RuntimeError(errors[0])
        return recover([wire.deserialize_shared_result(p) for _, p in resps])

    def query_index_authenticated_batch(self, indices: list[int], auth_keys,
                                        group_size: int = 1,
                                        fast: bool = False,
                                        strict: bool = True):
        """Batched shared-variant authenticated retrieval: ONE frame and
        ONE audit rendezvous per server for the whole batch, with
        per-query verdicts (each query's audit slots must XOR to zero
        individually — aspir.go:281-295 applied slot-wise). strict=True
        raises PermissionError if any query's audit fails; strict=False
        returns None at the failed positions instead."""
        if not (self.db_flags & wire.META_HAS_KEY_DB):
            raise RuntimeError("services host no auth-key database")
        if len(indices) != len(auth_keys):
            raise ValueError("indices and auth_keys must align")
        n = len(self._socks)
        share_lists = [
            new_authenticated_index_query_shares(
                self.metadata, idx, key, group_size, n, fast=fast
            )
            for idx, key in zip(indices, auth_keys)
        ]
        nonce = secrets.randbits(64)
        head = struct.pack("<QB", nonce, n)
        per_server = [
            head + _pack_blobs([wire.serialize_auth_share(sl[k])
                                for sl in share_lists])
            for k in range(n)
        ]
        resps = []
        with self._lock:
            for sock, payload in zip(self._socks, per_server):
                _send_frame(sock, OP_ASPIR_SHARED_QUERY_BATCH, payload)
            for sock in self._socks:
                resps.append(_recv_frame(sock))
        refusals = [p.decode() for op, p in resps if op == OP_DENIED]
        if refusals:
            raise PermissionError(refusals[0])
        errors = [p.decode() for op, p in resps if op == OP_ERROR]
        if errors:
            raise RuntimeError(errors[0])
        per_server_items = [_unpack_blobs(p) for _, p in resps]
        out, failed = [], []
        for i in range(len(indices)):
            items = [srv_items[i] for srv_items in per_server_items]
            if any(it[:1] != b"\x01" for it in items):
                failed.append(i)
                out.append(None)
                continue
            out.append(recover([
                wire.deserialize_shared_result(it[1:]) for it in items
            ]))
        if failed and strict:
            raise PermissionError(
                f"audit failed for {len(failed)} of {len(indices)} "
                f"queries (positions {failed})"
            )
        return out

    def fetch_audit_shares(self, index: int, auth_key, group_size: int = 1,
                           fast: bool = False):
        """Library-parity flow: fetch each server's AuditTokenShare for an
        authenticated query (the caller runs check_audit; matches the
        reference's in-process posture, aspir.go:245-295)."""
        shares = new_authenticated_index_query_shares(
            self.metadata, index, auth_key, group_size, len(self._socks),
            fast=fast,
        )
        return [
            wire.deserialize_audit_share(
                self._rpc(k, OP_ASPIR_AUDIT, wire.serialize_auth_share(s))
            )
            for k, s in enumerate(shares)
        ]

    def query_authenticated(self, index: int, sk, auth_key,
                            group_size: int = 1, secparam: int = 8,
                            server: int = 0):
        """Single-server AHE authenticated retrieval (aspir.go:10-209,
        4-message flow of SURVEY §3.4) against ONE service hosting both
        the data DB and the auth-key DB. Returns the group's slots.

        Raises PermissionError if authentication fails — including the
        case where only the decoy side could be proven (wrong auth key:
        the server then answers the null query, so there is nothing to
        recover), and ValueError if the server itself cheats on the
        challenge (both tokens non-zero, aspir.go:124-126)."""
        if not (self.db_flags & wire.META_HAS_KEY_DB):
            raise RuntimeError("service hosts no auth-key database")
        q, state = new_authenticated_query(
            self.metadata, sk, group_size, index, auth_key
        )
        resp = self._rpc(server, OP_ASPIR_CHAL,
                         struct.pack("<I", secparam) + wire.serialize_auth_query(q))
        (chal_id,) = struct.unpack_from("<Q", resp, 0)
        chal = wire.deserialize_chal_token(resp[8:])
        proof = auth_prove(state, chal)
        resp = self._rpc(server, OP_ASPIR_PROOF,
                         struct.pack("<Q", chal_id)
                         + wire.serialize_proof_token(proof))
        if resp[0] != 1:
            raise PermissionError("server rejected the authentication proof")
        if proof.q_bit != state.bit:
            # only the decoy was provable => our auth key is wrong; the
            # server answered the null query (sound by construction)
            raise PermissionError(
                "auth key does not match the queried item (decoy proven)"
            )
        res = wire.deserialize_doubly_encrypted_result(resp[1:], sk.public_key)
        return enc.recover_doubly_encrypted(res, sk)

    # ---- single-server cPIR (Paillier) ----

    def query_encrypted(self, row_index: int, sk, pk, group_size: int = 1,
                        server: int = 0):
        """Single-level cPIR (db.go:176-271): retrieves one whole grid row
        from ONE server; returns the row's slots."""
        q = enc.new_encrypted_query(self.metadata, pk, group_size, row_index)
        resp = self._rpc(server, OP_ENCRYPTED_QUERY,
                         wire.serialize_encrypted_query(q))
        res = wire.deserialize_encrypted_result(resp, pk)
        return enc.recover_encrypted(res, sk)

    def query_encrypted_recursive(self, index: int, sk, pk,
                                  group_size: int = 1, server: int = 0):
        """Recursive (doubly-encrypted) cPIR (db.go:273-358): retrieves
        just the group at `index` with O(sqrt N) upload."""
        q = enc.new_doubly_encrypted_query(self.metadata, pk, group_size, index)
        resp = self._rpc(server, OP_ENCRYPTED_QUERY_REC,
                         wire.serialize_doubly_encrypted_query(q))
        res = wire.deserialize_doubly_encrypted_result(resp, pk)
        return enc.recover_doubly_encrypted(res, sk)

    # ---- observability ----

    def get_metrics(self, server: int = 0) -> dict:
        return json.loads(self._rpc(server, OP_METRICS, b""))

    def close(self):
        for s in self._socks:
            s.close()


class PirClientStream:
    """Client half of the OP_STREAM_* serving stream (one-batch lag).

    submit(indices) fans a fast-mode batch to every server and returns
    the PREVIOUS batch's recovered slots (None for the first submit);
    flush() drains the last batch. While the client recovers batch k-1
    and builds batch k+1, the servers' devices answer batch k.
    """

    def __init__(self, client: PirClient, group_size: int = 1):
        self._c = client
        self._g = group_size
        self._n_prev = None

    def _fan_out(self, opcode: int, payloads) -> list[list]:
        c = self._c
        with c._lock:
            for sock, payload in zip(c._socks, payloads):
                _send_frame(sock, opcode, payload)
            # drain every socket BEFORE decoding, so a per-server error
            # (e.g. a shape-mismatch refusal) never leaves another
            # socket's response buffered and the connections desynced
            frames = [_recv_frame(sock) for sock in c._socks]
        return [_decode_result_batch(op, payload) for op, payload in frames]

    def _recover(self, answers: list[list], n: int):
        c = self._c
        return [
            recover([answers[k][i] for k in range(len(c._socks))])
            for i in range(n)
        ]

    def submit(self, indices: list[int]):
        """Dispatch a batch of indices; returns the previous batch's
        recovered slot lists (one per query), or None on the first call."""
        c = self._c
        share_lists = new_index_query_shares_batch(
            c.metadata, list(indices), self._g, fast=True, num_shares=len(c._socks)
        )
        per_server = [[] for _ in c._socks]
        for shares in share_lists:
            for k, share in enumerate(shares):
                per_server[k].append(wire.serialize_query_share(share))
        answers = self._fan_out(
            OP_STREAM_SUBMIT, [_pack_blobs(blobs) for blobs in per_server]
        )
        n_prev, self._n_prev = self._n_prev, len(share_lists)
        if n_prev is None:
            if any(a for a in answers):
                raise RuntimeError("first stream submit returned results")
            return None
        return self._recover(answers, n_prev)

    def flush(self):
        """Drain the stream; returns the last batch's recovered slot
        lists, or None if the stream is empty. The stream is reusable
        afterwards (the next submit starts a fresh one)."""
        if self._n_prev is None:
            return None
        answers = self._fan_out(
            OP_STREAM_FLUSH, [b""] * len(self._c._socks)
        )
        n_prev, self._n_prev = self._n_prev, None
        return self._recover(answers, n_prev)
