"""Random-oracle commitments (counterpart of ``pir_tpu/commitment.py``;
reference: commitment.go), copied as it is.

**Deliberate divergence from the reference:** the reference's
``RandomOracleDigest`` skips its first argument (commitment.go:47-49), so
``Commit(value)`` hashes only the blinding factor ``r`` — the commitment
is not binding, and the ``CheckOpen`` in AuthCheck (aspir.go:189-191) is
vacuous. Here the digest covers value ‖ r, making the commitment binding
as evidently intended; see aspir.py for the corresponding AuthCheck fix.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass


def _int_bytes(v: int) -> bytes:
    return v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")


def random_oracle_digest(*values: int) -> bytes:
    """SHA-256 over all values (length-prefixed; fixes commitment.go:43-53)."""
    h = hashlib.sha256()
    for v in values:
        b = _int_bytes(v)
        h.update(len(b).to_bytes(4, "big"))
        h.update(b)
    return h.digest()


@dataclass
class ROCommitment:
    """commitment.go:14-18."""

    hash_bytes: bytes
    r: int

    def check_open(self, value: int) -> bool:
        """commitment.go:33-38."""
        return random_oracle_digest(value, self.r) == self.hash_bytes


def commit(value: int) -> ROCommitment:
    """commitment.go:20-30."""
    r = int.from_bytes(secrets.token_bytes(32), "big")
    return ROCommitment(random_oracle_digest(value, r), r)
