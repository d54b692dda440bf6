"""cpir: the system under test, ``pir_tpu_torch``, as the benchmark drives
it for single-server Paillier cPIR: a ``TorchPirServer`` over the seed's
table, the pool's queries as the port's own ``EncryptedQuery`` objects
(each client's ``PublicKey``, its level-1 ebits, the configuration's
grid), and the entry a traffic mix names (``entries/<name>.py``, which
drives the server it is given).
"""

from __future__ import annotations

import numpy as np

import named


class System:
    """The port's server over `table` (a (rows, row_bytes) uint8 numpy
    array), on `device`, built as the configuration states."""

    def __init__(self, config: dict, table: np.ndarray, device, *_):
        from pir_tpu_torch.server import TorchPirServer
        from pir_tpu_torch.state import database_from_numpy

        self.config = config
        self.db = database_from_numpy(table, config["row_bytes"])
        self.server = TorchPirServer(self.db, device=device, **config["server_options"])

    def shares(self, pool, server: int = 0) -> list:
        """The pool's (``protocols/cpir.Pool``) queries as the port's
        EncryptedQuery objects; the queries of one client hold one
        PublicKey."""
        from pir_tpu_torch.encrypted import EncryptedQuery
        from pir_tpu_torch.state import ciphertext_from_fields, paillier_public_key

        c = self.config
        keys = [paillier_public_key(p * q) for p, q in pool.primes]
        return [EncryptedQuery(keys[int(pool.client[i])],
                               [ciphertext_from_fields(e, 1) for e in pool.ebits[i]],
                               c["group_size"], c["grid_width"], c["grid_height"])
                for i in range(len(pool.targets))]

    def entry(self, name: str):
        return named.module("entries", name).make(self.server)


def answer_bytes(result) -> bytes:
    """One of the port's EncryptedQueryResults as its ciphertexts' fixed-
    width big-endian bytes, column by column (``protocols/cpir.py``'s)."""
    width = (2 * result.pk.n.bit_length() + 7) // 8
    return b"".join(ct.c.to_bytes(width, "big") for s in result.slots for ct in s.cts)
