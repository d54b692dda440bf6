"""dpf2: the system under test, ``pir_tpu_torch``, as the benchmark drives
it for two-server DPF PIR: a ``TorchPirServer`` over the seed's table, the
pool's shares as the port's own ``QueryShare`` objects, and the entry a
traffic mix names (``entries/<name>.py``, which drives the server it is
given).
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
        """The pool's (``protocols/dpf2.Pool``) shares for `server` as the
        port's QueryShare objects; the shares of one client hold one list
        of PRF keys (as the port's batch keygen makes them)."""
        from pir_tpu_torch.dpf.host import PrfKey
        from pir_tpu_torch.state import compat_share_from_fields, share_from_fields

        lists = [[PrfKey(bytes(k)) for k in keys] for keys in pool.prf_keys]
        prf_of = [lists[c] for c in pool.client]
        k, g = pool.keys, self.config["group_size"]
        s_init, t_init, cw = k[f"s{server}"], k[f"t{server}"], k["cw"]
        levels = range(cw.shape[1])
        if pool.style == "fast":
            return [share_from_fields(prf_keys=prf_of[j], s_init=s_init[j].tobytes(),
                                      t_init=int(t_init[j]),
                                      cw=[cw[j, i].tobytes() for i in levels],
                                      final_cw_block=k["fcw"][j].tobytes(),
                                      depth=cw.shape[1], height=self.config["rows"],
                                      share_number=server, group_size=g)
                    for j in range(len(pool.targets))]
        return [compat_share_from_fields(prf_keys=prf_of[j], s_init=s_init[j].tobytes(),
                                         t_init=int(t_init[j]),
                                         cw=[cw[j, i].tobytes() for i in levels],
                                         final_cw=int(k["final_cw"][j]),
                                         share_number=server, group_size=g)
                for j in range(len(pool.targets))]

    def entry(self, name: str):
        return named.module("entries", name).make(self.server)


def answer_bytes(result) -> bytes:
    """The answer share's bytes of one of the port's results (group size 1)."""
    return bytes(result.shares[0].data)
