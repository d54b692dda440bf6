"""The one traffic generator: a cell's inputs from its configuration, its
traffic mix and the seed.

A mix is a JSON file of parameters under ``traffic/``:

* ``entry``: how the front end hands the server a batch, a file of
  ``entries/`` (``fast_stream``: the fast serving stream's ``submit`` /
  ``flush``; ``batch_async``: ``private_secret_shared_query_batch_async``);
* ``loop``: how the front end paces the batches, a file of ``loops/``
  (``closed``: the next batch as soon as fewer than ``in_flight`` are out);
* ``clients``: the client initialisations the pool is made by, each with
  its own public PRF keys, each asking an equal run of the pool (1: every
  query shares one set of PRF keys, the batch API's layout);
* ``batch``: queries a batch; ``pool``: distinct queries the batches are
  drawn from; ``draws``: the number of seeded batch draws, used in turn;
  ``in_flight``: batches dispatched and not yet answered before the front
  end waits for the oldest;
* ``warmup_batches``: batches served before the window opens;
* ``check_queries``: pool queries whose every answer is compared with
  the reference; ``trace_batches``: batches under the profiler in a
  traced run.

Everything here is a function of the seed: the table (made on the device
with a ``torch.Generator``), the rows asked for, the keys (the frozen
keygen of ``dpf_ref``), the order of the batches and the sample checked.
Every seed gets the same sizes and the same number of batches of each size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

import dpf_ref

# independent streams of randomness drawn from one seed
STREAMS = {"table": 0, "targets": 1, "prf_keys": 2, "keys": 3, "draws": 4, "sample": 5}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed % (1 << 64),
                                                        spawn_key=(STREAMS[stream],)))


def make_table(config: dict, seed: int, device) -> torch.Tensor:
    """The (rows, row_bytes) uint8 table of the seed, made on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, "table").integers(0, 1 << 63)))
    return torch.randint(0, 256, (config["rows"], config["row_bytes"]), dtype=torch.uint8,
                         device=device, generator=g)


@dataclass
class Pool:
    """The pool of queries: targets (P,), the client of each query (P,),
    each client's public PRF keys (4 x 16 bytes), and per server s the key
    fields s{s}, t{s} and the shared cw and, for fast keys, fcw or, for
    compat keys, final_cw (numpy arrays)."""

    targets: np.ndarray
    client: np.ndarray
    prf_keys: list[list[bytes]]
    keys: dict
    style: str
    num_levels: int

    def fields(self, server: int, idx, device) -> tuple:
        """The key fields of pool queries `idx` for `server`, as tensors."""
        k = self.keys
        last = "fcw" if self.style == "fast" else "final_cw"
        return tuple(torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)
                     for a in (k[f"s{server}"], k[f"t{server}"], k["cw"], k[last]))

    def by_client(self, idx: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """(client, positions into idx) of the clients that queries `idx` hold."""
        c = self.client[idx]
        return [(int(u), np.flatnonzero(c == u)) for u in np.unique(c)]


def make_pool(config: dict, traffic: dict, seed: int, device) -> Pool:
    """The cell's pool of queries, keys made on `device`: client c asks
    pool queries [c P / n, (c + 1) P / n) with its own PRF keys."""
    p, rows, n = traffic["pool"], config["rows"], traffic.get("clients", 1)
    targets = rng(seed, "targets").integers(0, rows, p)
    client = np.arange(p) * n // p
    raw = rng(seed, "prf_keys").bytes(64 * n)
    prf_keys = [[raw[64 * c + 16 * i:64 * c + 16 * (i + 1)] for i in range(4)]
                for c in range(n)]
    rnd = np.frombuffer(rng(seed, "keys").bytes(p * 33), np.uint8).reshape(p, 33)
    parts = []
    for c in range(n):
        sel = np.flatnonzero(client == c)
        rks = dpf_ref.round_keys(prf_keys[c], device)
        if config["keys"] == "fast":
            parts.append(dpf_ref.fast_keygen(rks, targets[sel], rows, config["leaf_bits"],
                                             rnd[sel], device))
        else:
            parts.append(dpf_ref.compat_keygen(rks, targets[sel],
                                               dpf_ref.num_bits_for_height(rows), rnd[sel],
                                               device))
    keys = {k: np.concatenate([part[k] for part in parts]) for k in parts[0]}
    return Pool(targets, client, prf_keys, keys, config["keys"], keys["cw"].shape[1])


def make_draws(traffic: dict, seed: int) -> list[np.ndarray]:
    """The batches' pool positions: `draws` draws of `batch` distinct pool
    queries each, used in turn."""
    r = rng(seed, "draws")
    return [r.choice(traffic["pool"], traffic["batch"], replace=False)
            for _ in range(traffic["draws"])]


def make_sample(traffic: dict, seed: int) -> np.ndarray:
    """The pool queries whose answers are compared, sorted."""
    return np.sort(rng(seed, "sample").choice(traffic["pool"], traffic["check_queries"],
                                              replace=False))
