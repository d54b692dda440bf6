"""The one traffic generator: a cell's inputs from its configuration, its
traffic mix and the seed.

A mix is a JSON file of parameters under ``traffic/``:

* ``entry``: how the front end hands the system a batch, a file of
  ``entries/`` (``fast_stream``: the fast serving stream's ``submit`` /
  ``flush``; ``batch_async``: ``private_secret_shared_query_batch_async``);
* ``loop``: how the front end paces the batches, a file of ``loops/``
  (``closed``: the next batch as soon as fewer than ``in_flight`` are out);
* ``clients``: the client initialisations the pool is made by, each with
  its own public keys, each asking an equal run of the pool (1: every
  query shares one set of keys, the batch API's layout), read by the
  protocol's ``make_pool``;
* ``batch``: queries a batch; ``pool``: distinct queries the batches are
  drawn from; ``draws``: the number of seeded batch draws, used in turn;
  ``in_flight``: batches dispatched and not yet answered before the front
  end waits for the oldest;
* ``warmup_batches``: batches served before the window opens;
* ``check_queries``: pool queries whose every answer is compared with
  the reference; ``trace_batches``: batches under the profiler in a
  traced run.

Everything here is a function of the seed: the table (made on the device
with a ``torch.Generator``), the order of the batches and the sample
checked; the pool of queries is the protocol's (``protocols/<name>.py``
``make_pool``), drawn from the streams ``targets``, ``prf_keys`` and
``keys``. Every seed gets the same sizes and the same number of batches
of each size.
"""

from __future__ import annotations

import numpy as np
import torch

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
