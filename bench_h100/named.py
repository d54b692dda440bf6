"""Files of the benchmark found by name: a kind of file is a directory of
``bench_h100/``, and a name is a file in it.

* ``entries/<name>.py``: how a front end hands the server a batch
  (``make(server)`` returns an ``system.Entry``), named by a mix's ``entry``;
* ``loops/<name>.py``: how the front end paces its batches (``make(entry,
  batches, keep, mix, answer_bytes)``), named by a mix's ``loop``;
* ``metrics/<name>.py``: a metric's reader (``read(ctx)``), named by
  ``BENCHMARK.json``;
* ``protocols/<name>.py``: a protocol's plain side, named by a
  configuration's ``protocol``: ``make_pool(config, mix, seed, device)``,
  the pool of queries from the seed (its ``targets``, one a query);
  ``answers(config, seed, pool, idx, device, broken=False)``, the plain
  reference's answers of pool queries ``idx`` (a dict of arrays, one row a
  query; ``broken``: with one guarantee of the configuration broken, the
  control's); ``SERVED``, the key of those answers that the system under
  test has to give; ``compare(kept, draws, sample, ref, missing)``, the
  named checks that decide ``correct`` (``check``); ``CONFIG_KEYS``, the
  keys its configurations state. It imports nothing of the program;
* ``systems/<name>.py``: the program as the benchmark drives it for the
  protocol of that name, the only kind of file that imports the program:
  ``System(config, table, device, seed, pool, sample)`` with
  ``.shares(pool, server)`` (the pool's queries as the program takes
  them) and ``.entry(name)`` (an ``entries/`` file over its server), and
  ``answer_bytes(result)``, the bytes of one of its answers;
* ``kernels/<set>/*.txt``: a set of device kernels, one name fragment a
  line, read by the metrics that hold a set's time against its bound.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def module(kind: str, name: str, root: str = HERE):
    """The module ``<kind>/<name>.py`` under `root`."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} file {name!r} under bench_h100/{kind}/")
    spec = importlib.util.spec_from_file_location(f"{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as dataclasses look their module up there
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_set(name: str) -> list[str]:
    """The kernel-name fragments of ``kernels/<name>/*.txt`` (one a line;
    ``#`` starts a comment), sorted."""
    root = os.path.join(HERE, "kernels", name)
    frags = set()
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".txt"):
            continue
        with open(os.path.join(root, fname)) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    frags.add(line)
    return sorted(frags)
