"""Files of the benchmark found by name: a kind of file is a directory of
``bench_h100/``, and a name is a file in it.

* ``entries/<name>.py``: how a front end hands the server a batch
  (``make(server)`` returns an ``system.Entry``), named by a mix's ``entry``;
* ``loops/<name>.py``: how the front end paces its batches (``make(entry,
  batches, keep, mix)``), named by a mix's ``loop``;
* ``metrics/<name>.py``: a metric's reader (``read(ctx)``), named by
  ``BENCHMARK.json``;
* ``kernels/<set>/*.txt``: a set of device kernels, one name fragment a
  line, read by the metrics that hold a set's time against its bound.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} file {name!r} under bench_h100/{kind}/")
    spec = importlib.util.spec_from_file_location(f"{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
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
