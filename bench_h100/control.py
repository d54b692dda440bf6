"""The control of the comparison that decides ``correct``: the plain
reference of the configuration's protocol put in the program's place, with
one guarantee of the configuration broken (the protocol's ``answers`` with
``broken``), served through the same front end, window and comparison as a
run of the cell. Its runs have to come out not correct.

    python3 bench_h100/control.py --workload <cell> --seeds <n>,<n>,... --seconds <s>

prints one JSON line a seed (the compared numbers) and exits non-zero if
any run came out correct. The control answers the sampled queries (the
only ones the comparison reads) from the reference and the others with
zeros, so it serves at the cell's sizes in seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class System:
    """The control's system, a stand-in for ``systems/<protocol>.py``:
    shares are pool positions, and each batch is answered from the
    protocol's reference answers with the guarantee broken."""

    # seconds a batch takes, so that a window compares about as many
    # answers as a run of the program does
    period = 0.25

    def __init__(self, config: dict, table, device, seed: int, pool, sample):
        import named

        protocol = named.module("protocols", config["protocol"])
        ref = protocol.answers(config, seed, pool, sample, device, broken=True)
        served = ref[protocol.SERVED]
        self.answers = {int(p): served[i].tobytes() for i, p in enumerate(sample)}
        self.zero = bytes(served.shape[1])

    def shares(self, pool, server: int = 0) -> list:
        return list(range(len(pool.targets)))

    def entry(self, name: str):
        import system

        outer = self

        class Entry(system.Entry):
            def dispatch(self, batch):
                time.sleep(outer.period)
                res = [outer.answers.get(p, outer.zero) for p in batch]
                self.ready.append(lambda: res)

        return Entry()


def answer_bytes(result: bytes) -> bytes:
    """The control's answers are their bytes."""
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--period", type=float, default=System.period)
    args = ap.parse_args(argv)
    System.period = args.period
    sys.path[:0] = [HERE, ROOT]
    import check
    import harness

    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, args.device,
                               time.perf_counter(), system=sys.modules[__name__])
        bad += res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
        for line in check.lines(res["checks"]):
            print(line, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
