"""The comparison that decides ``correct``.

Every answer the front end kept (each answer, in every batch of the run,
of a query in the seed's sample) is held against the reference: the
answer share has to equal the reference's server-0 share byte for byte,
and with the reference's server-1 share it has to recover the row asked
for. Answers that never came count as missing. Each number is compared
with its limit (exact comparisons: 0); ``checked`` has to reach its floor
so that a run that kept nothing cannot pass.
"""

from __future__ import annotations

import numpy as np

# name -> (limit, rule): the value must be <= the limit ("max") or >= it ("min")
LIMITS = {"mismatched": (0, "max"), "unrecovered": (0, "max"), "missing": (0, "max"),
          "checked": (1, "min")}


def compare(kept: list, draws: list, sample: np.ndarray, ref: dict, missing: int) -> dict:
    """kept: (draw, position, answer bytes) of the run; draws: the pool
    positions of each draw; sample: the sorted pool queries the reference
    answered; ref: reference.answers' arrays."""
    mismatched = unrecovered = 0
    for d, pos, ans in kept:
        i = int(np.searchsorted(sample, draws[d][pos]))
        got = np.frombuffer(ans, np.uint8)
        if len(got) != ref["share0"].shape[1] or not np.array_equal(got, ref["share0"][i]):
            mismatched += 1
        if len(got) != ref["share1"].shape[1] or not np.array_equal(got ^ ref["share1"][i],
                                                                      ref["rows"][i]):
            unrecovered += 1
    values = {"mismatched": mismatched, "unrecovered": unrecovered, "missing": missing,
              "checked": len(kept)}
    return {k: {"value": v, "limit": LIMITS[k][0], "rule": LIMITS[k][1]}
            for k, v in values.items()}


def passes(entry: dict) -> bool:
    if entry["rule"] == "max":
        return entry["value"] <= entry["limit"]
    return entry["value"] >= entry["limit"]


def correct(checks: dict) -> bool:
    return all(passes(c) for c in checks.values())


def lines(checks: dict) -> list[str]:
    """One line a number: its name, value, and limit."""
    sign = {"max": "<=", "min": ">="}
    return [f"check {k}: {c['value']} (limit {sign[c['rule']]} {c['limit']})"
            for k, c in checks.items()]
