"""The comparison that decides ``correct``.

The configuration's protocol (``protocols/<protocol>.py``) holds every
answer the front end kept (each answer, in every batch of the run, of a
query in the seed's sample) against its plain reference, and returns
named checks: ``{name: {"value", "limit", "rule"}}``, the rule ``max``
(value <= limit) or ``min`` (value >= limit). Every protocol reports
``mismatched`` (answers unlike the reference's), ``missing`` (answers
that never came) and ``checked`` (the answers compared, with a floor so
that a run that kept nothing cannot pass), and may add its own. Here the
checks are judged and printed.
"""

from __future__ import annotations


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
