"""The program's own spans, as the per-layer readers of ``metrics/`` take
them: ``pir_tpu_torch.utils.metrics.span_totals()``, the self seconds and
count of each ``pir.*`` span the process closed with no profiler recording
(set-up, the warm-up batches, the window and the drain; not the traced
batches). A program without the recorder, or a run in which a span never
ran (the control, with the reference in the program's place), reads None.
"""

ROOT_SPAN = "pir.dispatch"  # one a batch: the per-batch metrics' divisor


def totals() -> dict:
    try:
        from pir_tpu_torch.utils.metrics import span_totals
    except ImportError:
        return {}
    return span_totals()


def per_batch_ms(name: str):
    """`name`'s self seconds over the count of dispatched batches, in ms."""
    t = totals()
    root, span = t.get(ROOT_SPAN), t.get(name)
    if not root or not span or not root["count"]:
        return None
    return span["seconds"] / root["count"] * 1e3


def total_s(name: str):
    """`name`'s self seconds over the whole run."""
    span = totals().get(name)
    return span["seconds"] if span else None
