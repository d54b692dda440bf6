"""cpir.scan_ms: kernel 10's plan, constants and launches (tables, chunks,
merge) for a batch's queries, the program's ``pir.cpir.scan`` span over the
batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.cpir.scan")
