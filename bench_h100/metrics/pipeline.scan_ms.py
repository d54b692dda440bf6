"""pipeline.scan_ms: the scan's launch and its operand shuffles (the words
regroup and padding) a batch, the program's ``pir.scan`` span over the batches
dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.scan")
