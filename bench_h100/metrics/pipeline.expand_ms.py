"""pipeline.expand_ms: the tail or stage kernels' launches a batch, the
program's ``pir.expand`` span over the batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.expand")
