"""pipeline.head_ms: enqueueing the head walk's eager plain-torch launches a
batch (and any wait for a full launch queue), the program's ``pir.head`` span
over the batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.head")
