"""server.payload_ms: the host payload build (numpy) and its upload a batch,
the program's ``pir.payload`` span over the batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.payload")
