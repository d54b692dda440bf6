"""cpir.bases_ms: the queries' ebits turned into 32-bit words and uploaded
a batch, the program's ``pir.cpir.bases`` span over the batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.cpir.bases")
