"""cpir.copy_ms: the wait for the device and the answers' copy back a
batch, the program's ``pir.answers.copy`` span over the batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.answers.copy")
