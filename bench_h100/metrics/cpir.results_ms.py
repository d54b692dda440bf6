"""cpir.results_ms: the answers' words turned into integers and result
objects a batch, the program's ``pir.cpir.results`` span over the batches
dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.cpir.results")
