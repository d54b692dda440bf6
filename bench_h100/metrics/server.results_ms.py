"""server.results_ms: building a batch's result objects, the program's
``pir.answers.slice`` span over the batches dispatched."""

from program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms("pir.answers.slice")
