"""cpir.shell_ms: the cPIR dispatching call's own time a batch, the self time
of the program's ``pir.dispatch`` span (the queries' checks: what no child
span covers) over its count."""

from program_spans import ROOT_SPAN, per_batch_ms


def read(ctx):
    return per_batch_ms(ROOT_SPAN)
