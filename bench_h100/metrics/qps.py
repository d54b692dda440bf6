"""qps: server 0's queries answered in the measured window over its seconds."""


def read(ctx):
    w = ctx.window
    return w.queries / w.seconds if w.batches else None
