"""pipeline.launches_per_batch: device kernels in the traced window over
the batches dispatched in it (the window drains each batch's device work)."""


def read(ctx):
    t = ctx.trace
    return t.kernel_count() / t.batches if t and t.batches and t.kernel_count() else None
