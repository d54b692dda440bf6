"""device.idle_share: the share of the untraced window's period (its
seconds over its batches) in which the device was not busy, the busy
seconds a batch taken from the trace (the union of kernel, copy and set
intervals over the traced batches), in %. The profiler slows the host,
not the device, so the period is the window's and not the trace's."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if not t or not t.batches or t.busy_s <= 0 or not w.batches:
        return None
    return 100 * (1 - (t.busy_s / t.batches) / (w.seconds / w.batches))
