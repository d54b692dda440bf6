"""server.dispatch_ms: the front end's span around each dispatching call
(submit / _async: payload build, head walk, kernel launches), summed over
the measured window and divided by its batches."""


def read(ctx):
    w = ctx.window
    return w.dispatch_s / w.batches * 1e3 if w.batches else None
