"""server.wait_ms: the front end's span around taking a batch's answers
(the wait for the device, the copy back, the result objects), summed over
the measured window and divided by its batches."""


def read(ctx):
    w = ctx.window
    return w.wait_s / w.batches * 1e3 if w.batches else None
