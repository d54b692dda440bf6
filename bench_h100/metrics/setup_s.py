"""setup_s: process start to the measured window's start (inputs, the
server's tables, kernel builds or loads, warm-up)."""


def read(ctx):
    return ctx.setup_s
