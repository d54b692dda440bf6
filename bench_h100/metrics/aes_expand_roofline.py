"""aes_expand_roofline: the least time of the AES blocks the traced
batches' whole DPF expansion needs (peaks.expansion_blocks: every node of
the key's tree above the rows, and the fast leaves, counted from the key
format alone) over the device time of the kernels of the ``aes`` set
(``kernels/aes/*.txt``), in %. Levels the program walks outside the set's
kernels are counted, not timed: the share reads high by their part."""


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    frags = ctx.kernel_set("aes")
    spent = sum(d for n, _, d in t.kernels("") if any(f in n for f in frags))
    if not spent:
        return None
    blocks = ctx.peaks.expansion_blocks(ctx.mix["batch"], ctx.config)
    return 100 * t.batches * ctx.peaks.aes_s(blocks) / spent
