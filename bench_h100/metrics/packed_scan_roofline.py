"""packed_scan_roofline: the least time of the traced batches' scans (8 x 2
x Q x H x B int8 operations at the tensor cores' peak, or the bytes at
HBM's if more) over the packed scan kernel's device time, in %."""

KERNEL = "packed_scan_kernel"


def read(ctx):
    t = ctx.trace
    spent = sum(d for _, _, d in t.kernels(KERNEL)) if t else 0
    if not spent:
        return None
    c = ctx.config
    bound = t.batches * ctx.peaks.scan_s(ctx.mix["batch"], c["rows"], c["row_bytes"])
    return 100 * bound / spent
