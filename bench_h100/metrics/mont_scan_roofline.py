"""mont_scan_roofline: the least time of the traced batches' cPIR scans over
the device time of the kernels of the ``mont`` set (``kernels/mont/*.txt``:
kernel 10's tables, chunks and merge), in %.

A query's least time is the fewest Montgomery products of its grid's
multi-exponentiation (``least_products``), each 2 L^2 + L word products of
two INT32 operations at the card's 32-bit integer peak, L the 32-bit words
of N^2. Counted from the configuration's sizes and key bits alone, so it
reads the same work whatever implements it."""


def least_products(h: int, w: int, e_max: int) -> int:
    """The fewest Montgomery products of w columns of prod_r b_r^e(r, col)
    over h rows of e_max-bit exponents, over every fixed window wb
    (Straus's method in one chunk): each row's table of 2^wb entries built
    once for all columns, each column's ceil(e_max / wb) windows of wb
    squarings shared by the rows and a product a row, and one product a
    column to leave the Montgomery domain."""
    return min(h * (1 << wb) + w * -(-e_max // wb) * (wb + h) + w for wb in range(1, 17))


def query_s(config: dict, int32_ops_per_s: float) -> float:
    """Least seconds of one query's scan."""
    c = config
    e_max = 8 * -(-c["row_bytes"] // c["chunks"])
    words = -(-2 * c["key_bits"] // 32)
    prods = least_products(c["grid_height"], c["grid_width"] * c["chunks"], e_max)
    return prods * (2 * words * words + words) * 2 / int32_ops_per_s


def read(ctx):
    t = ctx.trace
    if not t or not t.batches:
        return None
    frags = ctx.kernel_set("mont")
    spent = sum(d for n, _, d in t.kernels("") if any(f in n for f in frags))
    if not spent:
        return None
    bound = t.batches * ctx.mix["batch"] * query_s(ctx.config, ctx.peaks.INT32_OPS_PER_S)
    return 100 * bound / spent
