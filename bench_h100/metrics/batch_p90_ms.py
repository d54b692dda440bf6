"""batch_p90_ms: the 90th percentile of every window batch's time, from the
call that dispatched it to its answers in hand (statistics.quantiles)."""

import statistics


def read(ctx):
    lat = ctx.window.latencies
    return statistics.quantiles(lat, n=10)[-1] * 1e3 if len(lat) >= 2 else None
