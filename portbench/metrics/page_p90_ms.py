"""page_p90_ms: the 90th percentile (nearest rank) of the time from a
page's call to its return, over every page of the window, in ms."""

import math


def read(ctx):
    times = sorted(u['t1'] - u['t0'] for u in ctx.units(traced=False))
    if not times:
        return None
    return 1e3 * times[math.ceil(0.9 * len(times)) - 1]
