"""lines_per_s: every line corrected in the window over the window's
seconds (from its start to the return of its last unit)."""


def read(ctx):
    units = ctx.units(traced=False)
    if not units:
        return None
    return sum(u['lines'] for u in units) / (ctx.window[1] - ctx.window[0])
