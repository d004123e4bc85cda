"""launches_per_line.<cell kind>: kernels in the device trace of the
traced pages, per line those pages corrected."""


def read(ctx):
    lines = sum(u['lines'] for u in ctx.units(traced=True))
    if ctx.trace is None or not lines:
        return None
    return len(ctx.trace.kernels()) / lines
