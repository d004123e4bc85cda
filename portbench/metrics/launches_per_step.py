"""launches_per_step.<cell kind>: kernels in the device trace of the
traced training steps, per step."""


def read(ctx):
    steps = len(ctx.units(traced=True))
    if ctx.trace is None or not steps:
        return None
    return len(ctx.trace.kernels()) / steps
