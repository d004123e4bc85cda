"""device_idle.<cell kind>: the share of the traced window in which no
operation ran on the device: 1 minus the union of the kernel, copy and
set intervals of the profiler's device trace over the window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s() <= 0:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.trace.window_s()
