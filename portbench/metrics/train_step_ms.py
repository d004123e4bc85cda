"""train_step_ms: the window's seconds over the training steps it
completed, in ms."""


def read(ctx):
    units = ctx.units(traced=False)
    if not units:
        return None
    return 1e3 * (ctx.window[1] - ctx.window[0]) / len(units)
