"""idle_in_forward.<cell kind>: the share of the traced window's device
idle time inside a training step's forward pass (``cor.training.forward``
and the spans opened inside it, such as the encoder's)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_under(ctx.trace, 'training.forward')
