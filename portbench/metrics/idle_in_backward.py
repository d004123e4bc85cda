"""idle_in_backward.<cell kind>: the share of the traced window's device
idle time inside a training step's backward pass
(``cor.training.backward``: autograd's gradients of the loss)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_under(ctx.trace, 'training.backward')
