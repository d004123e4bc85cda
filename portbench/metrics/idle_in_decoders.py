"""idle_in_decoders.<cell kind>: the share of the traced window's device
idle time whose innermost program span is the decoders'
(``cor.decoders.*``: the encoder, each beam iteration with its read of
the lines still live, the backtrace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_of_layer(ctx.trace, 'decoders')
