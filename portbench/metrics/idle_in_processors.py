"""idle_in_processors.<cell kind>: the share of the traced window's
device idle time whose innermost program span is the processor's
(``cor.processors.*``: the page, PAGE to confusion networks, the apply
phase with its realignment, element updates and TextEquiv levels)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_of_layer(ctx.trace, 'processors')
