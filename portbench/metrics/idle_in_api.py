"""idle_in_api.<cell kind>: the share of the traced window's device idle
time whose innermost program span is the API's (``cor.api.*``:
``correct_lines``, a batch's dispatch, the confidence probe, and the
finish: the fetch of a batch's results and the rebuild of texts,
probabilities and alignments)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_share_of_layer(ctx.trace, 'api')
