"""beam_live_share.<cell kind>: the rows the beam stepped while their
line was still live, over all the rows it stepped (a bucket's padding
rows included), in the traced units: the program tracer's counters
``decoders.beam_live_rows`` over ``decoders.beam_rows``."""

from portbench import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    snap = program_spans.tracer_snapshot()
    rows = (snap or {}).get('counters', {}).get('decoders.beam_rows')
    if not rows:
        return None
    return snap['counters'].get('decoders.beam_live_rows', 0) / rows
