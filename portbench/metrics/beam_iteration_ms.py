"""beam_iteration_ms.<cell kind>: the mean duration of the
``cor.decoders.beam_iteration`` spans of the traced units, in ms (host
clock of the profiler, the profiler running)."""

from portbench import program_spans


def read(ctx):
    times = program_spans.durations_ms(ctx.trace, 'decoders.beam_iteration')
    if not times:
        return None
    return sum(times) / len(times)
