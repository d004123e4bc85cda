"""encoder_kernel_share.<cell kind>: the serving encoder's sequence scans
served by the whole-sequence scan (K4 on the card), over all the scans
it ran, in the traced units: the program tracer's counters
``decoders.encoder_kernel_scans`` over ``decoders.encoder_scans``.
Nothing where the program has no such counters or ran no serving
encoder."""

from portbench import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    snap = program_spans.tracer_snapshot()
    counters = (snap or {}).get('counters', {})
    scans = counters.get('decoders.encoder_scans')
    if not scans:
        return None
    return counters.get('decoders.encoder_kernel_scans', 0) / scans
