"""teacher_kernel_share.<cell kind>: the training forwards' top decoder
layers served by the fused teacher kernels K6/K7, over all the top layers
they ran, in the traced units: the program tracer's counters
``training.teacher_kernel_calls`` over ``training.teacher_calls``.
Nothing where the program has no such counters or ran no training
forward."""

from portbench import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    snap = program_spans.tracer_snapshot()
    counters = (snap or {}).get('counters', {})
    calls = counters.get('training.teacher_calls')
    if not calls:
        return None
    return counters.get('training.teacher_kernel_calls', 0) / calls
