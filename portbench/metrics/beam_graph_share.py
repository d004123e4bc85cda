"""beam_graph_share.<cell kind>: the beam's iterations served by a replay
of the CUDA graph of its iteration, over all the iterations it ran, in
the traced units: the program tracer's counters
``decoders.beam_graph_iterations`` over ``decoders.beam_iterations``.
Nothing where the program's beam has no graph route (no ``_BEAM_GRAPH``
in ``cor_asv_ann_tpu_torch/models/beam.py``) or ran no iteration."""

from portbench import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    from cor_asv_ann_tpu_torch.models import beam
    if not hasattr(beam, '_BEAM_GRAPH'):
        return None
    snap = program_spans.tracer_snapshot()
    counters = (snap or {}).get('counters', {})
    iterations = counters.get('decoders.beam_iterations')
    if not iterations:
        return None
    return counters.get('decoders.beam_graph_iterations', 0) / iterations
