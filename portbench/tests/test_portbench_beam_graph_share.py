"""The reader of ``beam_graph_share.page``: the tracer's graph iterations
over its beam iterations, and nothing from a program without the graph
route or from an untraced run."""

import pytest

from tiny import PAGES, tiny_run

from portbench import harness
from portbench.run import Context


def _trace():
    events = [dict(ph='X', cat='user_annotation', name=harness.Profiler.WINDOW,
                   ts=0.0, dur=100.0),
              dict(ph='X', cat='kernel', name='k', ts=10.0, dur=10.0)]
    return harness.Trace.from_chrome(events, harness.Profiler.WINDOW)


def _read(trace):
    return harness.load_reader('beam_graph_share.page')(Context(trace=trace))


def _counted(iterations, graph_iterations):
    from torch.profiler import ProfilerActivity, profile
    from cor_asv_ann_tpu_torch.utils import profiling
    profiling.snapshot()    # the tracer sees no session: the next starts empty
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count('decoders.beam_iterations', iterations)
        if graph_iterations:
            profiling.count('decoders.beam_graph_iterations',
                            graph_iterations)


@pytest.mark.parametrize('iterations,graph_iterations,share',
                         [(8, 6, 0.75), (49, 49, 1.0), (5, 0, 0.0)])
def test_beam_graph_share_reads_the_tracer(iterations, graph_iterations,
                                           share):
    _counted(iterations, graph_iterations)
    assert _read(_trace()) == pytest.approx(share)
    assert _read(None) is None


def test_beam_graph_share_reads_nothing_without_the_graph_route(
        monkeypatch):
    from cor_asv_ann_tpu_torch.models import beam
    _counted(8, 8)
    monkeypatch.delattr(beam, '_BEAM_GRAPH')
    assert _read(_trace()) is None


def test_a_tiny_traced_run_reports_the_share():
    """On the CPU the beam runs op by op: the share reads 0."""
    result, checks = tiny_run(PAGES, seconds=0.2, trace=True)
    assert result['correct'], checks
    assert result['metrics']['beam_graph_share.page']['value'] == 0.0
