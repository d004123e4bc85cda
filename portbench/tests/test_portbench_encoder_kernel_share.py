"""The reader of ``encoder_kernel_share.page``: the tracer's serving
encoder scans served by the whole-sequence scan over all its serving
encoder scans, and nothing from a program without the counters or from
an untraced run."""

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
    return harness.load_reader('encoder_kernel_share.page')(
        Context(trace=trace))


def _counted(**counters):
    from torch.profiler import ProfilerActivity, profile
    from cor_asv_ann_tpu_torch.utils import profiling
    profiling.snapshot()    # the tracer sees no session: the next starts empty
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in counters.items():
            profiling.count('decoders.' + name, n)


@pytest.mark.parametrize('scans,kernel_scans,share',
                         [(3, 3, 1.0), (12, 3, 0.25), (6, 0, 0.0)])
def test_encoder_kernel_share_reads_the_tracer(scans, kernel_scans, share):
    if kernel_scans:
        _counted(encoder_scans=scans, encoder_kernel_scans=kernel_scans)
    else:
        _counted(encoder_scans=scans)
    assert _read(_trace()) == pytest.approx(share)
    assert _read(None) is None


def test_encoder_kernel_share_reads_nothing_without_the_counters():
    """A program that counts no encoder scans (as one before the
    counters) reads null, whatever else the tracer counted."""
    _counted(beam_iterations=4, beam_graph_iterations=4)
    assert _read(_trace()) is None


def test_a_tiny_traced_run_reports_the_share():
    """On the CPU the 'auto' route keeps the encoder on the step-by-step
    scan: the share reads 0."""
    result, checks = tiny_run(PAGES, seconds=0.2, trace=True)
    assert result['correct'], checks
    assert result['metrics']['encoder_kernel_share.page']['value'] == 0.0
