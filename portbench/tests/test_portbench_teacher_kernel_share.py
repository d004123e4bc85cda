"""The reader of ``teacher_kernel_share.train``: the tracer's top layers
served by K6/K7 over its top layers, and nothing from a program without
the counters or from an untraced run."""

import pytest

from tiny import TRAIN, tiny_run

from portbench import harness
from portbench.run import Context


def _trace():
    events = [dict(ph='X', cat='user_annotation', name=harness.Profiler.WINDOW,
                   ts=0.0, dur=100.0),
              dict(ph='X', cat='kernel', name='k', ts=10.0, dur=10.0)]
    return harness.Trace.from_chrome(events, harness.Profiler.WINDOW)


def _read(trace):
    return harness.load_reader('teacher_kernel_share.train')(
        Context(trace=trace))


def _counted(**counters):
    from torch.profiler import ProfilerActivity, profile
    from cor_asv_ann_tpu_torch.utils import profiling
    profiling.snapshot()    # the tracer sees no session: the next starts empty
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in counters.items():
            profiling.count('training.' + name, n)


@pytest.mark.parametrize('calls,kernel_calls,share',
                         [(5, 5, 1.0), (8, 2, 0.25), (3, 0, 0.0)])
def test_teacher_kernel_share_reads_the_tracer(calls, kernel_calls, share):
    if kernel_calls:
        _counted(teacher_calls=calls, teacher_kernel_calls=kernel_calls)
    else:
        _counted(teacher_calls=calls)
    assert _read(_trace()) == pytest.approx(share)
    assert _read(None) is None


def test_teacher_kernel_share_reads_nothing_without_the_counters():
    """A program that counts no top layers (as one before the counters)
    reads null, whatever else the tracer counted."""
    _counted(steps=4)
    assert _read(_trace()) is None


def test_a_tiny_traced_run_reports_the_share():
    """On the CPU the 'auto' route keeps the top layer off the kernels:
    the share reads 0."""
    result, checks = tiny_run(TRAIN, seconds=0.2, trace=True)
    assert result['correct'], checks
    assert result['metrics']['teacher_kernel_share.train']['value'] == 0.0
