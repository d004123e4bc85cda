"""The readers of the program's own spans and counters
(``portbench/program_spans.py``): the device's idle time split exactly at
``cor.*`` span boundaries, the beam's iteration time and live share, and
a tiny traced run of each cell that reports them."""

import pytest

from tiny import PAGES, TRAIN, tiny_run

from portbench import harness
from portbench.run import Context

PAGE_METRICS = ('idle_in_processors.page', 'idle_in_api.page',
                'idle_in_decoders.page', 'beam_iteration_ms.page',
                'beam_live_share.page')
TRAIN_METRICS = ('idle_in_forward.train', 'idle_in_backward.train')


def trace_of(kernels, spans, window=(0.0, 100.0)):
    """A trace of `kernels` and `spans` ((name, start, end) in us), with
    a harness annotation and a host op that the readers must pass over."""
    events = [dict(ph='X', cat='user_annotation', name=harness.Profiler.WINDOW,
                   ts=window[0], dur=window[1] - window[0]),
              dict(ph='X', cat='user_annotation',
                   name='portbench.process_page', ts=1.0, dur=98.0),
              dict(ph='X', cat='cpu_op', name='aten::mm', ts=30.0, dur=2.0)]
    events += [dict(ph='X', cat='kernel', name=n, ts=s, dur=e - s)
               for n, s, e in kernels]
    events += [dict(ph='X', cat='user_annotation', name='cor.' + n, ts=s,
                    dur=e - s) for n, s, e in spans]
    return harness.Trace.from_chrome(events, harness.Profiler.WINDOW)


def read(name, trace):
    return harness.load_reader(name)(Context(trace=trace))


def test_idle_split_at_span_boundaries():
    # idle 0-10, 20-60, 70-100 (80 us); the gap 20-60 crosses the
    # boundaries of three nested spans, 0-5 and 95-100 lie under none
    tr = trace_of([('k', 10, 20), ('k', 60, 70)],
                  [('processors.page', 5, 95),
                   ('api.correct_lines', 15, 80),
                   ('api.dispatch', 25, 50),
                   ('decoders.beam_iteration', 30, 40),
                   ('decoders.beam_iteration', 40, 45)])
    # processors 0-5 of 5-10 and 80-95: 20 us
    assert read('idle_in_processors.page', tr) == pytest.approx(20 / 80)
    # api: 20-30, 45-60, 70-80: 35 us
    assert read('idle_in_api.page', tr) == pytest.approx(35 / 80)
    # decoders: 30-45: 15 us
    assert read('idle_in_decoders.page', tr) == pytest.approx(15 / 80)
    assert read('beam_iteration_ms.page', tr) == pytest.approx(0.0075)


def test_idle_under_a_span_and_its_children():
    # idle 0-20, 25-60, 65-100 (90 us)
    tr = trace_of([('k', 20, 25), ('k', 60, 65)],
                  [('training.step', 5, 95),
                   ('training.forward', 10, 50),
                   ('decoders.encode', 12, 30),
                   ('training.backward', 50, 80)])
    assert read('idle_in_forward.train', tr) == pytest.approx(35 / 90)
    assert read('idle_in_backward.train', tr) == pytest.approx(25 / 90)


def test_a_program_without_spans_reads_nothing():
    import torch
    from cor_asv_ann_tpu_torch.utils import profiling
    # a profiler session in which the program records nothing
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.snapshot() == {'spans': {}, 'counters': {}}
    tr = trace_of([('k', 10, 20)], [])
    for name in PAGE_METRICS + TRAIN_METRICS:
        assert read(name, tr) is None
        assert read(name, None) is None


def test_beam_live_share_reads_the_tracer():
    import torch
    from cor_asv_ann_tpu_torch.utils import profiling
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count('decoders.beam_rows', 64)
        profiling.count('decoders.beam_live_rows', 40)
    tr = trace_of([('k', 10, 20)], [])
    assert read('beam_live_share.page', tr) == pytest.approx(40 / 64)


@pytest.mark.parametrize('cell,names', [(PAGES, PAGE_METRICS),
                                        (TRAIN, TRAIN_METRICS)])
def test_a_tiny_traced_run_reports_every_new_metric(cell, names):
    result, checks = tiny_run(cell, seconds=0.2, trace=True)
    assert result['correct'], checks
    metrics = result['metrics']
    for name in names:
        value = metrics[name]['value']
        if metrics[name]['unit'] == 'share':
            assert 0.0 <= value <= 1.0, (name, value)
        else:
            assert value > 0, (name, value)
    shares = [metrics[n]['value'] for n in names if n.startswith('idle_in')]
    assert sum(shares) <= 1.0 + 1e-9
