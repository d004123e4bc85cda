"""The metric readers: FLOP counts, the device trace's union, the
breakdown, the percentiles."""

import pytest

from tiny import ROOT  # noqa: F401

from portbench import harness
from portbench.run import Context

mfu = harness.load_reader('mfu.page').__globals__


def test_flops_by_hand():
    # V = 3, W = A = 2, window 1 (3 visible positions)
    cfg = {'width': 2, 'voc_size': 3, 'window_width': 1}
    # encoder a position: 2VW 12 + bi layer 2*16W^2 128 + second layer
    # 2(2W)(4W) 64 + 8W^2 32 + attention projection 2AW 8
    assert mfu['encoder_flops'](cfg, 1) == 244
    # decoder a step: 2VW 12 + 16W^2 64 + 2W^2 8 + 2*3*(W+A) 24
    # + 8W(W+A) 64 + 8W^2 32 + 2WV 12
    assert mfu['decoder_flops'](cfg, 1) == 216
    page = {'src_lens': [4, 2], 'out_lens': [3, 1]}
    assert mfu['unit_flops'](cfg, {'search': {'expand': 5}}, page) == (
        244 * 6 + 5 * 216 * 4)
    step = {'src_lens': [4, 2], 'tgt_lens': [3, 1]}
    assert mfu['unit_flops'](cfg, {}, step) == 3 * (244 * 6 + 216 * 4)


def test_mfu_in_percent_of_the_peak():
    cfg = {'width': 2, 'voc_size': 3, 'window_width': 1}
    units = [dict(t0=0.0, t1=1.0, traced=False, src_lens=[4],
                  tgt_lens=[3])]
    ctx = Context(workload={'compute': 'float32'}, config=cfg,
                  records=units)
    want = 100.0 * 3 * (244 * 4 + 216 * 3) / 67e12
    assert harness.load_reader('mfu.train')(ctx) == pytest.approx(want)


def trace_of(device, window=(0.0, 100.0), host=()):
    events = [dict(ph='X', cat='user_annotation', name=harness.Profiler.WINDOW,
                   ts=window[0], dur=window[1] - window[0])]
    events += [dict(ph='X', cat='kernel', name=n, ts=s, dur=e - s)
               for n, s, e in device]
    events += [dict(ph='X', cat='cpu_op', name=n, ts=s, dur=e - s)
               for n, s, e in host]
    return harness.Trace.from_chrome(events, harness.Profiler.WINDOW)


def test_device_idle_takes_the_union():
    # two overlapping kernels (10-30, 20-40) and one inside another
    # (50-60 in 45-70): busy 30 + 25 of a 100 us window
    tr = trace_of([('a', 10, 30), ('b', 20, 40), ('c', 45, 70),
                   ('d', 50, 60), ('e', 95, 120)])
    ctx = Context(trace=tr)
    assert tr.busy_s() == pytest.approx(60e-6)
    assert harness.load_reader('device_idle.page')(ctx) == \
        pytest.approx(0.4)
    assert len(tr.kernels()) == 5


def test_breakdown_names_gaps_by_host_activity():
    tr = trace_of([('k1', 0, 10), ('k2', 40, 50), ('k1', 55, 100)],
                  host=[('aten::item', 12, 38), ('aten::mm', 30, 39),
                        ('outer', 1, 99)])
    b = tr.breakdown()
    assert b['device_ops'][0][0] == 'k1'
    assert b['device_ops'][0][1] == pytest.approx(55e-6)
    assert b['idle_gaps'][0] == ['aten::item', pytest.approx(30e-6)]
    assert b['idle_gaps'][1][0] == 'outer'


def test_readers_without_a_trace_read_nothing():
    ctx = Context(trace=None, records=[], spans=harness.Spans())
    for name in ('device_idle.page', 'launches_per_line.page',
                 'launches_per_step.train', 'processor_self_share.page'):
        assert harness.load_reader(name)(ctx) is None


def test_page_tail_and_rate():
    units = [dict(t0=0.0, t1=0.01 * (i + 1), traced=False, lines=2)
             for i in range(20)]
    ctx = Context(records=units, window=(0.0, 4.0))
    # nearest rank: the 18th of 20
    assert harness.load_reader('page_p90_ms')(ctx) == pytest.approx(180.0)
    assert harness.load_reader('lines_per_s')(ctx) == pytest.approx(10.0)
    assert harness.load_reader('train_step_ms')(ctx) == pytest.approx(200.0)


def test_processor_self_share():
    spans = harness.Spans()
    spans.add('process_page', 0.0, 1.0, traced=True)
    spans.add('correct_lines', 0.1, 0.2)
    spans.add('process_page', 2.0, 3.0, traced=False)
    spans.add('correct_lines', 2.1, 2.8)
    spans.add('process_page', 3.0, 4.0, traced=False)
    spans.add('correct_lines', 3.0, 3.9)
    ctx = Context(spans=spans)
    assert harness.load_reader('processor_self_share.page')(ctx) == \
        pytest.approx(0.2)
