"""PyTorch port: the tracer of utils/profiling.py.

Off, a span is one shared do-nothing context and the record does not
change. On (under ``torch.profiler`` or in a `maybe_profile` block),
the spans of the processor, API, decoder and training layers lie in the
profiler's Chrome trace as nested ``cor.*`` annotations, their totals
and self times and the beam's counters add up, each profiler session
starts an empty record, and the beam's and a training step's results are
bit for bit those of an untraced run.
"""

import json
import logging

import pytest
import torch

from cor_asv_ann_tpu_torch.models import beam
from cor_asv_ann_tpu_torch.models import train as PT
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models.params import params_from_numpy, tree_map
from cor_asv_ann_tpu_torch.utils import profiling
from cor_asv_ann_tpu_torch.utils.data import (CharMapping,
                                              lines_to_index_batch,
                                              vectorize_lines_indices)
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

CHARS = "abcdefghij .,\n"
LINES = ["abba dig.\n", "chef i gad.\n", "hi.\n"]
SOURCES = ["abba dig.\n", "hi,\n", "deaf bad cab.\n", "gag,\n"]
TARGETS = ["abba dig.\n", "hi,\n", "deaf bad cab.\n", "gag,\n"]


def _tiny_s2s():
    """A tiny model (width 8, depth 2, peaked readout) on the CPU."""
    s2s = Sequence2Sequence(device='cpu')
    s2s.mapping = CharMapping.from_texts([CHARS])
    s2s.width, s2s.depth = 8, 2
    s2s.configure()
    params = init_params(s2s.config, seed=7)
    params['char_embedding']['kernel'] *= 400.0
    s2s.params = params
    s2s.status = 2
    return s2s


def _beam_inputs(s2s, lines):
    enc = torch.from_numpy(lines_to_index_batch(s2s.mapping, lines))
    src_len = torch.tensor([len(line) for line in lines], dtype=torch.int32)
    return (s2s._infer_params(), s2s.config, s2s._beam_params(), enc,
            s2s.mapping.get('\n'), src_len)


def _profiled(fn, tmp_path):
    """Run `fn` under torch.profiler; its result and the Chrome trace's
    ``cor.*`` annotations as (name, start, end)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = [(e['name'][4:], float(e['ts']), float(e['ts']) + e['dur'])
             for e in events if e.get('ph') == 'X'
             and e.get('cat') == 'user_annotation'
             and e.get('name', '').startswith('cor.')]
    return out, spans


def _inside(spans, inner, outer):
    """Every `inner` span lies inside some `outer` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for n, s, e in spans if n == inner)


def _train_setup():
    mapping = CharMapping.from_texts([CHARS])
    config = Seq2SeqConfig(width=16, depth=2, voc_size=mapping.voc_size,
                           mask_padding=True, dropout=0.2)
    leaves = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(init_params(config, seed=9), 'cpu'))
    batch = vectorize_lines_indices(mapping, SOURCES, TARGETS)
    return config, leaves, PT.make_optimizer(leaves, 1e-2), batch


def _train_step(setup):
    config, leaves, opt, batch = setup
    return PT.train_step(leaves, opt, config, *batch,
                         torch.Generator().manual_seed(3))


def test_off_is_one_shared_context_that_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError('record_function opened for %s' % name)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    before = profiling.snapshot()
    first = profiling.span('api.dispatch')
    assert profiling.span('decoders.encode') is first
    with first:
        with profiling.span('x'):
            profiling.count('decoders.beam_rows', 5)
    assert profiling.tracer.active() is False
    assert profiling.snapshot() == before


def test_decode_beam_off_reads_the_host_once_an_iteration(monkeypatch):
    """Off: one read of a tensor on the host an iteration (and the one
    that ends the loop), no annotation, and the record does not change."""
    monkeypatch.setattr(torch.profiler, 'record_function', None)
    reads = []
    for method in ('__int__', '__bool__', '__float__', 'item', 'tolist'):
        def counted(self, *args, _read=getattr(torch.Tensor, method),
                    _name=method):
            reads.append(_name)
            return _read(self, *args)
        monkeypatch.setattr(torch.Tensor, method, counted)
    s2s = _tiny_s2s()
    inputs = _beam_inputs(s2s, LINES)
    before = profiling.snapshot()
    out = beam.decode_beam(*inputs, return_trace=True)
    monkeypatch.undo()
    assert reads == ['__int__'] * (int(out['trace']['t']) + 1)
    assert profiling.snapshot() == before


@pytest.mark.parametrize('path', ['beam_correct_lines', 'masked_train_step'])
def test_spans_nest_in_the_chrome_trace(tmp_path, path):
    if path == 'beam_correct_lines':
        s2s = _tiny_s2s()
        _, spans = _profiled(
            lambda: s2s.correct_lines(LINES, fast=False, greedy=False),
            tmp_path)
        nesting = [('api.dispatch', 'api.correct_lines'),
                   ('api.finish', 'api.correct_lines'),
                   ('api.probe', 'api.dispatch'),
                   ('decoders.encode', 'api.dispatch'),
                   ('decoders.beam_iteration', 'api.dispatch'),
                   ('decoders.backtrace', 'api.dispatch')]
    else:
        setup = _train_setup()
        _, spans = _profiled(lambda: _train_step(setup), tmp_path)
        nesting = [('training.forward', 'training.step'),
                   ('training.backward', 'training.step'),
                   ('training.update', 'training.step'),
                   ('decoders.encode', 'training.forward')]
    names = {n for n, _, _ in spans}
    for inner, outer in nesting:
        assert inner in names and outer in names
        assert _inside(spans, inner, outer), (inner, outer)
    snap = profiling.snapshot()['spans']
    for name in names:
        assert snap[name]['count'] == sum(n == name for n, _, _ in spans)


def test_self_time_is_total_less_the_children():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with profiling.span('a'):
            with profiling.span('b'):
                with profiling.span('c'):
                    sum(range(20000))
                sum(range(20000))
            with profiling.span('b'):
                sum(range(20000))
    snap = profiling.snapshot()['spans']
    assert snap['a']['count'] == 1 and snap['b']['count'] == 2
    assert snap['a']['self_s'] == snap['a']['total_s'] - snap['b']['total_s']
    assert snap['c']['self_s'] == snap['c']['total_s']
    assert snap['b']['self_s'] == pytest.approx(
        snap['b']['total_s'] - snap['c']['total_s'], rel=1e-12)
    assert 0 < snap['a']['self_s'] < snap['a']['total_s']


def test_beam_counters(tmp_path):
    s2s = _tiny_s2s()
    lines = LINES + [''] * 5          # padding rows of an 8-line bucket
    args = _beam_inputs(s2s, lines)
    out, spans = _profiled(lambda: beam.decode_beam(*args,
                                                    return_trace=True),
                           tmp_path)
    counters = profiling.snapshot()['counters']
    iterations = counters['decoders.beam_iterations']
    assert iterations == out['trace']['t'] > 0
    assert counters['decoders.beam_rows'] == iterations * 8
    assert 3 <= counters['decoders.beam_live_rows'] <= 3 * iterations
    assert sum(n == 'decoders.beam_iteration' for n, _, _ in spans) \
        == iterations


def test_each_profiler_session_starts_an_empty_record():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with profiling.span('first'):
            pass
        profiling.count('n', 2)
    assert profiling.snapshot() == {
        'spans': {'first': profiling.snapshot()['spans']['first']},
        'counters': {'n': 2}}
    with torch.profiler.profile(activities=acts):
        with profiling.span('second'):
            pass
        profiling.count('n', 3)
    snap = profiling.snapshot()
    assert set(snap['spans']) == {'second'}
    assert snap['spans']['second']['count'] == 1
    assert snap['counters'] == {'n': 3}


def test_a_profiler_session_after_a_maybe_profile_block_starts_empty(
        tmp_path):
    with profiling.maybe_profile(trace_dir=str(tmp_path / 'trace')):
        with profiling.span('api.finish'):
            profiling.count('decoders.beam_rows', 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.snapshot() == {'spans': {}, 'counters': {}}


def test_maybe_profile_logs_the_report(tmp_path, caplog):
    logger = logging.getLogger('tracing-test')
    with caplog.at_level(logging.INFO, logger='tracing-test'):
        with profiling.maybe_profile(profile_file=str(tmp_path / 'p'),
                                     logger=logger):
            assert profiling.tracer.active()
            with profiling.span('api.finish'):
                profiling.count('decoders.beam_rows', 64)
    assert not profiling.tracer.active()
    [record] = caplog.records
    text = record.getMessage()
    assert text.startswith('wall time: ')
    assert text.split('\n', 1)[1] == profiling.report()
    lines = profiling.report().splitlines()
    assert lines[0] == 'span timing:'
    assert lines[1].split()[0] == 'api.finish' and lines[1].endswith('1 calls')
    assert lines[2].split() == ['decoders.beam_rows', '64']


def test_train_cli_profile_logs_the_training_phases(tmp_path, monkeypatch,
                                                    caplog):
    """``train --profile-file`` logs the step's phases beside the wall
    time: each step's forward, backward and update inside it."""
    from click.testing import CliRunner
    from cor_asv_ann_tpu_torch.scripts import train as train_cli
    data = tmp_path / 'train.tsv'
    data.write_text(''.join('%s\t%s' % (s.rstrip('\n'), t)
                            for s, t in zip(SOURCES * 4, TARGETS * 4)))
    monkeypatch.setenv('CORASVANN_TEST_EPOCHS', '1')
    with caplog.at_level(logging.INFO, logger=train_cli.__name__):
        res = CliRunner().invoke(train_cli.cli, [
            '-m', str(tmp_path / 'm.h5'), '-w', '8', '-d', '2',
            '--device', 'cpu', '--profile-file', str(tmp_path / 'p'),
            str(data)])
    assert res.exit_code == 0, res.output
    [text] = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith('wall time: ')]
    calls = {line.split()[0]: int(line.split()[-2])
             for line in text.splitlines()[2:] if line.endswith(' calls')}
    assert calls['training.step'] >= 1
    for phase in ('training.forward', 'training.backward',
                  'training.update'):
        assert calls[phase] == calls['training.step']
    assert (tmp_path / 'p').exists()


def test_beam_is_bit_identical_with_the_tracer_on(tmp_path):
    s2s = _tiny_s2s()
    args = _beam_inputs(s2s, LINES + [''])
    off = beam.decode_beam(*args, return_alignments=True)
    on, spans = _profiled(lambda: beam.decode_beam(
        *args, return_alignments=True), tmp_path)
    assert spans
    for key in ('idx', 'prob', 'length', 'count', 'align_row'):
        assert torch.equal(off[key], on[key]), key


def test_train_step_is_bit_identical_with_the_tracer_on(tmp_path):
    off_setup, on_setup = _train_setup(), _train_setup()
    losses = [_train_step(off_setup)]
    out, spans = _profiled(lambda: _train_step(on_setup), tmp_path)
    losses.append(out)
    assert spans
    assert torch.equal(losses[0], losses[1])
    for a, b in zip(PT.tree_leaves(off_setup[1]),
                    PT.tree_leaves(on_setup[1])):
        assert torch.equal(a, b)
