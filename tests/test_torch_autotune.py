"""PyTorch port: the fused-decode autotune of models/api.py and ``proc
--autotune-fused``, against the JAX package.

`_pick_fused_bound` must return exactly what the JAX function returns,
on the cases of tests/test_fused_decode.py and on a sweep of ratio
dicts. `autotune_fused_decode` declines (None) where the whole-loop
kernel does not serve (float32 compute, a CPU device); with its support
predicate patched to hold on the CPU, where `decode_loop` runs its plain
twin, it times both routes and sets the window `_pick_fused_bound` picks
from the ratios it measured, and logs the winning batch sizes that the
window leaves out.
"""

import logging
import time

import pytest
from click.testing import CliRunner
from hypothesis import given, settings
from hypothesis import strategies as st

from cor_asv_ann_tpu.models.api import _pick_fused_bound as jax_pick
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu_torch.models import api
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.scripts import proc
from cor_asv_ann_tpu_torch.utils.data import CharMapping
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

CHARS = "abcdefghij .,\n"
LINES = ["abba dig.\n", "chef i gad.\n", "hi.\n"]

# tests/test_fused_decode.py::test_pick_fused_bound, with its expectations
JAX_CASES = [
    ({16: 1.2, 32: 1.1, 64: 1.15}, (1, 64)),
    ({16: 1.2, 32: 0.9, 64: 1.15}, (1, 16)),
    ({16: 1.2, 32: 1.05, 64: 0.8}, (1, 32)),
    ({}, (1, 16)),
    ({64: 0.5}, (1, 16)),
    ({16: 0.42, 32: 0.76, 64: 0.94}, (0, 0)),
    ({16: 0.9, 32: 1.2}, (32, 32)),
    ({16: 0.93, 32: 1.13, 64: 1.08}, (32, 64)),
]


@pytest.mark.parametrize('ratios,want', JAX_CASES)
def test_pick_fused_bound_jax_cases(ratios, want):
    assert api._pick_fused_bound(ratios) == jax_pick(ratios) == want


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(
    st.sampled_from([1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 128, 256, 1024]),
    st.one_of(st.sampled_from([0.0, 0.999, 1.0, 1.001]),
              st.floats(0.0, 4.0, allow_nan=False)),
    max_size=8), st.sampled_from([8, 16, 32]))
def test_pick_fused_bound_equals_jax(ratios, floor):
    assert api._pick_fused_bound(ratios, floor) == jax_pick(ratios, floor)


def test_dropped_wins():
    """ADVICE.md's disjoint regimes: the window (64, 128) leaves the
    measured B=16 win out, (1, 16) leaves 64 out; a window that holds
    every win drops none."""
    ratios = {16: 1.2, 32: 0.9, 64: 1.15, 128: 1.1}
    assert api._pick_fused_bound(ratios) == (64, 128)
    assert api._dropped_wins(ratios, (64, 128)) == [16]
    assert api._dropped_wins({16: 1.2, 32: 0.9, 64: 1.15}, (1, 16)) == [64]
    assert api._dropped_wins({16: 1.2, 32: 1.1}, (1, 32)) == []


def _tiny(compute):
    s2s = Sequence2Sequence(device='cpu')
    s2s.mapping = CharMapping.from_texts([CHARS])
    s2s.width, s2s.depth = 8, 2
    s2s.configure()
    params = init_params(s2s.config, seed=7)
    params['char_embedding']['kernel'] *= 400.0
    s2s.params = params
    s2s.status = 2
    s2s.compute = compute
    return s2s


@pytest.mark.parametrize('compute', ['float32', 'bfloat16'])
def test_autotune_declines_at_float32_and_on_the_cpu(compute):
    s2s = _tiny(compute)
    assert s2s.autotune_fused_decode() is None
    assert (s2s.fused_decode_min_b, s2s.fused_decode_max_b) \
        == (1, api.FUSED_DECODE_MAX_B)


def test_autotune_sets_the_picked_window(monkeypatch):
    """On the CPU with the support predicate patched: both routes run
    (the fused one through the kernel's plain twin) once untimed and
    `repeats` times timed at each batch size, and the window is
    `_pick_fused_bound` of the measured ratios."""
    monkeypatch.setattr(api, 'fused_greedy_supported', lambda p, c, t: True)
    calls = {'plain': [], 'fused': []}
    plain, fused = api.decode_greedy, api.decode_greedy_fused

    def spy(key, fn):
        def run(params, config, enc, newline, **kw):
            calls[key].append(tuple(enc.shape))
            return fn(params, config, enc, newline, **kw)
        return run

    monkeypatch.setattr(api, 'decode_greedy', spy('plain', plain))
    monkeypatch.setattr(api, 'decode_greedy_fused', spy('fused', fused))
    s2s = _tiny('bfloat16')
    result = s2s.autotune_fused_decode(batches=(2, 5), repeats=2, t=8)
    assert sorted(result['ratios']) == [2, 5]
    assert result['chosen'] == api._pick_fused_bound(result['ratios'])
    assert (s2s.fused_decode_min_b, s2s.fused_decode_max_b) \
        == result['chosen']
    assert calls['plain'] == calls['fused'] == [(2, 8)] * 3 + [(5, 8)] * 3


def test_autotune_logs_dropped_wins(monkeypatch, caplog):
    """Routes whose times make B=16 win, B=32 lose and B=64/128 win: the
    window is the JAX package's (64, 128), and the B=16 win it leaves out
    is logged at INFO."""
    monkeypatch.setattr(api, 'fused_greedy_supported', lambda p, c, t: True)
    loses = {32}

    def plain(params, config, enc, newline, **kw):
        time.sleep(0.004 if enc.shape[0] in loses else 0.02)

    def fused(params, config, enc, newline, **kw):
        time.sleep(0.02 if enc.shape[0] in loses else 0.004)

    monkeypatch.setattr(api, 'decode_greedy', plain)
    monkeypatch.setattr(api, 'decode_greedy_fused', fused)
    s2s = _tiny('bfloat16')
    with caplog.at_level(logging.INFO):
        result = s2s.autotune_fused_decode(batches=(16, 32, 64, 128),
                                           repeats=2, t=8)
    assert result['chosen'] == (64, 128)
    assert [b for b, r in result['ratios'].items() if r >= 1.0] \
        == [16, 64, 128]
    msgs = [r.getMessage() for r in caplog.records
            if r.levelno == logging.INFO]
    assert any('B = [16]' in m and '(64, 128)' in m for m in msgs), msgs


@pytest.mark.parametrize('compute', ['float32', 'bfloat16'])
def test_proc_autotune_fused(tmp_path, compute, caplog):
    """``proc -f --autotune-fused`` on the CPU: the autotune is skipped
    with the JAX command line's log line, exit 0, the same output as
    without the flag (the greedy decode of the model)."""
    s2s = _tiny('float32')
    model = str(tmp_path / 'tiny.h5')
    s2s.save(model)
    src = tmp_path / 'page.txt'
    src.write_text(''.join(LINES), encoding='utf-8')
    out = tmp_path / 'page.cor.txt'
    texts = []
    for extra in ([], ['--autotune-fused']):
        with caplog.at_level(logging.INFO):
            res = CliRunner().invoke(
                proc.cli, ['-m', model, '--device', 'cpu', '-f', '--compute',
                           compute] + extra + [str(src)])
        assert res.exit_code == 0, res.output
        texts.append(out.read_text(encoding='utf-8'))
        out.unlink()
    s2s.compute = compute
    want, _, _, _ = s2s.correct_lines(LINES, return_alignments=False)
    assert texts[0] == texts[1] == ''.join(want)
    assert 'fused decode unsupported here; autotune skipped' in [
        r.getMessage() for r in caplog.records]


def test_predict_decodes_a_short_file_as_its_own_batch(tmp_path,
                                                       monkeypatch):
    """A file shorter than `batch_size` reaches the decoder as a batch of
    its own bucket (8 lines here), not padded out to 256, so the fused
    window applies to it; `predict` still yields the padded batch, the
    padding as empty lines of score 0, as `proc` expects."""
    shapes = []
    plain = api.decode_greedy
    monkeypatch.setattr(api, 'decode_greedy', lambda p, c, enc, nl, **kw:
                        shapes.append(tuple(enc.shape)) or plain(
                            p, c, enc, nl, **kw))
    s2s = _tiny('float32')
    src = tmp_path / 'page.txt'
    src.write_text(''.join(LINES), encoding='utf-8')
    (names, lines, scores), = list(s2s.predict([str(src)], fast=True,
                                               greedy=True))
    assert shapes == [(8, 32)]
    want, _, want_scores, _ = s2s.correct_lines(LINES,
                                                return_alignments=False)
    assert names == [str(src)] * 3 + [None] * 253
    assert lines == want + [''] * 253
    assert scores == want_scores + [0] * 253
