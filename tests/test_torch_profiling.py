"""PyTorch port: utils/profiling.py and ``--torch-trace`` on the command
lines, against the JAX package's profiling helpers.

`maybe_profile` keeps the JAX helper's cProfile behaviour (stats to a
file or the 30 costliest calls to stderr, the wall time to the logger)
and writes a ``torch.profiler`` Chrome trace where the JAX one writes a
``jax.profiler`` trace. ``proc`` and ``eval`` with ``--torch-trace``
write the same output as without it. The tracer's spans and counters:
tests/test_torch_tracing.py.
"""

import glob
import json
import logging
import os
import pstats

import pytest
import torch
from click.testing import CliRunner

from cor_asv_ann_tpu.models.api import Sequence2Sequence as JaxS2S
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu.utils.data import CharMapping as JaxCharMapping
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.scripts import eval as eval_cli
from cor_asv_ann_tpu_torch.scripts import proc
from cor_asv_ann_tpu_torch.utils import profiling
from cor_asv_ann_tpu_torch.utils.data import CharMapping
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

CHARS = "abcdefghij .,\n"
LINES = ["abba dig.\n", "chef i gad.\n", "hi.\n"]


def _work():
    return sum(range(1000))


def test_cprofile_to_a_file_and_to_stderr(tmp_path, capsys, caplog):
    prof_file = tmp_path / 'out.prof'
    logger = logging.getLogger('profiling-test')
    with caplog.at_level(logging.INFO, logger='profiling-test'):
        with profiling.maybe_profile(profile_file=str(prof_file),
                                     logger=logger):
            _work()
    stats = pstats.Stats(str(prof_file))
    assert any(fn[2] == '_work' for fn in stats.stats)
    assert [r.getMessage().split(':')[0] for r in caplog.records] \
        == ['wall time']
    capsys.readouterr()
    with profiling.maybe_profile(profile=True):
        _work()
    err = capsys.readouterr().err
    assert 'function calls' in err and 'cumulative' in err
    assert '_work' in err


def test_chrome_trace_on_the_cpu(tmp_path):
    trace_dir = tmp_path / 'trace'
    with profiling.maybe_profile(trace_dir=str(trace_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(trace_dir / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'aten::mm' for e in events)


def test_body_errors_pass_through(tmp_path):
    with pytest.raises(KeyError):
        with profiling.maybe_profile(profile_file=str(tmp_path / 'p'),
                                     trace_dir=str(tmp_path / 't')):
            raise KeyError('x')
    # cProfile still wrote its stats, as in the JAX helper
    assert (tmp_path / 'p').exists()


def _tiny_model(tmp_path):
    """The same tiny model (width 8, depth 2, peaked readout) saved from
    the port, and its JAX twin."""
    pair = []
    for cls, mapping, kw in ((JaxS2S, JaxCharMapping, {}),
                             (Sequence2Sequence, CharMapping,
                              {'device': 'cpu'})):
        s2s = cls(**kw)
        s2s.mapping = mapping.from_texts([CHARS])
        s2s.width, s2s.depth = 8, 2
        s2s.configure()
        params = init_params(s2s.config, seed=7)
        params['char_embedding']['kernel'] *= 400.0
        s2s.params = params
        s2s.status = 2
        pair.append(s2s)
    model = str(tmp_path / 'tiny.h5')
    pair[1].save(model)
    return model, pair


@pytest.mark.parametrize('fast', [True, False])
def test_proc_and_eval_with_a_trace(tmp_path, fast):
    """``proc`` writes the same file with and without ``--torch-trace``
    (and the JAX package's text), the trace names the decoder's
    operations; ``eval`` exits 0 with a trace."""
    model, (jax_s2s, _) = _tiny_model(tmp_path)
    src = tmp_path / 'page.txt'
    src.write_text(''.join(LINES), encoding='utf-8')
    out = tmp_path / 'page.cor.txt'
    fast_args = ['-f'] if fast else []
    runner = CliRunner()
    texts = []
    for extra in ([], ['--torch-trace', str(tmp_path / 'trace')]):
        res = runner.invoke(proc.cli, ['-m', model, '--device', 'cpu']
                            + fast_args + extra + [str(src)])
        assert res.exit_code == 0, res.output
        texts.append(out.read_text(encoding='utf-8'))
        out.unlink()
    jax_s2s.rejection_threshold = 0.5      # the command line's default
    want, _, _, _ = jax_s2s.correct_lines(LINES, fast=fast, greedy=fast,
                                          return_alignments=False)
    assert texts[0] == texts[1] == ''.join(want)
    files = glob.glob(str(tmp_path / 'trace' / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'aten::tanh' in names
    data = tmp_path / 'gt.tsv'
    data.write_text(''.join('%s\t%s\n' % (line.rstrip('\n'), w.rstrip('\n'))
                            for line, w in zip(LINES, want)),
                    encoding='utf-8')
    eval_trace = tmp_path / 'eval_trace'
    res = runner.invoke(eval_cli.cli, ['-m', model, '--device', 'cpu', '-c',
                                       '3', '--torch-trace', str(eval_trace)]
                        + fast_args + [str(data)])
    assert res.exit_code == 0, res.output
    assert len(os.listdir(eval_trace)) == 1
