"""PyTorch port: beam serving and evaluation through ``Sequence2Sequence``
and the command lines, against the JAX package and the repo's goldens.

``correct_lines(greedy=False)`` on the CPU must give the JAX package's
text byte for byte (the search is discrete; scores within 1e-3, float32
summation order compounding through the recurrence of a weakly trained
model, as tests/test_torch_api.py measured for greedy), and on the
flagship the recorded beam goldens (scores within 2e-3, the bar of
tests/test_quality.py). One flagship mode runs in the default suite, all
six modes of the golden corpus under ``-m slow``.
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models.api import Sequence2Sequence as JaxS2S
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu.utils.data import CharMapping as JaxCharMapping
from cor_asv_ann_tpu_torch.models import api
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.utils.data import CharMapping
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, 'testmodels')
FLAGSHIP = os.path.join(MODELS, 'flagship.d2.w512.synthetic.h5')
ARTIFACT = os.path.join(MODELS, 'reference_trained.w64.h5')
CHARS = "abcdefghij .,\n"


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _load(cls, path, **kw):
    s2s = cls(**kw)
    s2s.load_config(path)
    s2s.configure()
    s2s.load_weights(path)
    return s2s


def _tiny_pair(seed, sharpen):
    """The same tiny model (width 8, depth 2) in both packages."""
    pair = []
    for cls, mapping, kw in ((JaxS2S, JaxCharMapping, {}),
                             (Sequence2Sequence, CharMapping,
                              {'device': 'cpu'})):
        s2s = cls(**kw)
        s2s.mapping = mapping.from_texts([CHARS])
        s2s.width, s2s.depth = 8, 2
        s2s.configure()
        params = init_params(s2s.config, seed=seed)
        if sharpen:
            params['char_embedding']['kernel'] *= 400.0
        s2s.params = params
        s2s.status = 2
        pair.append(s2s)
    return pair


@pytest.fixture(scope='module')
def artifact_pair():
    pair = (_load(JaxS2S, ARTIFACT), _load(Sequence2Sequence, ARTIFACT,
                                           device='cpu'))
    for s2s in pair:
        # pinned bounds keep the JAX side's compile and run short
        s2s.beam_reservoir, s2s.beam_expand = 32, 16
    return pair


@pytest.mark.parametrize('confidence', [None, 0.99, 0.95, 0.9, 0.85, 0.5])
@pytest.mark.parametrize('rejection', [0.3, 0.5])
def test_beam_params_tiers(confidence, rejection):
    """The adaptive bounds, tier by tier, equal to the JAX package's."""
    jax_s2s, s2s = JaxS2S(), Sequence2Sequence(device='cpu')
    for width_in, pinned in ((15, (None, None)), (40, (None, None)),
                             (15, (24, None)), (15, (None, 7))):
        for m in (jax_s2s, s2s):
            m.rejection_threshold = rejection
            m.beam_width_in = width_in
            m.beam_reservoir, m.beam_expand = pinned
            m.lm_predict = width_in == 40
        want, got = jax_s2s._beam_params(confidence), \
            s2s._beam_params(confidence)
        assert isinstance(got, api.BeamParams)
        assert vars(got) == vars(want)


def test_model_confidence_cache():
    """The probe agrees with the JAX package's, is cached per parameter
    set and dropped when the parameters are rebound."""
    jax_s2s, s2s = _tiny_pair(7, sharpen=True)
    lines = ["abba dig.\n", "chef i gad.\n", ""]
    from cor_asv_ann_tpu.utils.data import lines_to_index_batch
    enc = lines_to_index_batch(jax_s2s.mapping, lines)
    nl = s2s.mapping.get('\n')
    want = jax_s2s._model_confidence(jax_s2s._infer_params(), enc, nl)
    got = s2s._model_confidence(s2s._infer_params(), torch.from_numpy(enc),
                                nl)
    assert 0.0 < got <= 1.0
    assert abs(got - want) < 1e-4
    # cached: a second call does not decode (it would raise on None)
    assert s2s._model_confidence(None, None, nl) == got
    s2s.params = copy.deepcopy(s2s.params)
    with pytest.raises(TypeError):
        s2s._model_confidence(None, None, nl)
    s2s.load_config(ARTIFACT)
    s2s.configure()
    s2s.load_weights(ARTIFACT)
    assert s2s._conf_cache[0] is not s2s.params


@pytest.mark.parametrize('sharpen,rejection', [(True, 0.3), (True, 0.0),
                                               (False, 0.5)])
def test_correct_lines_beam_matches_jax_tiny(sharpen, rejection, caplog):
    """Auto bounds (so the probe runs), an empty line, alignments, and
    at rejection 0 an admission threshold no candidate can meet: the
    beam finds no solution, and the input is echoed."""
    jax_s2s, s2s = _tiny_pair(7 if sharpen else 0, sharpen)
    lines = ["abba dig.\n", "", "chef i gad.\n", "hi.\n"]
    for m in (jax_s2s, s2s):
        m.rejection_threshold = rejection
        if rejection == 0.0:
            m.beam_threshold_in = 2.0
    want = jax_s2s.correct_lines(lines, fast=False, greedy=False)
    with caplog.at_level('ERROR'):
        got = s2s.correct_lines(lines, fast=False, greedy=False)
    assert got[0] == want[0]
    assert got[0][1] == '' and got[1][1] == [] and got[3][1] == []
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)
    for a, b in zip(got[1] + got[3], want[1] + want[3]):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=5e-3)
    if rejection == 0.0:
        # echoed with unit probabilities and an identity alignment
        assert 'cannot beam-decode input line 3' in caplog.text
        assert got[0] == lines and got[1][3] == [1.0] * 4
        assert got[2][3] == 0 and got[3][3] == np.eye(4).tolist()


def _conf_inputs(gold, kind, n):
    if kind == 'plain':
        return list(gold['sources'][:n]), None
    if kind == 'probline':
        entries = gold['probline_inputs'][:n]
        return ([''.join(ch for ch, _ in e) for e in entries],
                [[p for _, p in e] for e in entries])
    confmat = [[[tuple(alt) for alt in chunk] for chunk in e]
               for e in gold[kind + '_inputs'][:n]]
    return ([''.join(c[0][0] if c else '' for c in e) for e in confmat],
            confmat)


@pytest.mark.parametrize('kind', ['plain', 'probline', 'confmat',
                                  'confmat_multi'])
def test_correct_lines_beam_matches_jax_artifact(artifact_pair, kind):
    """The reference-trained w64 model on each input format."""
    jax_s2s, s2s = artifact_pair
    lines, conf = _conf_inputs(_json(MODELS,
                                     'reference_trained.goldens.json'),
                               kind, 6)
    want = jax_s2s.correct_lines(lines, conf=conf, fast=False, greedy=False,
                                 return_alignments=False)
    got = s2s.correct_lines(lines, conf=conf, fast=False, greedy=False,
                            return_alignments=False)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)
    assert got[3] == [[] for _ in lines]


def test_bf16_beam_agrees_with_jax_artifact(artifact_pair):
    """bfloat16 beams on the 48 plain golden lines of the w64 artifact,
    counted against the JAX package's bfloat16 beam. Window positions
    follow the JAX beam's rounding in every bucket; what still parts the
    two is elementwise rounding inside XLA's fusions (an ulp of a state),
    which a search of 48 lines amplifies, so this is a count, not
    equality (12 of 48 lines, where float32 positions gave 10)."""
    lines = list(_json(MODELS, 'reference_trained.goldens.json')['sources'])
    outputs = []
    try:
        for s2s in artifact_pair:
            s2s.compute = 'bfloat16'
            outputs.append(s2s.correct_lines(lines, fast=False, greedy=False,
                                             return_alignments=False)[0])
    finally:
        for s2s in artifact_pair:
            s2s.compute = 'float32'
    want, got = outputs
    assert len(got) == len(lines) and all(g.endswith('\n') for g in got)
    equal = sum(a == b for a, b in zip(got, want))
    assert equal >= 12, equal


def test_fast_without_greedy_is_refused(artifact_pair):
    _, s2s = artifact_pair
    with pytest.raises(AssertionError, match='fast mode'):
        s2s.correct_lines(['abc\n'], fast=True, greedy=False)
    with pytest.raises(AssertionError, match='fast mode'):
        next(s2s.predict([], fast=True, greedy=False))


def test_expand_windowed_alignment():
    rows = np.arange(8, dtype=np.float32).reshape(2, 4) + 1
    got = api._expand_windowed_alignment(rows, np.array([0, 4]), 6)
    assert got.shape == (2, 6)
    assert got[0].tolist() == [1, 2, 3, 4, 0, 0]
    # the tail beyond T is dropped and never overwrites column T-1
    assert got[1].tolist() == [0, 0, 0, 0, 5, 6]


def _write_tsv(path, gold, n):
    with open(path, 'w', encoding='utf-8') as f:
        for src, tgt in zip(gold['sources'][:n], gold['targets'][:n]):
            f.write('%s\t%s\n' % (src.rstrip('\n'), tgt.rstrip('\n')))


@pytest.mark.parametrize('fast', [False, True])
def test_evaluate_matches_jax(artifact_pair, tmp_path, fast):
    jax_s2s, s2s = artifact_pair
    data = str(tmp_path / 'gt.tsv')
    _write_tsv(data, _json(MODELS, 'reference_trained.goldens.json'), 10)
    want = jax_s2s.evaluate([data], fast=fast)
    got = s2s.evaluate([data], fast=fast)
    assert set(got) == set(want) == {'OCR', 'greedy', 'beamed'}
    for kind in want:
        assert set(got[kind]) == set(want[kind])
        for key, value in want[kind].items():
            if isinstance(value, float):
                assert math.isclose(got[kind][key], value, rel_tol=1e-3,
                                    abs_tol=1e-6), (kind, key)
            else:
                assert got[kind][key] == value, (kind, key)
    if fast:
        assert got['beamed'] == got['greedy']


def test_proc_eval_repl_cli(tmp_path, capsys):
    """`proc` without -f (beam search, the default), `eval` and `repl`
    through click's runner on the CPU, on a tiny model saved to a file."""
    from click.testing import CliRunner
    from cor_asv_ann_tpu_torch.scripts import eval as eval_cli
    from cor_asv_ann_tpu_torch.scripts import proc, repl
    _, s2s = _tiny_pair(7, sharpen=True)
    model = str(tmp_path / 'tiny.h5')
    s2s.save(model)
    lines = ["abba dig.\n", "chef i gad.\n", "hi.\n"]
    src = tmp_path / 'page.txt'
    src.write_text(''.join(lines), encoding='utf-8')
    runner = CliRunner()
    res = runner.invoke(proc.cli, ['-m', model, '--device', 'cpu', str(src)])
    assert res.exit_code == 0, res.output
    s2s.rejection_threshold = 0.5          # the command line's default
    want, _, _, _ = s2s.correct_lines(lines, fast=False, greedy=False,
                                      return_alignments=False)
    assert (tmp_path / 'page.cor.txt').read_text(encoding='utf-8') \
        == ''.join(want)
    data = tmp_path / 'gt.tsv'
    data.write_text(''.join('%s\t%s\n' % (line.rstrip('\n'), out.rstrip('\n'))
                            for line, out in zip(lines, want)),
                    encoding='utf-8')
    res = runner.invoke(eval_cli.cli, ['-m', model, '--device', 'cpu', '-c',
                                       '3', str(data)])
    assert res.exit_code == 0, res.output
    # the console starts, and ends at the end of its input
    res = runner.invoke(repl.cli, ['--device', 'cpu'], input='')
    assert res.exit_code == 0, res.output
    transcode_line = repl.make_transcode_line(Sequence2Sequence(device='cpu'))
    assert transcode_line('abc') == (None, None)
    capsys.readouterr()
    greedy, beamed = repl.make_transcode_line(s2s)('abba dig.', plot=False)
    assert beamed == want[0] and greedy.endswith('\n')
    shown = capsys.readouterr().out
    assert 'greedy: ' in shown and 'beamed: %r' % beamed in shown


def test_entry_points_need_a_gpu_by_default(tmp_path):
    """Without --device cpu the command lines run on CUDA and fail where
    there is no GPU, instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is visible')
    from click.testing import CliRunner
    from cor_asv_ann_tpu_torch.scripts import eval as eval_cli
    from cor_asv_ann_tpu_torch.scripts import proc, repl
    src = tmp_path / 'page.txt'
    src.write_text('abc\tabc\n', encoding='utf-8')
    for cli, args in ((proc.cli, ['-m', ARTIFACT, str(src)]),
                      (eval_cli.cli, ['-m', ARTIFACT, str(src)]),
                      (repl.cli, [])):
        res = CliRunner().invoke(cli, args, input='')
        assert res.exit_code != 0
        assert isinstance(res.exception, RuntimeError)
        assert 'CUDA' in str(res.exception)


@pytest.fixture(scope='module')
def flagship():
    return _load(Sequence2Sequence, FLAGSHIP, device='cpu')


def test_flagship_golden_beamed(flagship):
    """tests/golden_decodes.json `beamed` (rejection 0.5, as
    tests/test_quality.py decodes it), byte for byte."""
    golden = _json(ROOT, 'tests', 'golden_decodes.json')
    flagship.rejection_threshold = 0.5
    out, probs, scores, _ = flagship.correct_lines(
        golden['inputs'], fast=False, greedy=False, return_alignments=False)
    assert out == golden['beamed']
    assert all(len(p) == len(o) for p, o in zip(probs, out))
    assert all(math.isfinite(s) and s >= 0 for s in scores)


BEAM_MODES = [('beam_r00_plain', 'plain', 0.0),
              ('beam_r03_plain', 'plain', 0.3),
              ('beam_r03_probline', 'probline', 0.3),
              ('beam_r03_confmat', 'confmat', 0.3),
              ('beam_r03_confmat_multi', 'confmat_multi', 0.3),
              ('beam_r05_plain', 'plain', 0.5)]


@pytest.mark.slow
@pytest.mark.parametrize('name,kind,rejection', BEAM_MODES)
def test_flagship_golden_corpus_beam_modes(flagship, name, kind, rejection):
    """All six beam modes of tests/golden_corpus.json byte for byte,
    scores within 2e-3."""
    golden = _json(ROOT, 'tests', 'golden_corpus.json')
    inputs = golden['inputs']
    if kind == 'plain':
        lines, conf = inputs['plain'], None
    elif kind == 'probline':
        lines = [''.join(c for c, _ in e) for e in inputs['probline']]
        conf = [[p for _, p in e] for e in inputs['probline']]
    else:
        conf = [[[tuple(alt) for alt in chunk] for chunk in e]
                for e in inputs[kind]]
        lines = [''.join(ch[0][0] if ch else '' for ch in e) for e in conf]
    flagship.rejection_threshold = rejection
    out, _, scores, _ = flagship.correct_lines(
        lines, conf=conf, fast=False, greedy=False, return_alignments=False)
    want = golden['modes'][name]
    assert out == want['output']
    np.testing.assert_allclose(scores, want['scores'], atol=2e-3)
