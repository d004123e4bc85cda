"""PyTorch port: ocrd-cor-asv-ann-process end to end on a tiny model.

Counterparts of tests/test_e2e_workspace.py for the port's
``wrapper/transcode.py``. The JAX test trains a toy model in-process;
here a tiny random model (width 16, depth 2, peaked embedding so that
decodes end) goes through both packages' processors on the same
workspace, and the port must write the JAX processor's PAGE-XML: the
same element tree, ids, coordinates and texts at every level, every
``conf`` within 1e-4 (measured on the CPU: 1e-7 at most). The
consistency invariants of the JAX test hold on the port's output. Also
the processor's ``device`` parameter (CUDA by default, raising without
a GPU) and the port's ocrd-tool.json.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from cor_asv_ann_tpu.utils import page as JP
from cor_asv_ann_tpu.utils import workspace as JW
from cor_asv_ann_tpu.wrapper import transcode as JTC
from cor_asv_ann_tpu_torch.utils import page as TP
from cor_asv_ann_tpu_torch.utils import workspace as TW
from cor_asv_ann_tpu_torch.wrapper import transcode as TTC
from torch_port_fixtures import single_threaded_cpu  # noqa: F401
from torch_wrapper_pages import build_page, compare_pages, write_workspace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARS = 'abcdefghij'
LINES = ['abba dig chef', 'i gad hij', 'bad cab fig jig', 'ceda bi',
         'hide a bead', 'jab fed gabe']
CONF_TOL = 1e-4


@pytest.fixture(scope='module')
def tiny_model_file(tmp_path_factory):
    """A tiny random model over a-j (width 16, depth 2), its embedding
    scaled so that the decodes are peaked and end."""
    from cor_asv_ann_tpu.models.config import Seq2SeqConfig, init_params
    from cor_asv_ann_tpu.utils import io_h5
    from cor_asv_ann_tpu.utils.data import CharMapping
    mapping = CharMapping.from_texts([CHARS + ' .,\n'])
    config = Seq2SeqConfig(width=16, depth=2, voc_size=mapping.voc_size)
    params = init_params(config, seed=1)
    params['char_embedding']['kernel'] *= 300.0
    path = str(tmp_path_factory.mktemp('model') / 'tiny.h5')
    io_h5.save_model(path, params, config, mapping)
    return path


def tiny_pages(P):
    return {'p1': build_page(P, LINES[:3], seed=1, alt_chars=CHARS)
            .to_bytes(),
            'p2': build_page(P, LINES[3:], seed=2, alt_chars=CHARS)
            .to_bytes()}


def run_processor(cls, P, W, root, params, pages):
    ws = write_workspace(W.make_workspace, str(root), pages(P))
    cls(parameter=params).process_workspace(ws, ['OCR'], 'COR')
    out = {}
    for pid, f in ws.page_files('COR').items():
        with open(f.path, 'rb') as fh:
            out[pid] = fh.read()
    return out


def run_both(tmp_path, params, pages=tiny_pages):
    """The JAX and the port's processor on the same workspace; returns
    the port's output pages after holding them against the JAX ones."""
    want = run_processor(JTC.ANNCorrection, JP, JW, tmp_path / 'jax',
                         params, pages)
    got = run_processor(TTC.ANNCorrection, TP, TW, tmp_path / 'port',
                        dict(params, device='cpu'), pages)
    assert sorted(got) == sorted(want)
    for pid in want:
        worst, parted = compare_pages(want[pid], got[pid], CONF_TOL)
        assert not parted
    return got


def check_consistency(doc, level):
    """The JAX e2e test's invariants: confidences in (0, 1], words
    joined by single spaces give the line, glyphs give their word, and
    the levels below `level` are gone."""
    for line in doc.get_lines():
        tes = line.get_textequivs()
        assert tes and tes[0].conf is not None
        assert 0 < tes[0].conf <= 1
        if level == 'line':
            assert line.get_words() == []
            continue
        words = line.get_words()
        assert ' '.join(w.get_text() or '' for w in words) == \
            line.get_text()
        for w in words:
            glyphs = w.get_glyphs()
            if level == 'word':
                assert glyphs == []
            elif glyphs:
                assert ''.join(g.get_text() or '' for g in glyphs) == \
                    (w.get_text() or '')


@pytest.mark.parametrize('level', ['line', 'word', 'glyph'])
@pytest.mark.parametrize('fast', [True, False])
def test_transcode_workspace(tiny_model_file, tmp_path, level, fast):
    got = run_both(tmp_path, {'model_file': tiny_model_file,
                              'textequiv_level': level, 'fast_mode': fast,
                              'rejection_threshold': 0.1})
    for data in got.values():
        doc = TP.parse_page(data)
        assert len(doc.get_lines()) == 3
        check_consistency(doc, level)


def merged_glyph_pages(P):
    """A page with the confmat format's distinctive glyph cases
    (reference transcode.py:236-277): a MERGED glyph whose text spans
    two characters, an EMPTY glyph (OCR rejection -> GAP char), and a
    glyph with a second, differing-length alternative."""
    doc = P.new_page()
    region = P.add_region(doc, 'r1')
    line = P.add_line(region, 'l1', points=[(0, 0), (200, 18)])
    word = P.add_word(line, 'w1', points=[(0, 0), (120, 18)])
    for gi, (text, alt) in enumerate([('a', None), ('bc', 'b'), ('', None),
                                      ('d', 'a')]):
        glyph = P.add_glyph(word, f'g{gi + 1}',
                            points=[(gi * 30, 0), (gi * 30 + 28, 18)])
        glyph.add_textequiv(text, conf=0.8)
        if alt is not None:
            glyph.add_textequiv(alt, conf=0.3)
    word.add_textequiv('abcd', conf=0.8)
    line.add_textequiv('abcd', conf=0.8)
    return {'p1': doc.to_bytes()}


@pytest.mark.parametrize('fast', [True, False])
def test_transcode_merged_and_empty_glyphs(tiny_model_file, tmp_path, fast):
    """Glyph-level correction over merged and empty glyphs: the confmat
    holds a multi-char chunk and a GAP-char chunk, and the output equals
    the JAX processor's and holds the consistency invariants."""
    from cor_asv_ann_tpu_torch.utils.data import GAP
    doc = TP.parse_page(merged_glyph_pages(TP)['p1'])
    seqs = TTC._page_get_line_sequences_at('glyph', doc)
    chunks = TTC._line_sequences2confmat_sequences({'a': 1}, seqs)[0][0]
    assert any(len(alt[0]) > 1 for chunk in chunks for alt in chunk)
    assert any(alt[0] == GAP for chunk in chunks for alt in chunk)
    assert any(len({len(a[0]) for a in chunk}) > 1 for chunk in chunks)

    got = run_both(tmp_path, {'model_file': tiny_model_file,
                              'textequiv_level': 'glyph', 'fast_mode': fast,
                              'rejection_threshold': 0.1},
                   pages=merged_glyph_pages)
    (line,) = TP.parse_page(got['p1']).get_lines()
    assert line.get_text()
    check_consistency(TP.parse_page(got['p1']), 'glyph')
    for w in line.get_words():
        for g in w.get_glyphs():
            assert GAP not in (g.get_text() or '')


def test_transcode_deployment_modes(tiny_model_file, tmp_path):
    """The port's processor behind its processor server, with METS access
    through its METS server: byte-identical to the direct run, the model
    loaded once for two jobs."""
    from cor_asv_ann_tpu_torch.utils.mets_server import MetsServer
    from cor_asv_ann_tpu_torch.wrapper.server import (
        ProcessorServer, client_process)
    params = {'model_file': tiny_model_file, 'textequiv_level': 'word',
              'fast_mode': True, 'rejection_threshold': 0.1,
              'device': 'cpu'}
    baseline = run_processor(TTC.ANNCorrection, TP, TW, tmp_path / 'direct',
                             params, tiny_pages)
    ws_dir = str(tmp_path / 'served')
    write_workspace(TW.make_workspace, ws_dir, tiny_pages(TP))
    sock = str(tmp_path / 'mets.sock')
    mets = MetsServer(ws_dir, sock).start()
    server = ProcessorServer(TTC.ANNCorrection, '127.0.0.1:0').start()
    try:
        job = {'workspace': ws_dir, 'mets_server_url': sock,
               'input_file_grp': 'OCR', 'output_file_grp': 'COR',
               'parameter': params}
        assert client_process(server.address, job)['ok']
        assert client_process(server.address, dict(
            job, output_file_grp='COR2'))['ok']
        assert len(server._cache) == 1
    finally:
        server.stop()
        mets.stop()
    ws = TW.Workspace(ws_dir)
    for grp in ('COR', 'COR2'):
        for pid, f in ws.page_files(grp).items():
            with open(f.path, 'rb') as fh:
                assert fh.read() == baseline[pid]


def test_device_defaults_to_cuda_and_raises_without_gpu(tiny_model_file,
                                                       monkeypatch):
    """Without `device` the processor serves on CUDA; where no GPU is
    visible it raises instead of serving on the CPU."""
    assert TTC.ANNCorrection.parameter_schema['device']['default'] == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TTC.ANNCorrection(parameter={'model_file': tiny_model_file})
    proc = TTC.ANNCorrection(parameter={'model_file': tiny_model_file,
                                        'device': 'cpu'})
    assert proc.s2s.device.type == 'cpu'


def test_cli_runs_as_module(tiny_model_file, tmp_path):
    """``python -m cor_asv_ann_tpu_torch.wrapper.transcode`` with
    ``-P device cpu`` writes the in-process run's bytes; without it and
    without a GPU it fails."""
    params = {'model_file': tiny_model_file, 'textequiv_level': 'glyph',
              'device': 'cpu'}
    baseline = run_processor(TTC.ANNCorrection, TP, TW, tmp_path / 'direct',
                             params, tiny_pages)
    ws_dir = str(tmp_path / 'cli')
    write_workspace(TW.make_workspace, ws_dir, tiny_pages(TP))
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='')
    cmd = [sys.executable, '-m', 'cor_asv_ann_tpu_torch.wrapper.transcode',
           '-m', ws_dir, '-I', 'OCR', '-P', 'model_file', tiny_model_file]
    run = subprocess.run(cmd + ['-O', 'COR', '-P', 'device', 'cpu'],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ws = TW.Workspace(ws_dir)
    for pid, f in ws.page_files('COR').items():
        with open(f.path, 'rb') as fh:
            assert fh.read() == baseline[pid]
    run = subprocess.run(cmd + ['-O', 'COR2'], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0
    assert 'no CUDA device' in run.stderr


def test_ocrd_tool_json_matches_jax_but_device():
    """The port's ocrd-tool.json is the JAX package's with one added
    parameter, ``device``, on ocrd-cor-asv-ann-process only."""
    def load(pkg):
        with open(os.path.join(ROOT, pkg, 'wrapper', 'ocrd-tool.json'),
                  encoding='utf-8') as f:
            return json.load(f)
    port, ref = load('cor_asv_ann_tpu_torch'), load('cor_asv_ann_tpu')
    device = port['tools']['ocrd-cor-asv-ann-process']['parameters'].pop(
        'device')
    assert device['type'] == 'string' and device['default'] == 'cuda'
    assert port == ref
    schema = TTC.ANNCorrection.parameter_schema
    params = ref['tools']['ocrd-cor-asv-ann-process']['parameters']
    assert set(schema) == set(params) | {'device'}
    for name, spec in params.items():
        assert schema[name].get('default') == spec.get('default'), name
