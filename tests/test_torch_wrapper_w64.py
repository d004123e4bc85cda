"""PyTorch port: ocrd-cor-asv-ann-process on the reference-trained w64
model, at every textequiv_level with fast_mode on and off.

Two holds for each case, on a workspace of two pages made from the 48
source lines of testmodels/reference_trained.goldens.json:

- the processor's host code alone: the port's processor is given the
  JAX decoder's results for the confmat lines it built (which must equal
  the JAX processor's lines) and must then write the JAX processor's
  PAGE-XML byte for byte;
- end to end, each package on its own decoder: the same element tree,
  ids, coordinates and texts, every ``conf`` within 1e-4 for the beam
  (measured on the CPU: 8.9e-5). Greedy decoding of this weakly trained
  model compounds float32 summation-order noise along a line
  (tests/test_torch_api.py holds its scores within 1e-3): there the
  confs are held within 1e-3 and one line of a page may part ways
  (measured on the CPU with one torch thread: confs within 4.1e-4; at
  the word level one line of each page parted, the two decoders'
  per-step probabilities having drifted apart from ~1e-6 to ~1e-2 over
  the line's last steps).
"""

import json
import os

import pytest

from cor_asv_ann_tpu.utils import page as JP
from cor_asv_ann_tpu.utils import workspace as JW
from cor_asv_ann_tpu.wrapper import transcode as JTC
from cor_asv_ann_tpu_torch.utils import page as TP
from cor_asv_ann_tpu_torch.utils import workspace as TW
from cor_asv_ann_tpu_torch.wrapper import transcode as TTC
from torch_port_fixtures import single_threaded_cpu  # noqa: F401
from torch_wrapper_pages import build_page, compare_pages, write_workspace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, 'testmodels', 'reference_trained.w64.h5')


def pages(P):
    with open(os.path.join(ROOT, 'testmodels',
                           'reference_trained.goldens.json')) as f:
        lines = [line.strip() for line in json.load(f)['sources']]
    return {'p1': build_page(P, lines[:24], seed=1).to_bytes(),
            'p2': build_page(P, lines[24:], seed=2).to_bytes()}


def outputs(ws):
    out = {}
    for pid, f in ws.page_files('COR').items():
        with open(f.path, 'rb') as fh:
            out[pid] = fh.read()
    return out


@pytest.mark.parametrize('level', ['line', 'word', 'glyph'])
@pytest.mark.parametrize('fast', [True, False])
def test_transcode_w64_matches_jax(tmp_path, level, fast):
    params = {'model_file': ARTIFACT, 'textequiv_level': level,
              'fast_mode': fast}
    # the JAX processor, recording what its decoder was asked and gave
    jproc = JTC.ANNCorrection(parameter=params)
    calls = []
    decode = jproc.s2s.correct_lines

    def recorded(lines, **kw):
        calls.append((lines, kw, decode(lines, **kw)))
        return calls[-1][2]
    jproc.s2s.correct_lines = recorded
    ws = write_workspace(JW.make_workspace, str(tmp_path / 'jax'), pages(JP))
    jproc.process_workspace(ws, ['OCR'], 'COR')
    want = outputs(ws)
    (jlines, jkw, jout), = calls

    # the port's host code on the JAX decoder's results: byte-equal
    tproc = TTC.ANNCorrection(parameter=dict(params, device='cpu'))

    def replay(lines, **kw):
        assert lines == jlines and kw == jkw
        return jout
    decode = tproc.s2s.correct_lines
    tproc.s2s.correct_lines = replay
    ws = write_workspace(TW.make_workspace, str(tmp_path / 'host'),
                         pages(TP))
    tproc.process_workspace(ws, ['OCR'], 'COR')
    assert outputs(ws) == want

    # end to end on the port's own decoder
    tproc.s2s.correct_lines = decode
    ws = write_workspace(TW.make_workspace, str(tmp_path / 'port'),
                         pages(TP))
    tproc.process_workspace(ws, ['OCR'], 'COR')
    got = outputs(ws)
    assert sorted(got) == sorted(want)
    for pid in want:
        if fast:
            compare_pages(want[pid], got[pid], 1e-3, max_line_diffs=1)
        else:
            compare_pages(want[pid], got[pid], 1e-4)
