"""PyTorch port: ocrd-cor-asv-ann-process on the flagship against the
JAX processor's golden (tests/golden_page_process.json, written by
tests/make_golden_page_process.py).

On the CPU the port's processor must write the golden's PAGE-XML: the
same element tree, ids, coordinates and texts, every ``conf`` within
1e-4 (measured: 1e-6 at most). The line-level beam (~15 s on one
thread) is in the default run; the glyph-level beam and fast mode are
``-m slow``; chip_smoke.py holds all three on the GPU. The golden's
workspace is rebuilt from tests/golden_decodes.json by the port's page
layer, and the port's evaluate reproduces the golden's report.
"""

import json
import os

import pytest

from cor_asv_ann_tpu_torch.utils import page as TP
from cor_asv_ann_tpu_torch.utils import workspace as TW
from cor_asv_ann_tpu_torch.wrapper.evaluate import EvaluateLines
from cor_asv_ann_tpu_torch.wrapper.transcode import ANNCorrection
from torch_port_fixtures import single_threaded_cpu  # noqa: F401
from torch_wrapper_pages import build_page, compare_pages, write_workspace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def golden():
    with open(os.path.join(ROOT, 'tests', 'golden_page_process.json'),
              encoding='utf-8') as f:
        return json.load(f)


def input_pages(golden):
    return {pid: data.encode('utf-8')
            for pid, data in golden['pages'].items()}


def test_golden_workspace_rebuilds(golden):
    """The port's page layer builds the golden's input pages from the
    golden decodes' inputs, byte for byte."""
    from make_golden_page_process import PAGE_SEEDS
    with open(os.path.join(ROOT, 'tests', 'golden_decodes.json')) as f:
        lines = [line.rstrip('\n') for line in json.load(f)['inputs']]
    half = len(lines) // 2
    for pid, part in zip(PAGE_SEEDS, (lines[:half], lines[half:])):
        doc = build_page(TP, part, seed=PAGE_SEEDS[pid])
        assert doc.to_bytes() == input_pages(golden)[pid]


@pytest.mark.parametrize('case', [
    'line_beam',
    pytest.param('glyph_beam', marks=pytest.mark.slow),
    pytest.param('glyph_fast', marks=pytest.mark.slow)])
def test_flagship_processor_matches_golden(golden, tmp_path, case):
    ws = write_workspace(TW.make_workspace, str(tmp_path / 'ws'),
                         input_pages(golden))
    want = golden['cases'][case]
    proc = ANNCorrection(parameter=dict(
        want['parameter'], device='cpu',
        model_file=os.path.join(ROOT, golden['model_file'])))
    proc.process_workspace(ws, ['OCR'], 'COR')
    files = ws.page_files('COR')
    assert sorted(files) == sorted(want['output'])
    for pid, data in want['output'].items():
        with open(files[pid].path, 'rb') as f:
            worst, parted = compare_pages(data.encode('utf-8'), f.read(),
                                          1e-4)
        assert not parted


def test_evaluate_reproduces_golden_report(golden, tmp_path):
    """The port's evaluate on the golden's input and JAX output gives
    the JAX evaluate's report."""
    ev = golden['evaluate']
    ws = write_workspace(TW.make_workspace, str(tmp_path / 'ws'),
                         input_pages(golden))
    for pid, data in golden['cases'][ev['case']]['output'].items():
        ws.add_file('COR', pid, data.encode('utf-8'))
    ws.save()
    proc = EvaluateLines(parameter={})
    proc.process_workspace(ws, ev['input_file_grp'].split(','), 'EVAL')
    assert proc.report == ev['report']
