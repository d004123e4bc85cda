"""PyTorch port: cor-asv-ann-compare.

Counterparts of the compare cases of tests/test_cli.py for the port's
copy of ``scripts/compare.py``: the same reports, and byte-equal to the
JAX package's on plain text and on PAGE-XML, also when run as
``python -m cor_asv_ann_tpu_torch.scripts.compare``.
"""

import json
import os
import subprocess
import sys

from click.testing import CliRunner

from cor_asv_ann_tpu.scripts import compare as jax_compare
from cor_asv_ann_tpu_torch.scripts import compare
from cor_asv_ann_tpu_torch.utils import page as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _texts(tmp_path):
    gt = tmp_path / 'gt.txt'
    ocr = tmp_path / 'ocr.txt'
    gt.write_text("Der Hund liegt\nim Garten\n")
    ocr.write_text("Der Hvnd liegt\nim Garten\n")
    return gt, ocr


def test_compare_cli(tmp_path):
    gt, ocr = _texts(tmp_path)
    reports = []
    for cli, name in ((compare.cli, 'port'), (jax_compare.cli, 'jax')):
        report_file = tmp_path / ('report_%s.json' % name)
        result = CliRunner().invoke(cli, ['-o', str(report_file), '-n', 'NFC',
                                          str(gt), str(ocr)])
        assert result.exit_code == 0, result.output
        reports.append(report_file.read_bytes())
    assert reports[0] == reports[1]
    report = json.loads(reports[0])
    pair = f'{ocr},{gt}'
    assert pair in report
    assert 0 < report[pair]['char-error-rate-mean'] < 0.2
    assert report[pair]['num-lines'] == 2


def _page(path, text):
    doc = P.new_page()
    P.add_line(P.add_region(doc, 'r1'), 'l1').add_textequiv(text)
    doc.save(str(path))
    return path


def test_compare_cli_page_xml(tmp_path):
    gt_xml = _page(tmp_path / 'gt.xml', 'Der Hund')
    ocr_xml = _page(tmp_path / 'ocr.xml', 'Der Hvnd')
    outputs = []
    for cli in (compare.cli, jax_compare.cli):
        result = CliRunner().invoke(cli, ['-n', 'NFC', '--confusion', '3',
                                          str(gt_xml), str(ocr_xml)])
        assert result.exit_code == 0, result.output
        outputs.append(result.output)
    assert outputs[0] == outputs[1]
    assert 'char-error-rate-mean' in outputs[0]


def test_compare_lookup_mixed_key_types():
    """PAGE-XML OCR (string line ids) against plain-text GT (list): ids
    that cannot match positionally count as missing, not TypeError."""
    assert compare.lookup({'l1': 'x'}, 'l1') == 'x'
    assert compare.lookup({'l1': 'x'}, 'l2') is None
    assert compare.lookup(['a', 'b'], 1) == 'b'
    assert compare.lookup(['a', 'b'], 7) is None
    assert compare.lookup(['a', 'b'], 'l1') is None


def test_compare_runs_as_module(tmp_path):
    gt, ocr = _texts(tmp_path)
    run = subprocess.run(
        [sys.executable, '-m', 'cor_asv_ann_tpu_torch.scripts.compare',
         '-n', 'NFC', str(gt), str(ocr)],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    want = CliRunner().invoke(jax_compare.cli, ['-n', 'NFC', str(gt),
                                                str(ocr)])
    assert run.stdout == want.output
