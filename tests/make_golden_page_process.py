"""Write tests/golden_page_process.json: the JAX package's
ocrd-cor-asv-ann-process on the flagship, for the port to be held
against (tests/test_torch_wrapper_golden.py on the CPU, chip_smoke.py's
processor phase on the GPU).

Run once, with JAX on the CPU, from the root of the repo:

    JAX_PLATFORMS=cpu python tests/make_golden_page_process.py

The workspace is two pages made from the 24 lines of
tests/golden_decodes.json ``inputs`` (tests/torch_wrapper_pages.py:
Word and Glyph elements, seeded confidences, a few glyphs with a second
alternative). The golden holds the input PAGE-XML, the JAX processor's
output for each case (float32, the processor's defaults otherwise) and
the JAX ``ocrd-cor-asv-ann-evaluate`` report of the glyph-level beam
output against the input.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODEL = 'testmodels/flagship.d2.w512.synthetic.h5'
# case name -> parameters besides model_file (the rest are defaults)
CASES = {
    'glyph_beam': {'textequiv_level': 'glyph', 'fast_mode': False},
    'glyph_fast': {'textequiv_level': 'glyph', 'fast_mode': True},
    'line_beam': {'textequiv_level': 'line', 'fast_mode': False},
}
PAGE_SEEDS = {'p1': 1, 'p2': 2}


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from cor_asv_ann_tpu.utils import page as P
    from cor_asv_ann_tpu.utils.workspace import make_workspace
    from cor_asv_ann_tpu.wrapper.evaluate import EvaluateLines
    from cor_asv_ann_tpu.wrapper.transcode import ANNCorrection
    from torch_wrapper_pages import build_page, write_workspace

    with open(os.path.join(HERE, 'golden_decodes.json')) as f:
        lines = [line.rstrip('\n') for line in json.load(f)['inputs']]
    half = len(lines) // 2
    pages = {pid: build_page(P, part, seed=PAGE_SEEDS[pid]).to_bytes()
             for pid, part in zip(PAGE_SEEDS, (lines[:half], lines[half:]))}
    golden = {'model_file': MODEL, 'input_file_grp': 'OCR',
              'output_file_grp': 'COR',
              'pages': {pid: data.decode('utf-8')
                        for pid, data in pages.items()},
              'cases': {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, params in CASES.items():
            root = os.path.join(tmp, name)
            ws = write_workspace(make_workspace, root, pages)
            proc = ANNCorrection(parameter=dict(
                params, model_file=os.path.join(ROOT, MODEL)))
            proc.process_workspace(ws, ['OCR'], 'COR')
            out = {}
            for pid, f in ws.page_files('COR').items():
                with open(f.path, encoding='utf-8') as fh:
                    out[pid] = fh.read()
            golden['cases'][name] = {'parameter': params, 'output': out}
            if name == 'glyph_beam':
                ev = EvaluateLines(parameter={})
                ev.process_workspace(ws, ['OCR', 'COR'], 'EVAL')
                golden['evaluate'] = {'case': name,
                                      'input_file_grp': 'OCR,COR',
                                      'report': ev.report}
    with open(os.path.join(HERE, 'golden_page_process.json'), 'w',
              encoding='utf-8') as f:
        json.dump(golden, f, indent=1, ensure_ascii=False)
        f.write('\n')


if __name__ == '__main__':
    main()
