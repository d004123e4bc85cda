"""PyTorch port: the model-free processors evaluate, join, align and mark.

Counterparts of tests/test_processors.py for the port's copies of
``wrapper/evaluate.py``, ``join.py``, ``align.py`` and ``mark.py``. Each
scenario runs on a workspace built by each package's own page and
workspace layers; the port must pass the JAX test's assertions and write
the same bytes as the JAX package into its output fileGrp (PAGE-XML and
the JSON reports), with equal in-memory reports.
"""

import types

import pytest

from cor_asv_ann_tpu.lib import alignment as j_alignment
from cor_asv_ann_tpu.utils import page as j_page
from cor_asv_ann_tpu.utils import workspace as j_workspace
from cor_asv_ann_tpu.wrapper import align as j_align
from cor_asv_ann_tpu.wrapper import base as j_base
from cor_asv_ann_tpu.wrapper import evaluate as j_evaluate
from cor_asv_ann_tpu.wrapper import join as j_join
from cor_asv_ann_tpu.wrapper import mark as j_mark
from cor_asv_ann_tpu_torch.lib import alignment as t_alignment
from cor_asv_ann_tpu_torch.utils import page as t_page
from cor_asv_ann_tpu_torch.utils import workspace as t_workspace
from cor_asv_ann_tpu_torch.wrapper import align as t_align
from cor_asv_ann_tpu_torch.wrapper import base as t_base
from cor_asv_ann_tpu_torch.wrapper import evaluate as t_evaluate
from cor_asv_ann_tpu_torch.wrapper import join as t_join
from cor_asv_ann_tpu_torch.wrapper import mark as t_mark


def _pkg(page, workspace, align, base, evaluate, join, mark, alignment):
    return types.SimpleNamespace(
        P=page, W=workspace, align=align, base=base, evaluate=evaluate,
        alignment=alignment, AlignLines=align.AlignLines,
        EvaluateLines=evaluate.EvaluateLines, JoinLines=join.JoinLines,
        MarkWords=mark.MarkWords)


PORT = _pkg(t_page, t_workspace, t_align, t_base, t_evaluate, t_join,
            t_mark, t_alignment)
JAX = _pkg(j_page, j_workspace, j_align, j_base, j_evaluate, j_join,
           j_mark, j_alignment)


def make_doc(P, line_texts, conf=0.9, with_words=True):
    doc = P.new_page()
    region = P.add_region(doc, 'r1')
    for i, text in enumerate(line_texts):
        line = P.add_line(region, f'l{i + 1}',
                          points=[(0, i * 20), (100, i * 20 + 18)],
                          baseline=[(0, i * 20 + 15), (100, i * 20 + 15)])
        if with_words:
            x = 0
            for j, wtext in enumerate(text.split(' ')):
                w = P.add_word(line, f'l{i + 1}_w{j + 1}',
                               points=[(x, i * 20), (x + 10 * len(wtext),
                                                     i * 20 + 18)])
                w.add_textequiv(wtext, conf=conf)
                x += 10 * len(wtext) + 5
        line.add_textequiv(text, conf=conf)
    return doc


GT = [["Der Hund liegt", "im Garten"], ["Die Katze sitzt"]]
OCR1 = [["Der Hvnd liegt", "im Garten"], ["Die Katzc sitzt"]]
OCR2 = [["Der Hund liegt", "irn Garten"], ["Die Katze sitzt"]]


def build_ws3(pkg, root):
    """Workspace with GT + two OCR fileGrps over 2 pages."""
    ws = pkg.W.make_workspace(str(root), ['p1', 'p2'])
    for grp, pages in (('GT', GT), ('OCR1', OCR1), ('OCR2', OCR2)):
        for pid, texts in zip(['p1', 'p2'], pages):
            ws.add_file(grp, pid, make_doc(pkg.P, texts).to_bytes())
    ws.save()
    return ws


def grp_bytes(pkg, root, grp):
    """{file name: bytes} of every file of `grp` (PAGE-XML and JSON)."""
    ws = pkg.W.Workspace(str(root))
    out = {}
    for f in ws.files(group=grp):
        with open(f.path, 'rb') as fh:
            out[f.path.rsplit('/', 1)[-1]] = fh.read()
    return out


def run_both(tmp_path, build, make_proc, input_grps, output_grp):
    """Build a workspace with each package and run its processor there;
    the output fileGrps must be byte-equal. Returns the port's processor
    and workspace directory."""
    result = {}
    for name, pkg in (('port', PORT), ('jax', JAX)):
        root = tmp_path / ('ws_' + name)
        build(pkg, root)
        proc = make_proc(pkg)
        proc.process_workspace(str(root), input_grps, output_grp)
        result[name] = (proc, root,
                        grp_bytes(pkg, root, output_grp) if output_grp
                        else None)
    assert result['port'][2] == result['jax'][2]
    if getattr(result['jax'][0], 'report', None) is not None:
        assert result['port'][0].report == result['jax'][0].report
    return result['port'][0], result['port'][1]


def test_page_get_lines_match_modes(tmp_path):
    got = {}
    for name, pkg in (('port', PORT), ('jax', JAX)):
        ws = build_ws3(pkg, tmp_path / name)
        doc = pkg.P.parse_page(ws.page_files('GT')['p1'].path)
        got[name] = [pkg.evaluate.page_get_lines(doc, match)
                     for match in ('id', 'coords', 'baseline')]
    assert got['port'] == got['jax']
    by_id, by_coords, by_baseline = got['port']
    assert by_id == {'l1': 'Der Hund liegt', 'l2': 'im Garten'}
    assert len(by_coords) == 2
    assert len(by_baseline) == 2


def test_evaluate(tmp_path):
    proc, root = run_both(
        tmp_path, build_ws3, lambda pkg: pkg.EvaluateLines(parameter={
            'match_on': 'id', 'metric': 'NFC', 'confusion': 5,
            'histogram': True}), ['GT', 'OCR1', 'OCR2'], 'EVAL')
    report = proc.report
    pair1 = 'OCR1,GT'
    assert pair1 in report
    assert 0 < report[pair1]['char-error-rate-mean'] < 0.2
    assert report[pair1]['num-lines'] == 3
    # per-page and document reports are in the workspace
    files = PORT.W.Workspace(str(root)).files(group='EVAL')
    assert len(files) >= 3
    assert [f for f in files if f.page_id is None]


def test_evaluate_requires_multiple_groups(tmp_path):
    for pkg in (PORT, JAX):
        ws = build_ws3(pkg, tmp_path / pkg.P.__name__)
        proc = pkg.EvaluateLines(parameter={'match_on': 'id'})
        with pytest.raises(pkg.base.ParameterError,
                           match='multiple input fileGrps'):
            proc.process_workspace(ws, ['GT'], 'EVAL2')
        proc = pkg.EvaluateLines(parameter={'match_on': 'index'})
        with pytest.raises(pkg.base.ParameterError,
                           match='only 1 input fileGrp'):
            proc.process_workspace(ws, ['GT', 'OCR1'], 'EVAL2')
        # the fast metric never feeds the confusion aligners
        proc = pkg.EvaluateLines(parameter={
            'match_on': 'id', 'confusion': 5, 'metric': 'Levenshtein-fast'})
        with pytest.raises(pkg.base.ParameterError,
                           match='full alignment metric'):
            proc.process_workspace(ws, ['GT', 'OCR1'], 'EVAL2')


def test_join_and_evaluate_index(tmp_path):
    _, root = run_both(
        tmp_path, build_ws3, lambda pkg: pkg.JoinLines(parameter={
            'add-filegrp-index': True}), ['GT', 'OCR1', 'OCR2'], 'JOIN')
    ws = PORT.W.Workspace(str(root))
    doc = PORT.P.parse_page(ws.page_files('JOIN')['p1'].path)
    tes = doc.get_lines()[0].get_textequivs()
    assert [te.index for te in tes] == [0, 1, 2]
    assert tes[0].unicode == 'Der Hund liegt'
    assert tes[1].unicode == 'Der Hvnd liegt'
    # evaluation on the joined annotation matches the multi-fileGrp one
    proc1 = PORT.EvaluateLines(parameter={'match_on': 'id', 'metric': 'NFC'})
    proc1.process_workspace(ws, ['GT', 'OCR1', 'OCR2'], None)
    proc2 = PORT.EvaluateLines(parameter={'match_on': 'index',
                                          'metric': 'NFC'})
    proc2.process_workspace(ws, ['JOIN'], None)
    for i in (1, 2):
        m1 = proc1.report[proc1._pair(i)]['char-error-rate-mean']
        m2 = proc2.report[proc2._pair(i)]['char-error-rate-mean']
        assert abs(m1 - m2) < 1e-9


def test_align_majority(tmp_path):
    _, root = run_both(
        tmp_path, build_ws3,
        lambda pkg: pkg.AlignLines(parameter={'method': 'majority'}),
        ['OCR1', 'OCR2', 'GT'], 'ALIGN')
    ws = PORT.W.Workspace(str(root))
    lines = PORT.P.parse_page(ws.page_files('ALIGN')['p1'].path).get_lines()
    # 2 of 3 inputs agree on the correct text everywhere
    assert lines[0].get_text() == 'Der Hund liegt'
    assert lines[1].get_text() == 'im Garten'
    # word segmentation dropped
    assert lines[0].get_words() == []


def test_align_combined(tmp_path):
    _, root = run_both(
        tmp_path, build_ws3,
        lambda pkg: pkg.AlignLines(parameter={'method': 'combined'}),
        ['OCR1', 'OCR2', 'GT'], 'ALIGN2')
    ws = PORT.W.Workspace(str(root))
    doc = PORT.P.parse_page(ws.page_files('ALIGN2')['p2'].path)
    assert doc.get_lines()[0].get_text() == 'Die Katze sitzt'


def test_align_needs_three_for_majority(tmp_path):
    for pkg in (PORT, JAX):
        ws = build_ws3(pkg, tmp_path / pkg.P.__name__)
        proc = pkg.AlignLines(parameter={'method': 'majority'})
        with pytest.raises(AssertionError):
            proc.process_workspace(ws, ['OCR1', 'OCR2'], 'ALIGN3')


def _script(tmp_path, name, body):
    script = tmp_path / name
    script.write_text(body)
    script.chmod(0o755)
    return str(script)


def test_mark_words(tmp_path):
    # fake spellchecker: echoes words NOT in its dictionary (like
    # hunspell -w); knows only lowercase German articles + 'Hund'
    script = _script(
        tmp_path, 'spell.sh', '#!/bin/sh\nwhile read w; do\n'
        'case "$w" in Der|Die|Hund|im|liegt|sitzt) ;; *) echo "$w";; esac\n'
        'done\n')
    procs = {}

    def make(pkg):
        procs[pkg.P.__name__] = pkg.MarkWords(
            parameter={'command': script, 'format': 'OOV'})
        return procs[pkg.P.__name__]
    proc, root = run_both(tmp_path, build_ws3, make, ['OCR1'], 'MARK')
    ws = PORT.W.Workspace(str(root))
    words = PORT.P.parse_page(ws.page_files('MARK')['p1'].path) \
        .get_lines()[0].get_words()
    marks = {w.get_text(): w.get_textequivs()[0].comments for w in words}
    assert marks['Hvnd'] == 'OOV'
    assert marks['Der'] is None
    assert proc.total_nonmatches >= 2  # Hvnd, Garten, Katzc
    assert proc.total_nonmatches == procs[JAX.P.__name__].total_nonmatches


def test_mark_words_conf_format(tmp_path):
    script = _script(tmp_path, 'all_oov.sh', '#!/bin/sh\ncat\n')
    _, root = run_both(
        tmp_path, build_ws3, lambda pkg: pkg.MarkWords(parameter={
            'command': script, 'format': 'conf'}), ['OCR2'], 'MARK2')
    ws = PORT.W.Workspace(str(root))
    word = PORT.P.parse_page(ws.page_files('MARK2')['p1'].path) \
        .get_lines()[0].get_words()[0]
    assert abs(word.get_textequivs()[0].conf - 0.123) < 1e-9


@pytest.fixture
def spell_script(tmp_path):
    """Toy hunspell ``-w``-alike: echoes every word NOT in its
    dictionary back, one per line (the documented command contract)."""
    return _script(
        tmp_path, 'spell2.sh', '#!/bin/sh\nwhile read w; do\n'
        'case "$w" in Der|Hund|liegt|Garten|Weihnacht) ;; *) echo "$w";; '
        'esac\ndone\n')


def mark_both(tmp_path, line_texts, script, fmt, conf=0.9):
    """Mark one page with each package; returns the port's processor and
    its output document."""
    def build(pkg, root):
        ws = pkg.W.make_workspace(str(root), ['p1'])
        ws.add_file('OCR', 'p1',
                    make_doc(pkg.P, line_texts, conf=conf).to_bytes())
        ws.save()
    proc, root = run_both(
        tmp_path, build, lambda pkg: pkg.MarkWords(parameter={
            'command': script, 'format': fmt}), ['OCR'], 'MARK')
    ws = PORT.W.Workspace(str(root))
    return proc, PORT.P.parse_page(ws.page_files('MARK')['p1'].path)


def page_marks(doc):
    return {w.get_text(): w.get_textequivs()[0].comments
            for line in doc.get_lines() for w in line.get_words()}


def test_mark_dehyphenation_revert(tmp_path, spell_script):
    """A hyphenated line-final unknown whose join with the next line's
    first word IS known gets its mark reverted (reference
    mark.py:107-124)."""
    proc, doc = mark_both(tmp_path, ['Der Gar-', 'ten liegt'],
                          spell_script, 'OOV')
    assert page_marks(doc) == {'Der': None, 'Gar-': None, 'ten': None,
                               'liegt': None}
    assert proc.total_nonmatches == 0


def test_mark_dehyphenation_join_unknown_keeps_marks(tmp_path,
                                                     spell_script):
    """When the joined form is ALSO unknown, both halves stay marked."""
    proc, doc = mark_both(tmp_path, ['Der xyz-', 'abc liegt'],
                          spell_script, 'OOV')
    marks = page_marks(doc)
    assert marks['xyz-'] == 'OOV'
    assert marks['abc'] == 'OOV'
    assert proc.total_nonmatches == 2


def test_mark_dehyphenation_pending_survives_known_lines(tmp_path,
                                                         spell_script):
    """The pending hyphen candidate survives an intermediate all-known
    line (the reference quirk, kept: reference mark.py:107-124)."""
    proc, doc = mark_both(tmp_path, ['Weih-', 'Der Hund', 'nacht liegt'],
                          spell_script, 'OOV')
    assert page_marks(doc) == {'Weih-': None, 'Der': None, 'Hund': None,
                               'nacht': None, 'liegt': None}
    assert proc.total_nonmatches == 0


def test_mark_dehyphenation_conf_revert_removes_attribute(tmp_path,
                                                          spell_script):
    """A join revert on a word that never had @conf removes the
    attribute again under format=conf."""
    _, doc = mark_both(tmp_path, ['Der Gar-', 'ten liegt'], spell_script,
                       'conf', conf=None)
    confs = {w.get_text(): w.get_textequivs()[0].conf
             for line in doc.get_lines() for w in line.get_words()}
    assert confs == {'Der': None, 'Gar-': None, 'ten': None,
                     'liegt': None}


def test_align_confidence_gap_does_not_outvote():
    """An alignment gap (empty chunk) scores confidence 0, like the
    reference's avg([])."""
    got = {}
    for name, pkg in (('port', PORT), ('jax', JAX)):
        aligner = pkg.alignment.Alignment()
        chars, confs = pkg.align.nway_align(
            ['cat', 'ct'], [[0.9] * 3, [0.9] * 2], aligner)
        got[name] = (chars, confs, pkg.align.vote(chars, confs,
                                                  'confidence'))
    assert got['port'] == got['jax']
    chars, confs, (text, _) = got['port']
    assert text == 'cat'
    for subchars, subconfs in zip(chars, confs):
        for c, p in zip(subchars, subconfs):
            if c == '':
                assert p == 0.0


def test_histlat_l2_precomposed_macrons():
    """The port's L2 table keys precomposed macron vowels with the
    reference's exact value forms, as the JAX package's does."""
    eqv = PORT.alignment.L2_HISTLAT_EQV
    assert eqv == JAX.alignment.L2_HISTLAT_EQV
    assert eqv['\u0101'] == 'a\u0303'
    assert eqv['\u0113'] == '\u1ebd'
    assert eqv['\ue5dc'] == '\u00f1'
    aligner = PORT.alignment.Alignment()
    dist, _ = aligner.get_adjusted_distance(
        '\u0101', 'a\u0303', normalization='historic_latin', gtlevel=2)
    assert dist == 0
    dist, _ = aligner.get_adjusted_distance(
        '\ue5dc', '\u00f1', normalization='historic_latin', gtlevel=2)
    assert dist == 0
