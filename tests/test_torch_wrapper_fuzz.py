"""PyTorch port: fuzzing the processor's Viterbi path, whitespace-
preserving rewrite and resegmentation against the JAX package.

Counterparts of tests/test_transcode_fuzz.py (seeded trials of the same
kind and the same invariants, each trial also run through the JAX
package: equal sequences and byte-equal PAGE-XML), and hypothesis-drawn
inputs for ``_alignment2path``, ``_update_sequence`` and
``_resegment_sequence`` held equal to the JAX functions.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cor_asv_ann_tpu.utils import page as JP
from cor_asv_ann_tpu.wrapper import transcode as JTC
from cor_asv_ann_tpu_torch.utils import page as TP
from cor_asv_ann_tpu_torch.wrapper import transcode as TTC

FUZZ = settings(max_examples=60, deadline=None, database=None,
                suppress_health_check=[HealthCheck.too_slow])


def random_line_doc(P, rng):
    doc = P.new_page()
    region = P.add_region(doc, 'r1')
    line = P.add_line(region, 'l1', points=[(0, 0), (400, 18)])
    x = 0
    for j in range(rng.integers(1, 5)):
        n = rng.integers(1, 6)
        wtext = ''.join(rng.choice(list('abcdef'), n))
        w = P.add_word(line, f'w{j}', points=[(x, 0), (x + 10 * n, 18)])
        w.add_textequiv(wtext, conf=0.9)
        x += 10 * n + 5
    line.add_textequiv(
        ' '.join(w.get_text() for w in line.get_words()), conf=0.9)
    return doc


def random_glyph_doc(P, rng):
    doc = P.new_page()
    region = P.add_region(doc, 'r1')
    line = P.add_line(region, 'l1', points=[(0, 0), (400, 18)])
    x = 0
    for j in range(rng.integers(1, 4)):
        n = rng.integers(1, 5)
        wtext = ''.join(rng.choice(list('abcd'), n))
        w = P.add_word(line, f'w{j}', points=[(x, 0), (x + 10 * n, 18)])
        for gi, ch in enumerate(wtext):
            g = P.add_glyph(w, f'w{j}_g{gi}',
                            points=[(x + gi * 10, 0),
                                    (x + gi * 10 + 9, 18)])
            g.add_textequiv(ch, conf=0.9)
        w.add_textequiv(wtext, conf=0.9)
        x += 10 * n + 5
    line.add_textequiv(
        ' '.join(w.get_text() for w in line.get_words()), conf=0.9)
    return doc


def random_edit(rng, text):
    """Random output line: edit chars of `text` (keeping the newline)."""
    out = []
    for ch in text[:-1]:
        r = rng.random()
        if r < 0.08:
            continue  # delete (possibly whitespace -> merge)
        if r < 0.16:
            out.append(rng.choice(list('abcdef ')))  # substitute
        else:
            out.append(ch)
        if rng.random() < 0.06:
            out.append(rng.choice(list('abcdef ')))  # insert
    s = ''.join(out)
    while '  ' in s:
        s = s.replace('  ', ' ')
    s = s.strip(' ') or 'a'
    return s + '\n'


def fuzz_trial(P, TC, make_doc, level, seed, trial):
    """One trial of the JAX fuzz test through one package: the rewritten
    sequence, the serialized page, and the line and word texts."""
    rng = np.random.default_rng([seed, trial])
    doc = make_doc(P, rng)
    seqs = TC._page_get_line_sequences_at(level, doc)
    input_lines, starts = TC._line_sequences2confmat_sequences({}, seqs)
    input_text = ''.join(c[0][0] for c in input_lines[0])
    output = random_edit(rng, input_text)
    realignment, _ = TC._alignment_path(input_text, output)
    _, seq = TC._update_sequence(input_lines[0], output,
                                 [0.9] * len(output), 0.1, realignment,
                                 starts[0], None)
    rewritten = [(te.unicode, te.index) for te in seq]
    TC._resegment_sequence(seq, level)
    TC.page_update_higher_textequiv_levels(level, doc)
    line = doc.get_lines()[0]
    words = ' '.join(w.get_text() or '' for w in line.get_words())
    return rewritten, doc.to_bytes(), line.get_text(), words, \
        (input_text, output)


def run_fuzz(make_doc, level, seed, trials, whitespace_rules):
    for trial in range(trials):
        got = fuzz_trial(TP, TTC, make_doc, level, seed, trial)
        assert got == fuzz_trial(JP, JTC, make_doc, level, seed, trial)
        rewritten, _, line_text, words, case = got
        if whitespace_rules:
            for text, index in rewritten:
                if index == -1:
                    assert not text.split(), (trial, case, text)
                else:
                    assert text == text.strip(' '), (trial, case, text)
        assert words == line_text, (trial, case, words, line_text)


@pytest.mark.parametrize('seed', range(8))
def test_fuzz_update_and_resegment(seed):
    run_fuzz(random_line_doc, 'word', seed, 40, whitespace_rules=True)


@pytest.mark.parametrize('seed', range(4))
def test_fuzz_glyph_level(seed):
    run_fuzz(random_glyph_doc, 'glyph', 100 + seed, 30,
             whitespace_rules=False)


@pytest.mark.parametrize('seed', range(4))
def test_fuzz_viterbi_path(seed):
    """Viterbi over random soft alignments: a monotone surjection onto
    the endpoints, equal to the JAX package's path and distance."""
    rng = np.random.default_rng(200 + seed)
    for trial in range(30):
        i_max = int(rng.integers(2, 30))
        j_max = int(rng.integers(2, 30))
        soft = rng.uniform(0, 1, (j_max, i_max)).astype(np.float32)
        soft /= soft.sum(axis=1, keepdims=True)
        path, dist = TTC._alignment2path(list(soft), i_max, j_max, 0.01)
        assert (path, dist) == JTC._alignment2path(list(soft), i_max,
                                                   j_max, 0.01)
        assert path[0] == 0 and path[i_max] == j_max
        keys = sorted(k for k in path if 0 <= k <= i_max)
        vals = [path[k] for k in keys]
        assert all(b >= a for a, b in zip(vals, vals[1:])), (trial, path)
        assert all(0 <= v <= j_max for v in vals)


@FUZZ
@given(i_max=st.integers(0, 24), j_max=st.integers(0, 24),
       short=st.integers(0, 3), peaked=st.booleans(),
       min_score=st.sampled_from([0.0, 0.01, 1 / 45, 0.5]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_alignment2path_matches_jax(i_max, j_max, short, peaked, min_score,
                                    seed):
    """Soft rows of any length (shorter than the input: padded), peaked
    or flat, empty inputs or outputs."""
    rng = np.random.default_rng(seed)
    width = max(i_max - short, 0)
    soft = rng.uniform(0, 1, (j_max, width)).astype(np.float32)
    if peaked and width:
        soft[np.arange(j_max), rng.integers(0, width, j_max)] += 20.0
    if width:
        soft /= soft.sum(axis=1, keepdims=True)
    alignment = list(soft)
    got = TTC._alignment2path(alignment, i_max, j_max, min_score)
    assert got == JTC._alignment2path(alignment, i_max, j_max, min_score)


edits = st.lists(st.tuples(st.sampled_from(['keep', 'del', 'sub', 'ins']),
                           st.sampled_from(list('abcd '))), max_size=30)


def edited(text, ops):
    """Apply drawn edit operations along `text` (without its newline)."""
    out, k = [], 0
    body = text[:-1]
    for op, ch in ops:
        if k >= len(body):
            break
        if op == 'keep':
            out.append(body[k])
        elif op == 'sub':
            out.append(ch)
        elif op == 'ins':
            out.append(body[k] + ch)
        k += 1
    out.append(body[k:])
    return ''.join(out) + '\n'


def rewrite(P, TC, words, glyphs, ops, viterbi_seed, level):
    """Build a line of `words`, rewrite it towards the drawn output along
    a string-alignment path (or a Viterbi path over seeded soft rows),
    resegment it; returns what a caller can observe."""
    doc = P.new_page()
    line = P.add_line(P.add_region(doc, 'r1'), 'l1',
                      points=[(0, 0), (400, 18)])
    x = 0
    for j, wtext in enumerate(words):
        w = P.add_word(line, f'w{j}',
                       points=[(x, 0), (x + 10 * len(wtext), 18)])
        if glyphs:
            for gi, ch in enumerate(wtext):
                g = P.add_glyph(w, f'w{j}_g{gi}', points=[
                    (x + gi * 10, 0), (x + gi * 10 + 9, 18)])
                g.add_textequiv(ch, conf=0.8)
        w.add_textequiv(wtext, conf=0.8)
        x += 10 * len(wtext) + 5
    line.add_textequiv(' '.join(words), conf=0.8)
    seqs = TC._page_get_line_sequences_at(level, doc)
    input_lines, starts = TC._line_sequences2confmat_sequences({}, seqs)
    input_text = ''.join(c[0][0] for c in input_lines[0])
    output = edited(input_text, ops)
    if viterbi_seed is None:
        realignment, _ = TC._alignment_path(input_text, output)
    else:
        rng = np.random.default_rng(viterbi_seed)
        soft = rng.uniform(0, 1, (len(output), len(input_text)))
        realignment, _ = TC._alignment2path(
            list(soft.astype(np.float32)), len(input_text), len(output),
            0.01)
    probs = list(np.linspace(0.5, 1.0, len(output)))
    try:
        _, seq = TC._update_sequence(input_lines[0], output, probs, 0.2,
                                     realignment, starts[0], None)
    except AssertionError as exc:
        # a path the rewrite refuses: both packages must refuse it
        return ('refused', str(exc))
    rewritten = [(te.unicode, te.index, te.conf) for te in seq]
    TC._resegment_sequence(seq, level)
    return rewritten, doc.to_bytes()


words_st = st.lists(st.text(alphabet='abcd', min_size=1, max_size=5),
                    min_size=1, max_size=4)


@FUZZ
@given(words=words_st, ops=edits,
       viterbi_seed=st.none() | st.integers(0, 2 ** 32 - 1))
def test_update_sequence_matches_jax(words, ops, viterbi_seed):
    """Word-level rewrite and resegmentation along string-alignment and
    Viterbi paths: the same sequence (texts, indices, confs) and the same
    page bytes as the JAX functions."""
    assert rewrite(TP, TTC, words, False, ops, viterbi_seed, 'word') == \
        rewrite(JP, JTC, words, False, ops, viterbi_seed, 'word')


@FUZZ
@given(words=words_st, ops=edits,
       viterbi_seed=st.none() | st.integers(0, 2 ** 32 - 1))
def test_resegment_sequence_glyph_matches_jax(words, ops, viterbi_seed):
    """Glyph-level rewrite and resegmentation (merges and proportional
    splits of Words holding Glyphs), equal to the JAX functions."""
    assert rewrite(TP, TTC, words, True, ops, viterbi_seed, 'glyph') == \
        rewrite(JP, JTC, words, True, ops, viterbi_seed, 'glyph')
