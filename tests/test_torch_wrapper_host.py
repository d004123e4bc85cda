"""PyTorch port: the host side of ocrd-cor-asv-ann-process.

Counterparts of tests/test_transcode_host.py for the port's copies of
``utils/page.py``, ``utils/workspace.py`` and ``wrapper/transcode.py``:
PAGE parsing, line sequences, confmat conversion, Viterbi, the
whitespace-preserving rewrite, resegmentation and the higher-level
update. Each scenario runs through both packages; the port's results
must pass the JAX test's assertions and equal the JAX package's results
(texts, maps, paths and the serialized PAGE-XML byte for byte).
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest

from cor_asv_ann_tpu.utils import page as JP
from cor_asv_ann_tpu.utils import workspace as JW
from cor_asv_ann_tpu.wrapper import transcode as JTC
from cor_asv_ann_tpu_torch.utils import page as TP
from cor_asv_ann_tpu_torch.utils import workspace as TW
from cor_asv_ann_tpu_torch.wrapper import transcode as TTC

# (page layer, workspace layer, transcode module) of each package
PORT = (TP, TW, TTC)
JAX = (JP, JW, JTC)


def build_doc(P, words_per_line=(("Der", "Hund"), ("liegt",))):
    doc = P.new_page()
    region = P.add_region(doc, 'r1', points=[(0, 0), (100, 0), (100, 50),
                                             (0, 50)])
    for li, words in enumerate(words_per_line):
        line = P.add_line(region, f'l{li + 1}',
                          points=[(0, li * 20), (100, li * 20),
                                  (100, li * 20 + 18), (0, li * 20 + 18)])
        x = 0
        for wi, wtext in enumerate(words):
            w = 10 * len(wtext)
            word = P.add_word(line, f'l{li + 1}_w{wi + 1}',
                              points=[(x, li * 20), (x + w, li * 20),
                                      (x + w, li * 20 + 18),
                                      (x, li * 20 + 18)])
            for gi, ch in enumerate(wtext):
                glyph = P.add_glyph(word, f'l{li + 1}_w{wi + 1}_g{gi + 1}',
                                    points=[(x + gi * 10, li * 20),
                                            (x + gi * 10 + 9, li * 20 + 18)])
                glyph.add_textequiv(ch, conf=0.9)
            word.add_textequiv(wtext, conf=0.9)
            x += w + 5
        line.add_textequiv(' '.join(words), conf=0.9)
    return doc


def both(scenario):
    """Run `scenario(P, W, TC)` through the port and the JAX package;
    returns the port's result after holding it equal to the JAX one."""
    got, want = scenario(*PORT), scenario(*JAX)
    assert got == want
    return got


def _seq_texts(seq):
    return [te.unicode for te in seq]


def test_roundtrip_serialization(tmp_path):
    def scenario(P, W, TC):
        path = str(tmp_path / ('page_%s.xml' % P.__name__))
        build_doc(P).save(path)
        doc2 = P.parse_page(path)
        with open(path, 'rb') as f:
            return ([l.id for l in doc2.get_lines()],
                    doc2.get_lines()[0].get_text(), f.read())
    ids, text, _ = both(scenario)
    assert ids == ['l1', 'l2']
    assert text == 'Der Hund'


@pytest.mark.parametrize('level,expected', [
    ('line', ['Der Hund\n', 'liegt\n']),
    ('word', ['Der Hund\n', 'liegt\n']),
    ('glyph', ['Der Hund\n', 'liegt\n']),
])
def test_line_sequences(level, expected):
    def scenario(P, W, TC):
        seqs = TC._page_get_line_sequences_at(level, build_doc(P))
        return [[(tes[0].unicode, tes[0].index, tes[0].conf)
                 for tes in seq] for seq in seqs]
    seqs = both(scenario)
    assert [''.join(t[0] for t in seq) for seq in seqs] == expected
    # artificial whitespace entries carry index -1
    for seq in seqs:
        for text, index, _ in seq:
            if text in (' ', '\n'):
                assert index == -1


def test_confmat_conversion():
    mapping = {c: i for i, c in enumerate(' \nDerHundligt', 1)}

    def scenario(P, W, TC):
        seqs = TC._page_get_line_sequences_at('word', build_doc(P))
        lines, starts = TC._line_sequences2confmat_sequences(mapping, seqs)
        return lines, [sorted(s) for s in starts]
    input_lines, starts = both(scenario)
    assert ''.join(c[0][0] for c in input_lines[0]) == 'Der Hund\n'
    # position map points at the right chunks
    assert 0 in starts[0] and 3 in starts[0] and 4 in starts[0]


def test_alignment2path_identity():
    # perfect diagonal soft alignment -> identity path
    n = 6
    alignment = [np.eye(n)[j] for j in range(n)]
    path, dist = both(lambda P, W, TC: TC._alignment2path(
        alignment, n, n, 0.01))
    assert path[0] == 0 and path[n] == n
    for i in range(n):
        assert path[i] == i
    assert dist < 1e-6


def test_alignment2path_deletion():
    # output one char shorter: input position 2 deleted
    align = np.zeros((5, 6), np.float32)
    for j, i in enumerate([0, 1, 3, 4, 5]):
        align[j, i] = 1.0
    path, _ = both(lambda P, W, TC: TC._alignment2path(
        list(align), 6, 5, 0.01))
    assert path[6] == 5 and path[0] == 0


def _update(P, TC, doc, output, realignment, prob=0.9):
    seqs = TC._page_get_line_sequences_at('word', doc)
    input_lines, starts = TC._line_sequences2confmat_sequences({}, seqs)
    return TC._update_sequence(input_lines[0], output, [prob] * len(output),
                               0.1, realignment, starts[0], None)


def test_update_sequence_simple_substitution():
    output = 'Der Hund\n'.replace('u', 'o')  # 'Der Hond\n'
    realignment = {i: i for i in range(len(output) + 1)}

    def scenario(P, W, TC):
        line, seq = _update(P, TC, build_doc(P), output, realignment,
                            prob=0.8)
        return line.id, [(te.unicode, te.index, te.conf) for te in seq]
    line_id, seq = both(scenario)
    assert line_id == 'l1'
    assert [t for t, _, _ in seq] == ['Der', ' ', 'Hond', '\n']
    # conf was rewritten from output probabilities
    assert all(abs(conf - 0.8) < 1e-6 for _, index, conf in seq
               if index != -1)


def test_update_sequence_whitespace_push():
    """Non-whitespace output landing on a whitespace element is pushed to
    the neighbor (reference transcode.py:437-475)."""
    # 'Der Hund\n' -> 'Ders Hund\n': the 's' is inserted at the space
    realignment = {0: 0, 3: 3, 4: 5, 8: 9, 9: 10}
    texts = both(lambda P, W, TC: _seq_texts(_update(
        P, TC, build_doc(P), 'Ders Hund\n', realignment)[1]))
    assert texts == ['Ders', ' ', 'Hund', '\n']


def test_resegment_merge():
    """Deleted whitespace merges the adjacent words."""
    realignment = {0: 0, 3: 3, 4: 3, 8: 7, 9: 8}

    def scenario(P, W, TC):
        doc = build_doc(P)
        _, seq = _update(P, TC, doc, 'DerHund\n', realignment)
        texts = _seq_texts(seq)
        TC._resegment_sequence(seq, 'word')
        words = doc.get_lines()[0].get_words()
        return texts, [w.get_text() for w in words], doc.to_bytes()
    texts, words, _ = both(scenario)
    assert texts == ['Der', '', 'Hund', '\n']
    assert words == ['DerHund']


def test_resegment_split():
    """Introduced whitespace splits the word proportionally."""
    realignment = {0: 0, 7: 8, 8: 9}

    def scenario(P, W, TC):
        doc = build_doc(P, (("DerHund",),))
        _, seq = _update(P, TC, doc, 'Der Hund\n', realignment)
        texts = _seq_texts(seq)
        TC._resegment_sequence(seq, 'word')
        words = doc.get_lines()[0].get_words()
        return (texts, [w.get_text() for w in words],
                [P.points_bbox(w.get_points()) for w in words],
                doc.to_bytes())
    texts, words, boxes, _ = both(scenario)
    assert texts == ['Der Hund', '\n']
    assert words == ['Der', 'Hund']
    # proportional bbox split
    assert boxes[0][2] <= boxes[1][0] + 1


def test_update_higher_levels():
    def scenario(P, W, TC):
        doc = build_doc(P)
        doc.get_lines()[0].get_words()[0].set_text('Das')
        TC.page_update_higher_textequiv_levels('word', doc)
        return (doc.get_lines()[0].get_text(),
                doc.get_regions()[0].get_text(), doc.to_bytes())
    line, region, _ = both(scenario)
    assert line == 'Das Hund'
    assert region == 'Das Hund\nliegt'


def test_remove_lower_levels():
    def scenario(P, W, TC):
        doc = build_doc(P)
        TC.page_remove_lower_textequiv_levels('line', doc)
        return doc.get_lines()[0].get_words(), doc.to_bytes()
    words, _ = both(scenario)
    assert words == []


def test_workspace_roundtrip(tmp_path):
    def scenario(P, W, TC):
        root = str(tmp_path / ('ws_' + P.__name__))
        ws = W.make_workspace(root, ['page1', 'page2'])
        doc = build_doc(P)
        ws.add_file('OCR', 'page1', doc.to_bytes())
        ws.add_file('OCR', 'page2', doc.to_bytes())
        ws.save()
        ws2 = W.Workspace(root)
        files = ws2.page_files('OCR')
        doc2 = P.parse_page(files['page1'].path)
        with open(root + '/mets.xml', 'rb') as f:
            mets = f.read()
        return (ws2.file_groups(), ws2.page_ids(), sorted(files),
                doc2.get_lines()[0].get_text(), mets)
    groups, pages, files, text, _ = both(scenario)
    assert groups == ['OCR']
    assert pages == ['page1', 'page2']
    assert files == ['page1', 'page2']
    assert text == 'Der Hund'


def test_update_higher_levels_nested_regions():
    """A parent region's text concatenates its subregions' FRESH texts
    (children-first traversal), sorted by ReadingOrder when the
    subregions appear there as ordered groups."""
    def scenario(P, W, TC):
        doc = P.new_page()
        ns = doc.ns
        ro = ET.SubElement(doc.page.elem, '{%s}ReadingOrder' % ns)
        og = ET.SubElement(ro, '{%s}OrderedGroup' % ns)
        og.set('id', 'g0')
        for i, rid in enumerate(['ra', 'rb']):
            sub_g = ET.SubElement(og, '{%s}OrderedGroupIndexed' % ns)
            sub_g.set('index', str(i))
            sub_g.set('id', 'g_' + rid)
            sub_g.set('regionRef', rid)
        parent = P.add_region(doc, 'rp')
        # XML order rb, ra — ReadingOrder says ra first
        for rid, text in (('rb', 'zwei'), ('ra', 'eins')):
            e = ET.SubElement(parent.elem, '{%s}TextRegion' % ns)
            e.set('id', rid)
            sub = P.PageElement(e, doc, parent)
            line = P.add_line(sub, rid + '_l1')
            line.add_textequiv(text, conf=0.9)
        TC.page_update_higher_textequiv_levels('line', doc)
        by_id = {r.id: r.get_text() for r in doc.get_regions(order=False)}
        return by_id, doc.to_bytes()
    by_id, _ = both(scenario)
    assert by_id['ra'] == 'eins'
    assert by_id['rb'] == 'zwei'
    assert by_id['rp'] == 'eins\nzwei'


def test_baseline_after_coords():
    """The PAGE schema sequence requires Coords before Baseline."""
    def scenario(P, W, TC):
        doc = P.new_page()
        region = P.add_region(doc, 'r1')
        line = P.add_line(region, 'l1', points=[(0, 0), (10, 10)],
                          baseline=[(0, 8), (10, 8)])
        return [e.tag.split('}')[-1] for e in line.elem]
    tags = both(scenario)
    assert tags.index('Coords') < tags.index('Baseline')
