"""PAGE-XML workspaces and comparisons shared by the port's processor
tests (tests/test_torch_wrapper_*.py), the writer of
tests/golden_page_process.json and chip_smoke.py's processor phase.

Standard library and numpy only: the page layer is passed in (either
package's ``utils/page.py``), so the same builder serves both packages.
"""

import xml.etree.ElementTree as ET

import numpy as np

# the characters a glyph's second alternative is drawn from
ALT_CHARS = 'aceinrstu'


def build_page(P, lines, seed=0, alt_every=9, alt_chars=ALT_CHARS):
    """A PAGE document of one region holding `lines` (texts without the
    newline) with Word and Glyph elements, coordinates and seeded
    confidences; about one glyph in `alt_every` carries a second, weaker
    alternative from `alt_chars` (a confusion-network input for the
    model)."""
    rng = np.random.default_rng(seed)
    doc = P.new_page(width=2000, height=40 * len(lines) + 40)
    region = P.add_region(doc, 'r1', points=[
        (0, 0), (2000, 0), (2000, 40 * len(lines)), (0, 40 * len(lines))])
    for li, text in enumerate(lines):
        y0, y1 = li * 40, li * 40 + 36
        line = P.add_line(region, 'l%d' % (li + 1),
                          points=[(0, y0), (2000, y0), (2000, y1), (0, y1)],
                          baseline=[(0, y1 - 6), (2000, y1 - 6)])
        x = 0
        for wi, wtext in enumerate(text.split(' ')):
            wid = 'l%d_w%d' % (li + 1, wi + 1)
            width = 12 * max(len(wtext), 1)
            word = P.add_word(line, wid, points=[
                (x, y0), (x + width, y0), (x + width, y1), (x, y1)])
            for gi, ch in enumerate(wtext):
                glyph = P.add_glyph(word, '%s_g%d' % (wid, gi + 1), points=[
                    (x + 12 * gi, y0), (x + 12 * gi + 11, y0),
                    (x + 12 * gi + 11, y1), (x + 12 * gi, y1)])
                conf = float(np.round(rng.uniform(0.6, 1.0), 3))
                glyph.add_textequiv(ch, conf=conf)
                if rng.integers(alt_every) == 0:
                    alt = alt_chars[int(rng.integers(len(alt_chars)))]
                    if alt != ch:
                        glyph.add_textequiv(
                            alt, conf=float(np.round(1 - conf, 3)))
            word.add_textequiv(wtext, conf=0.9)
            x += width + 12
        line.add_textequiv(text, conf=0.9)
    return doc


def write_workspace(make_workspace, root, pages, grp='OCR'):
    """A METS workspace at `root` holding one PAGE file a page under
    `grp`; `pages` maps page ids to PAGE-XML bytes, in page order."""
    ws = make_workspace(root, list(pages))
    for pid, data in pages.items():
        ws.add_file(grp, pid, data)
    ws.save()
    return ws


def compare_pages(want, got, conf_tol, max_line_diffs=0):
    """Hold two PAGE-XML documents (bytes) against each other: the same
    element tree, ids, attributes, coordinates and texts, every ``conf``
    within `conf_tol` absolute. Returns the largest conf difference and
    the ids of the lines that parted; raises AssertionError at the first
    element that differs.

    With `max_line_diffs` > 0, up to that many TextLine subtrees may
    differ (a decoder that parts ways on a near tie); the region texts
    that join the lines are then not compared."""
    worst = 0.0
    parted = []

    def walk(a, b, path, parent=None):
        nonlocal worst
        assert a.tag == b.tag, (path, a.tag, b.tag)
        tag = a.tag.rsplit('}', 1)[-1]
        here = '%s/%s[%s]' % (path, tag, a.get('id', ''))
        if tag == 'TextLine' and max_line_diffs:
            before = worst
            try:
                return walk_element(a, b, here, tag)
            except AssertionError:
                worst = before
                parted.append(a.get('id'))
                assert len(parted) <= max_line_diffs, (here, parted)
                return
        if parted and tag == 'TextEquiv' and parent == 'TextRegion':
            return
        walk_element(a, b, here, tag)

    def walk_element(a, b, here, tag):
        nonlocal worst
        assert set(a.attrib) == set(b.attrib), (here, a.attrib, b.attrib)
        for key, value in a.attrib.items():
            if key == 'conf':
                d = abs(float(value) - float(b.attrib[key]))
                assert d <= conf_tol, (here, value, b.attrib[key])
                worst = max(worst, d)
            else:
                assert value == b.attrib[key], (here, key, value,
                                                 b.attrib[key])
        assert (a.text or '') == (b.text or ''), (here, a.text, b.text)
        assert (a.tail or '') == (b.tail or ''), (here, a.tail, b.tail)
        assert len(a) == len(b), (here, len(a), len(b))
        for x, y in zip(a, b):
            walk(x, y, here, tag)

    walk(ET.fromstring(want), ET.fromstring(got), '')
    return worst, parted


def line_texts(P, data):
    """The TextLine texts of a PAGE document (bytes), in reading order."""
    return [line.get_text() for line in P.parse_page(data).get_lines()]
