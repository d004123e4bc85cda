"""Generator of OCR-D pages: PAGE-XML documents with glyph alternatives.

Reads a traffic mix (``portbench/traffic/<mix>.json``, ``"generator":
"pages"``) and draws, from the seed, pages of one text region whose
TextLines hold Words and Glyphs with coordinates, as an OCR engine
leaves them:

- a page's number of lines from ``lines_per_page`` and its column width
  from ``column_chars``: every pair of the two once in each block of
  pages, the block shuffled (every seed gets the same sizes in another
  order);
- each line filled with corpus words up to the column width; a share
  ``short_share`` of lines are paragraph ends, filled to a fraction
  ``short_fill`` [lo, hi] of it;
- every word passed through the corpus's OCR noise model
  (``noise_rate``, ``drop_rate``; a word the noise empties stays clean);
- every glyph gets a confidence uniform in ``conf`` [lo, hi] (three
  decimals); one glyph in ``alt_every`` gets a second, weaker
  alternative from ``alt_chars``, with the rest of the mass.

A page is returned as its spec (lines of words of glyphs of (char, conf)
alternatives, in document order) and as PAGE-XML bytes built from it
(the layout of ``tests/torch_wrapper_pages.py:build_page``).
"""

from xml.sax.saxutils import escape

import numpy as np

from .. import synth

NS = 'http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15'


def _line_words(rng, width, mix):
    if rng.random() < mix['short_share']:
        lo, hi = mix['short_fill']
        width = max(1, int(width * rng.uniform(lo, hi)))
    words = []
    for word in synth.fill_line(rng, width):
        noisy = synth.corrupt(word, rng, mix['noise_rate'], mix['drop_rate'])
        words.append(noisy or word)
    return words


def _glyphs(rng, word, mix):
    n = len(word)
    confs = np.round(rng.uniform(*mix['conf'], size=n), 3).tolist()
    second = (rng.integers(mix['alt_every'], size=n) == 0).tolist()
    alts = mix['alt_chars']
    picks = rng.integers(len(alts), size=n).tolist()
    out = []
    for ch, conf, more, pick in zip(word, confs, second, picks):
        glyph = [(ch, conf)]
        if more and alts[pick] != ch:
            glyph.append((alts[pick], round(1.0 - conf, 3)))
        out.append(glyph)
    return out


def _page(rng, n_lines, width, mix):
    return [[_glyphs(rng, word, mix) for word in _line_words(rng, width, mix)]
            for _ in range(n_lines)]


def page_specs(mix, seed, n_pages):
    """`n_pages` page specs drawn from `seed`: each a list of lines, a
    line a list of words, a word a list of glyphs, a glyph a list of
    (char, conf) alternatives, the first the OCR's best."""
    rng = np.random.default_rng(seed)
    sizes = synth.grid(rng, mix['lines_per_page'], mix['column_chars'],
                       n_pages)
    return [_page(rng, n, w, mix) for n, w in sizes]


def corner_specs(mix, seed):
    """One page at each corner of the mix's sizes (fewest and most
    lines, narrowest and widest column): the batch and length buckets
    that its pages reach."""
    rng = np.random.default_rng(seed)
    rows, cols = mix['lines_per_page'], mix['column_chars']
    return [_page(rng, n, w, mix) for n in (min(rows), max(rows))
            for w in (min(cols), max(cols))]


def _coords(x0, y0, x1, y1):
    return '<Coords points="%d,%d %d,%d %d,%d %d,%d"/>' % (
        x0, y0, x1, y0, x1, y1, x0, y1)


def _textequiv(text, conf):
    return ('<TextEquiv conf="%s"><Unicode>%s</Unicode></TextEquiv>'
            % ('%.6g' % conf, escape(text)))


def page_xml(spec):
    """The PAGE-XML bytes of a page spec: line ids ``l<n>``, word ids
    ``l<n>_w<m>``, glyph ids ``l<n>_w<m>_g<k>``, counted from 1."""
    n = len(spec)
    out = ['<?xml version="1.0" encoding="UTF-8"?>',
           '<PcGts xmlns="%s"><Metadata><Creator>portbench</Creator>'
           '</Metadata>' % NS,
           '<Page imageFilename="image.png" imageWidth="2000" '
           'imageHeight="%d">' % (40 * n + 40),
           '<TextRegion id="r1">', _coords(0, 0, 2000, 40 * n)]
    for li, words in enumerate(spec):
        y0, y1 = li * 40, li * 40 + 36
        lid = 'l%d' % (li + 1)
        out.append('<TextLine id="%s">' % lid)
        out.append(_coords(0, y0, 2000, y1))
        out.append('<Baseline points="0,%d 2000,%d"/>' % (y1 - 6, y1 - 6))
        x = 0
        texts = []
        for wi, glyphs in enumerate(words):
            wid = '%s_w%d' % (lid, wi + 1)
            width = 12 * max(len(glyphs), 1)
            out.append('<Word id="%s">' % wid)
            out.append(_coords(x, y0, x + width, y1))
            for gi, alts in enumerate(glyphs):
                gx = x + 12 * gi
                out.append('<Glyph id="%s_g%d">' % (wid, gi + 1))
                out.append(_coords(gx, y0, gx + 11, y1))
                out.extend(_textequiv(ch, conf) for ch, conf in alts)
                out.append('</Glyph>')
            text = ''.join(alts[0][0] for alts in glyphs)
            texts.append(text)
            out.append(_textequiv(text, 0.9))
            out.append('</Word>')
            x += width + 12
        out.append(_textequiv(' '.join(texts), 0.9))
        out.append('</TextLine>')
    out.append('</TextRegion></Page></PcGts>')
    return ''.join(out).encode('utf-8')

