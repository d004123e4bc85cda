"""The reference's inputs of a page.

Works out again, from the page specs the benchmark drew, what the
processor (ocrd-cor-asv-ann-process at the glyph level) gives the model:

- a line's input is a confusion network: one position per glyph with
  each of its alternatives' confidence at that character, one position
  of confidence 1 for the space between words and one for the closing
  newline (the reference's transcode.py:161-277 and seq2seq.py:1020-1119:
  a later alternative of the same character overwrites an earlier one);
- a batch of lines runs at the padded length of the bucket (32, 64, 96,
  128, 192, 256, 384, 512, 768, 1024) that holds its longest line.

And what the processor writes back for a line (`expected_line`, from
``reference/realign.py``), beside a plain reading of the PAGE-XML the
program wrote (`written_lines`), in one form for both.
"""

import xml.etree.ElementTree as ET

import numpy as np
import torch

from . import realign

BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def bucket(n):
    for b in BUCKETS:
        if n <= b:
            return b
    return -(-n // BUCKETS[-1]) * BUCKETS[-1]


def line_positions(words):
    """The alternatives of each input position of one line (words of
    glyphs of (char, conf) alternatives)."""
    out = []
    for k, glyphs in enumerate(words):
        if k:
            out.append([(' ', 1.0)])
        out.extend(glyphs)
    out.append([('\n', 1.0)])
    return out


def input_vectors(lines, c2i, V):
    """(B, T, V) float32 vectors of a list of position lists, zero past
    each line, and the lines' lengths."""
    T = max(len(line) for line in lines)
    x = np.zeros((len(lines), T, V), np.float32)
    for b, line in enumerate(lines):
        for t, alts in enumerate(line):
            for ch, conf in alts:
                x[b, t, c2i.get(ch, 0)] = conf
    return torch.from_numpy(x), torch.tensor([len(l) for l in lines])



def expected_line(lid, words, out, prob, rows, V):
    """The reference's account of line `lid` (words of glyphs of (char,
    conf) alternatives, ids as the generator gives them) after the
    processor took the served line `out`, its probabilities `prob` and
    alignment rows `rows`: see `written_lines`."""
    kinds, owner, ids, alts = [], [], [], {}
    for m, glyphs in enumerate(words):
        wid = '%s_w%d' % (lid, m + 1)
        if m:
            kinds.append('s')
            owner.append(ids[-1][0])
        ids.append((wid, []))
        for k, glyph in enumerate(glyphs):
            gid = '%s_g%d' % (wid, k + 1)
            kinds.append('g')
            owner.append(wid)
            ids[-1][1].append(gid)
            alts[gid] = [(ch, realign.fmt(c)) for ch, c in glyph[1:]]
    kinds.append('n')
    owner.append(ids[-1][0])
    path = realign.viterbi_path(rows, len(kinds), len(out), 1.0 / V)
    texts = realign.update_line(kinds, path, out, prob)
    got, text, conf = realign.line_output(kinds, owner, ids, texts)
    return dict(words=[(wid, [(g, t, c, alts[g]) for g, t, c in gl], wt, wc)
                       for wid, gl, wt, wc in got],
                text=text, conf=conf)


def written_lines(xml):
    """{line id: its words as (id, [(glyph id, text, conf, [(text,
    conf)] of its other alternatives)], text, conf), its text and conf}
    of a PAGE-XML document, read plainly."""
    root = ET.fromstring(xml)
    ns = root.tag[1:].split('}')[0] if root.tag.startswith('{') else ''

    def q(tag):
        return '{%s}%s' % (ns, tag) if ns else tag

    def te(elem):
        out = []
        for t in elem.findall(q('TextEquiv')):
            u = t.find(q('Unicode'))
            conf = t.get('conf')
            out.append(((u.text or '') if u is not None else '',
                        float(conf) if conf is not None else None))
        return out

    lines = {}
    for line in root.iter(q('TextLine')):
        words = []
        for word in line.findall(q('Word')):
            glyphs = []
            for glyph in word.findall(q('Glyph')):
                t = te(glyph)
                glyphs.append((glyph.get('id'),) + (t[0] if t else ('', None))
                              + (t[1:],))
            t = te(word)
            words.append((word.get('id'), glyphs) + (t[0] if t else
                                                      ('', None)))
        t = te(line)
        text, conf = t[0] if t else ('', None)
        lines[line.get('id')] = dict(words=words, text=text, conf=conf)
    return lines
