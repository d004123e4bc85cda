"""N-way line alignment/voting processor (ocrd-cor-asv-ann-align).

A copy of the JAX package's ``wrapper/align.py`` (host code), kept here so
the port imports nothing of that package.

Re-derivation of reference AlignLines (wrapper/align.py:27-342): per
TextLine id, collect each input fileGrp's text and per-character
confidence sequence (projected from glyph-, word- or line-level conf),
pairwise-align all inputs, order them along a minimum-total-distance path
(brute-force over permutations), incrementally expand the pairwise
alignments into an N-way character lattice with merge/split repair, and
vote per position by majority / max confidence / combined score. The
result overwrites the first fileGrp's line (dropping Word/Glyph children)
and higher levels are updated.
"""

import itertools

from ..lib.alignment import Alignment
from .base import PageProcessor, processor_cli
from .transcode import page_update_higher_textequiv_levels


def pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def avg(values):
    return sum(values) / len(values) if values else 0


def page_get_line_sequences(doc, logger=None):
    """Per line: (text, per-char confidences) projected from the deepest
    available annotation level (reference align.py:263-329)."""
    result = dict()
    for region in doc.get_regions():
        lines = region.get_lines()
        for line in lines:
            line_equivs = line.get_textequivs()
            if not line_equivs:
                if logger:
                    logger.warning('Line "%s" contains no text results',
                                   line.id)
                continue
            line_str = line_equivs[0].unicode or ''
            # `or` treats an explicit conf of 0 as absent — kept as-is
            # for parity (the reference uses the same idiom, align.py:292)
            line_conf0 = float(line_equivs[0].conf or 1.0)
            line_confs = []
            words = line.get_words()
            for word in words:
                word_equivs = word.get_textequivs()
                if not word_equivs:
                    line_confs = []
                    break
                word_conf0 = float(word_equivs[0].conf or line_conf0)
                word_confs = []
                for glyph in word.get_glyphs():
                    glyph_equivs = glyph.get_textequivs()
                    if not glyph_equivs:
                        word_confs = []
                        break
                    glyph_conf0 = float(glyph_equivs[0].conf or word_conf0)
                    word_confs.extend(
                        [glyph_conf0] * len(glyph_equivs[0].unicode or ''))
                if not word_confs:
                    word_confs = [word_conf0] * len(
                        word_equivs[0].unicode or '')
                line_confs.extend(word_confs)
                if word is not words[-1]:
                    line_confs.append(line_conf0)
            if not line_confs:
                line_confs = [line_conf0] * len(line_str)
            elif len(line_confs) > len(line_str):
                line_confs = line_confs[:len(line_str)]
            elif len(line_confs) < len(line_str):
                fill = avg(line_confs)
                line_confs += [fill] * (len(line_str) - len(line_confs))
            result[line] = (line_str, line_confs)
    return result


class _Lattice:
    """Growing N-way character lattice.

    One row per lattice position; each row holds the aligned chunk and a
    confidence for every input sequence.  Inputs are woven in one at a
    time along their pairwise alignment with an already-woven anchor
    input; rows fuse (or alignment entries coalesce) whenever the two
    sides chunk the anchor text differently."""

    def __init__(self, num_inputs):
        self.num_inputs = num_inputs
        self.rows = []       # [chunk per input] per lattice position
        self.row_confs = []  # [confidence per input] per position

    def seed(self, idx, text, confs):
        """Initialize one row per character of the first input.

        Slots of the not-yet-woven inputs start as gaps with confidence
        0 (the reference's avg([]) for an empty chunk) — a gap must
        never outvote a real character in confidence voting."""
        for char, conf in zip(text, confs):
            row = [''] * self.num_inputs
            row_conf = [0.0] * self.num_inputs
            row[idx] = char
            row_conf[idx] = conf
            self.rows.append(row)
            self.row_confs.append(row_conf)

    def _fuse_rows(self, at):
        """Collapse rows at/at+1 (chunks concatenate, confs average):
        the incoming alignment groups more anchor text into one chunk
        than the lattice currently does."""
        tail, tail_conf = self.rows.pop(at + 1), self.row_confs.pop(at + 1)
        self.rows[at] = [a + b for a, b in zip(self.rows[at], tail)]
        self.row_confs[at] = [avg([a, b]) for a, b
                              in zip(self.row_confs[at], tail_conf)]

    def _spill(self, idx, chunk, confs):
        """Attach overflow beyond the lattice end to the final row
        (every earlier input was shorter here)."""
        self.rows[-1][idx] += chunk
        self.row_confs[-1][idx] = avg([self.row_confs[-1][idx]] + confs)

    def weave(self, anchor, idx, alignment, confs):
        """Merge input `idx` into the lattice along its (mutable)
        pairwise alignment with the already-woven `anchor` input."""
        row = 0
        src_from = 0  # consumed chars of input idx
        entry = 0
        while entry < len(alignment):
            anchor_chunk = alignment[entry][0] or ''
            new_chunk = alignment[entry][1] or ''
            src_to = src_from + len(new_chunk)
            if row == len(self.rows):
                self._spill(idx, new_chunk, confs[src_from:src_to])
                src_from = src_to
                entry += 1
                continue
            have = self.rows[row][anchor]
            if len(anchor_chunk) > len(have):
                self._fuse_rows(row)
            elif len(anchor_chunk) < len(have):
                # coalesce alignment entries entry/entry+1 instead
                next_a, next_b = alignment[entry + 1]
                alignment[entry] = (anchor_chunk + (next_a or ''),
                                    new_chunk + (next_b or ''))
                del alignment[entry + 1]
            else:
                self.rows[row][idx] = new_chunk
                # an empty chunk (gap) scores 0, like the reference's
                # avg([]) — not 1.0, which would outvote real characters
                self.row_confs[row][idx] = (avg(confs[src_from:src_to])
                                            if src_to > src_from else 0.0)
                src_from = src_to
                row += 1
                entry += 1


def nway_align(charseqs, confseqs, aligner):
    """Expand pairwise alignments into an N-way character lattice.

    Returns (chars, confs): parallel lists over lattice positions of
    per-input alternative strings and confidences
    (reference align.py:127-219)."""
    n = len(charseqs)
    dist = {}
    aligns = {}
    for i in range(n):
        for j in range(i + 1, n):
            d, _, pairs = aligner.get_adjusted_distance(
                charseqs[i], charseqs[j], normalization=None, gtlevel=1,
                return_alignment=True)
            dist[i, j] = dist[j, i] = d
            aligns[i, j] = list(pairs)
            aligns[j, i] = [(b, a) for a, b in pairs]
    # order inputs along a minimum-total-distance path (brute force over
    # permutations; N is the number of input fileGrps, always tiny)
    order = min(itertools.permutations(range(n)),
                key=lambda p: sum(dist[e] for e in pairwise(p)))
    lattice = _Lattice(n)
    lattice.seed(order[0], charseqs[order[0]], confseqs[order[0]])
    for i, j in pairwise(order):
        lattice.weave(i, j, aligns[i, j], confseqs[j])
    return lattice.rows, lattice.row_confs


def vote(chars, confs, method):
    """Per-position choice by majority / confidence / combined score
    (reference align.py:221-246)."""
    linetext = ''
    lineconf = []
    for subchars, subconfs in zip(chars, confs):
        if method == 'majority':
            counts = [subchars.count(c) for c in subchars]
            best = counts.index(max(counts))
            linetext += subchars[best]
            lineconf.append(max(conf for count, conf
                                in zip(counts, subconfs)
                                if count == max(counts)))
        elif method == 'confidence':
            best = max(enumerate(subconfs), key=lambda x: x[1])[0]
            linetext += subchars[best]
            lineconf.append(subconfs[best])
        else:  # combined
            scores = dict()
            for c, conf in zip(subchars, subconfs):
                scores[c] = conf + scores.setdefault(c, 0)
            best = max(scores, key=scores.get)
            linetext += best
            lineconf.append(max(conf for c, conf in zip(subchars, subconfs)
                                if c == best))
    return linetext, avg(lineconf) if lineconf else 1.0


class AlignLines(PageProcessor):
    """Combine multiple OCR results by character-level alignment voting."""

    executable = 'ocrd-cor-asv-ann-align'
    input_file_grp_cardinality = (2, None)
    parameter_schema = {
        'method': {'type': 'string', 'default': 'majority',
                   'enum': ['majority', 'confidence', 'combined']},
    }

    def setup(self):
        pass

    def verify(self, input_grps):
        super().verify(input_grps)
        assert len(input_grps) > 2 or \
            self.parameter['method'] not in ('majority', 'combined'), \
            'need more than 2 input fileGrps to align in this mode'

    def process_page(self, docs, page_id):
        method = self.parameter['method']
        # Alignment carries set_seqs state, so it must be per page-call
        # (this processor runs page-parallel under
        # OCRD_MAX_PARALLEL_PAGES, wrapper/base.py)
        aligner = Alignment(logger=self.logger)
        result = None
        master = 0
        file_line2seq = [{} for _ in docs]
        file_id2line = [{} for _ in docs]
        for i, doc in enumerate(docs):
            if doc is None:
                continue
            file_line2seq[i] = page_get_line_sequences(doc, self.logger)
            file_id2line[i] = {line.id: line for line in file_line2seq[i]}
            if result is None:
                result = doc
                master = i
        if result is None:
            raise ValueError('no file in any input fileGrp for page %s'
                             % page_id)
        for line_id in file_id2line[master]:
            lines = [id2line.get(line_id) for id2line in file_id2line]
            line0 = lines[master]
            seqs = [line2seq[line]
                    for line, line2seq in zip(lines, file_line2seq)
                    if line in line2seq and line2seq[line][0]]
            if not seqs:
                continue
            charseqs, confseqs = zip(*seqs)
            chars, confs = nway_align(list(charseqs), list(confseqs),
                                      aligner)
            linetext, lineconf = vote(chars, confs, method)
            self.logger.debug('best voted line for "%s": %s', line_id,
                              linetext)
            tes = line0.get_textequivs()
            if tes:
                tes[0].unicode = linetext
                tes[0].conf = lineconf
            else:
                line0.add_textequiv(linetext, conf=lineconf)
            line0.remove_children('Word')
        page_update_higher_textequiv_levels('line', result)
        return result


ocrd_cor_asv_ann_align = processor_cli(AlignLines)


if __name__ == '__main__':
    ocrd_cor_asv_ann_align()
