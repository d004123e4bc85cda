"""OCR post-correction processor on PAGE-XML (ocrd-cor-asv-ann-process).

A copy of the JAX package's ``wrapper/transcode.py`` (host code) that serves
through the port's ``Sequence2Sequence``; it imports nothing of
that package.

Re-derivation of the reference ANNCorrection processor
(wrapper/transcode.py:45-793) on this framework's PAGE layer:

1. walk region->line->word->glyph in reading order, building per-line
   sequences of TextEquiv alternative lists with artificial whitespace and
   newline entries (index=-1),
2. concatenate into confusion-network ("confmat") input lines recording a
   string-position -> TextEquiv map; empty OCR text becomes the GAP char,
3. correct the lines with the seq2seq model on ``device`` (greedy or
   beamed; `cuda` unless the parameter names another device),
4. convert the decoder's soft attention alignments to a hard monotone
   input->output position path via Viterbi search,
5. rewrite each TextEquiv along the path with whitespace-preservation
   rules (whitespace elements only hold whitespace; non-whitespace
   elements never start/end with whitespace — edits pushed to neighbors),
6. re-segment Words: merge around deleted whitespace, split at introduced
   whitespace (with proportional coordinate splitting),
7. recompute word/line/region text bottom-up (readingDirection,
   textLineOrder, ReadingOrder groups, Relation type=join), and drop
   now-inconsistent lower levels.
"""

import numpy as np

from ..utils import page as P
from ..utils.data import GAP
from .base import PageProcessor, processor_cli


from .resources import resolve_resource


class ArtificialTextEquiv:
    """In-memory TextEquiv for implicit whitespace (index=-1) — these do
    not belong to the XML hierarchy (reference transcode.py:220-227)."""

    def __init__(self, unicode, conf=1.0, index=-1, parent=None):
        self.unicode = unicode
        self.conf = conf
        self.index = index
        self.parent = parent


class ANNCorrection(PageProcessor):
    """Correct OCR text with a character-level attention seq2seq model."""

    executable = 'ocrd-cor-asv-ann-process'
    # one model instance, pages batched inside (see process_workspace);
    # mirrors the reference's max_workers = 1 (transcode.py:46)
    max_workers = 1
    parameter_schema = {
        'model_file': {'type': 'string', 'required': True},
        'textequiv_level': {'type': 'string', 'default': 'glyph',
                            'enum': ['line', 'word', 'glyph']},
        'charmap': {'type': 'object', 'default': {}},
        'rejection_threshold': {'type': 'number', 'default': 0.5},
        'relative_beam_width': {'type': 'number', 'default': 0.2},
        'fixed_beam_width': {'type': 'number', 'default': 15},
        'fast_mode': {'type': 'boolean', 'default': False},
        # the port's own parameter: the torch device the model serves
        # on; without a GPU it has to be 'cpu', else setup() raises
        'device': {'type': 'string', 'default': 'cuda'},
    }

    def setup(self):
        from ..models.api import Sequence2Sequence
        model_file = resolve_resource(self.parameter['model_file'])
        self.s2s = Sequence2Sequence(logger=self.logger,
                                     device=self.parameter['device'])
        self.s2s.load_config(model_file)
        self.s2s.configure()
        self.s2s.load_weights(model_file)
        self.s2s.rejection_threshold = self.parameter['rejection_threshold']
        self.s2s.beam_width_in = int(self.parameter['fixed_beam_width'])
        self.s2s.beam_threshold_in = self.parameter['relative_beam_width']
        self.logger.debug('Loaded model_file %r',
                          self.parameter['model_file'])

    def process_workspace(self, workspace, input_grps, output_grp,
                          page_ids=None):
        """Document-level flow with cross-page line batching.

        The reference parallelizes pages across worker processes (with a
        METS server) but caps the model processor at max_workers=1
        (transcode.py:46); the accelerator-first equivalent is to batch *lines
        across pages* into full decode batches inside one process:
        all pages are parsed first, their lines corrected in one
        (chunked) device call, then results are written back per page.
        """
        from ..utils.workspace import Workspace
        from ..utils.page import parse_page
        if isinstance(workspace, str):
            workspace = Workspace(workspace)
        if isinstance(input_grps, str):
            input_grps = input_grps.split(',')
        self.verify(input_grps)
        files = workspace.page_files(input_grps[0])
        if not files:
            from .base import ParameterError
            raise ParameterError('input fileGrp %r contains no page '
                                 'files' % input_grps[0])
        pages = page_ids or [p for p in workspace.page_ids() if p in files]
        missing = [p for p in pages if p not in files]
        if missing:
            # explicitly requested pages absent from the input fileGrp:
            # log and continue with the rest, like the base runner
            for p in missing:
                self.logger.error('page "%s" missing from fileGrp %s',
                                  p, input_grps[0])
            pages = [p for p in pages if p in files]
        docs = {pid: parse_page(files[pid].path) for pid in pages}
        # phase 1: collect line sequences over all pages
        all_inputs, all_starts, page_slices = [], [], {}
        for pid in pages:
            inputs, starts = self._prepare_page(docs[pid], pid)
            page_slices[pid] = (len(all_inputs),
                                len(all_inputs) + len(inputs))
            all_inputs.extend(inputs)
            all_starts.extend(starts)
        # phase 2: one batched correction over every line of the document
        self.logger.info('correcting %d lines across %d pages',
                         len(all_inputs), len(pages))
        outputs = self.s2s.correct_lines(
            all_inputs, conf=all_inputs,
            fast=self.parameter['fast_mode'],
            greedy=self.parameter['fast_mode'])
        # phase 3: write back per page
        for pid in pages:
            lo, hi = page_slices[pid]
            self._apply_page(
                docs[pid], pid, all_inputs[lo:hi], all_starts[lo:hi],
                tuple(o[lo:hi] for o in outputs))
            if output_grp:
                workspace.add_file(
                    output_grp, pid, docs[pid].to_bytes(),
                    file_id='%s_%s' % (output_grp, pid))
        workspace.save()

    def _prepare_page(self, doc, page_id):
        level = self.parameter['textequiv_level']
        self.logger.info('Correcting text in page %r at the %s level',
                         page_id, level)
        line_sequences = _page_get_line_sequences_at(level, doc,
                                                     logger=self.logger)
        return _line_sequences2confmat_sequences(
            self.s2s.mapping, line_sequences,
            charmap=self.parameter['charmap'])

    def process_page(self, docs, page_id):
        doc = docs[0]
        input_lines, textequiv_starts = self._prepare_page(doc, page_id)
        outputs = self.s2s.correct_lines(
            input_lines, conf=input_lines,
            fast=self.parameter['fast_mode'],
            greedy=self.parameter['fast_mode'])
        return self._apply_page(doc, page_id, input_lines,
                                textequiv_starts, outputs)

    def _apply_page(self, doc, page_id, input_lines, textequiv_starts,
                    outputs):
        level = self.parameter['textequiv_level']
        output_lines, output_probs, output_scores, alignments = outputs
        for (input_line, output_line, output_prob, output_score,
             alignment, textequivs) in zip(
                 input_lines, output_lines, output_probs, output_scores,
                 alignments, textequiv_starts):
            input_line_top = ''.join(chunk[0][0] for chunk in input_line)
            input_line_len = sum(
                max((len(alt[0]) for alt in chunk), default=0)
                for chunk in input_line)
            realignment, distance = _alignment2path(
                alignment, input_line_len, len(output_line),
                1.0 / self.s2s.voc_size)
            line, new_sequence = _update_sequence(
                input_line, output_line, output_prob, output_score,
                realignment, textequivs, self.logger)
            if level != 'line':
                _resegment_sequence(new_sequence, level, logger=self.logger)
            if input_line_top != output_line:
                self.logger.info(
                    'corrected line "%s" with %d elements, ppl: %.3f, '
                    'CER: %.1f%%', line.id,
                    len([x for x in new_sequence if x.index != -1]),
                    float(np.exp(output_score)),
                    distance / max(len(realignment), 1) * 100)
            else:
                self.logger.info('kept line "%s"', line.id)
        if level != 'region':
            page_update_higher_textequiv_levels(level, doc)
        if level != 'glyph':
            page_remove_lower_textequiv_levels(level, doc)
        return doc


def _page_get_line_sequences_at(level, doc, logger=None):
    """Per-line sequences of TextEquiv lists at `level`, with artificial
    whitespace/newline entries (reference transcode.py:161-234)."""
    import logging
    logger = logger or logging.getLogger(__name__)
    sequences = []
    regions = doc.get_regions()
    if not regions:
        logger.warning('Page contains no text regions')
    for region in regions:
        lines = region.get_lines()
        if not lines:
            logger.warning('Region "%s" contains no text lines', region.id)
        for line in lines:
            sequences.append([])
            if level == 'line':
                textequivs = line.get_textequivs()
                if textequivs:
                    sequences[-1].append(textequivs)
                else:
                    logger.warning('Line "%s" contains no text results',
                                   line.id)
            else:
                words = line.get_words()
                if not words:
                    logger.warning('Line "%s" contains no word', line.id)
                    continue  # no EOL
                last_parent = None
                for word in words:
                    if level == 'word':
                        textequivs = word.get_textequivs()
                        if textequivs:
                            sequences[-1].append(textequivs)
                            last_parent = word
                        else:
                            logger.warning(
                                'Word "%s" contains no text results',
                                word.id)
                            continue  # no inter-word
                    else:
                        glyphs = word.get_glyphs()
                        if not glyphs:
                            logger.warning('Word "%s" contains no glyphs',
                                           word.id)
                            continue  # no inter-word
                        for glyph in glyphs:
                            textequivs = glyph.get_textequivs()
                            if not textequivs:
                                logger.warning(
                                    'Glyph "%s" contains no text results',
                                    glyph.id)
                                # treat as gap
                                te = glyph.add_textequiv('', conf=1.0)
                                te.parent = glyph
                                textequivs = [te]
                            sequences[-1].append(textequivs)
                            last_parent = glyph
                    sequences[-1].append([ArtificialTextEquiv(
                        ' ', conf=1.0, parent=last_parent)])
                if sequences[-1]:
                    sequences[-1].pop()  # no trailing inter-word space
            sequences[-1].append([ArtificialTextEquiv(
                '\n', conf=1.0,
                parent=line if level == 'line' else last_parent)])
    return [seq for seq in sequences if len(seq) > 1]


def _line_sequences2confmat_sequences(mapping, line_sequences, charmap=None):
    """Concatenate TextEquiv sequences into confmat lines + position maps
    (reference transcode.py:236-277)."""
    if charmap:
        charmap = str.maketrans(charmap)
    input_lines, textequiv_starts = [], []
    for line_sequence in line_sequences:
        i = 0
        input_lines.append([])
        textequiv_starts.append({})
        for textequivs in line_sequence:
            textequiv_starts[-1][i] = textequivs
            for textequiv in textequivs:
                uni = textequiv.unicode or ''
                if charmap:
                    uni = uni.translate(charmap)
                if not uni:
                    # empty element (OCR rejection): reserve the GAP char
                    assert GAP not in mapping, \
                        'GAP char must not be mapped (needed for gap repair)'
                    uni = GAP
                if uni != (textequiv.unicode or ''):
                    textequiv.unicode = uni
                if textequiv.conf is None:
                    textequiv.conf = 1.0
            j = max((len(te.unicode) for te in textequivs), default=0)
            input_lines[-1].append([(te.unicode, te.conf)
                                    for te in textequivs])
            i += j
    return input_lines, textequiv_starts


def _alignment2path(alignment, i_max, j_max, min_score):
    """Viterbi decoding of a soft input-output alignment matrix into a
    hard monotone path {input_pos: output_pos}
    (reference transcode.py:279-349). `alignment` is a list over output
    positions of score vectors over input positions."""
    if i_max < 1 or j_max < 1 or not len(alignment):
        return {0: 0, i_max: j_max}, 0.0
    alignment = np.asarray(
        [np.asarray(a)[:i_max] if len(np.asarray(a)) >= i_max
         else np.pad(np.asarray(a, dtype=np.float32), (0, i_max - len(a)))
         for a in alignment[:j_max]], dtype=np.float32)  # (j_max, i_max)
    if alignment.shape[0] < j_max:
        alignment = np.pad(alignment,
                           ((0, j_max - alignment.shape[0]), (0, 0)))
    # sparse forward pass: only where scores exceed min_score
    viterbi = np.zeros((i_max, j_max), np.float32)
    mask = alignment.T > min_score  # (i_max, j_max)
    mask[0, 0] = True
    for j in range(j_max):
        cols = np.nonzero(mask[:, j])[0]
        for i in cols:
            best = 0.0
            if i > 0:
                best = max(best, viterbi[i - 1, j])
            if j > 0:
                best = max(best, viterbi[i, j - 1])
            if i > 0 and j > 0:
                best = max(best, viterbi[i - 1, j - 1])
            viterbi[i, j] = alignment[j, i] + best
    # backward pass from the best end point: when lengths differ, search
    # the best end among the last few rows/cols (negative-slice semantics
    # like the reference, transcode.py:320-324)
    if i_max <= j_max:
        i = i_max - 1
    else:
        i = max(0, j_max - 2 + int(
            np.argmax(viterbi[j_max - i_max - 2:, j_max - 1])))
    if j_max <= i_max:
        j = j_max - 1
    else:
        j = max(0, i_max - 2 + int(
            np.argmax(viterbi[i_max - 1, i_max - j_max - 2:])))
    dist = 0.0
    realignment = {i_max: j_max}
    while i >= 0 and j >= 0:
        dist += 1.0 - float(alignment[j, i])
        realignment[i] = j
        up = viterbi[i - 1, j] if i > 0 else -1
        left = viterbi[i, j - 1] if j > 0 else -1
        diag = viterbi[i - 1, j - 1] if (i > 0 and j > 0) else -1
        if up > left:
            if up > diag:
                i -= 1
            else:
                i -= 1
                j -= 1
        elif left > diag:
            j -= 1
        else:
            i -= 1
            j -= 1
        if i < 0 or j < 0:
            break
    realignment[0] = 0
    return realignment, dist


def _alignment_path(input_text, output_text):
    """Hard path via string alignment (fallback when no soft scores;
    reference transcode.py:351-375)."""
    from ..lib.alignment import Alignment
    alignment = Alignment.best_alignment(input_text, output_text)
    realignment = {0: 0}
    i = j = 0
    dist = 0.0
    for s, t in alignment:
        if s:
            i += len(s)
        if t:
            j += len(t)
        if s != t:
            dist += 1.0
        realignment[i] = j
    dist /= max(len(alignment) - 1, 1)
    return realignment, dist


def _update_sequence(input_sequence, output_line, output_prob, score,
                     realignment, textequiv_starts, logger):
    """Rewrite TextEquivs along the alignment path with whitespace
    preservation (reference transcode.py:377-486)."""
    input_line = ''
    for chunk in input_sequence:
        input_line += sorted([alt[0] for alt in chunk], key=len)[-1]
    i_max = len(input_line)
    j_max = len(output_line)
    textequiv_starts.setdefault(i_max, None)
    first = textequiv_starts[0][0]
    line = first.parent
    while line is not None and line.tag not in ('TextLine',):
        line = line.parent
    assert line is not None, 'cannot locate parent TextLine'
    last = []
    sequence = []
    for i in textequiv_starts:
        if i in realignment:
            j = realignment[i]
        else:
            j = last[1]  # element was deleted
        if last:
            input_ = input_line[last[0]:i]
            output = output_line[last[1]:j]
            prob = output_prob[last[1]:j]
            textequivs = textequiv_starts[last[0]]
            unicodes = [te.unicode for te in textequivs]
            assert input_ in unicodes, (
                'no source element alternative %s matches input section '
                '"%s" in line "%s"' % (unicodes, input_, line.id))
            textequiv = textequivs[0]
            # whitespace redistribution rules:
            # a whitespace element may only keep whitespace (push
            # non-whitespace onto neighbors); a non-whitespace element
            # must not begin/end with whitespace
            if textequiv.index == -1:
                if output and not output.startswith((' ', '\n')) \
                        and sequence:
                    while output and not output.startswith((' ', '\n')):
                        sequence[-1].unicode = \
                            sequence[-1].unicode + output[0]
                        last[1] += 1
                        output = output[1:]
                if output and not output.endswith((' ', '\n')):
                    j -= len(output.split(' ')[-1])
                    output = output_line[last[1]:j]
                if output.split() and sequence:
                    while output.split():
                        sequence[-1].unicode = \
                            sequence[-1].unicode + output[0]
                        last[1] += 1
                        output = output[1:]
            else:
                if output.startswith(' ') and sequence \
                        and sequence[-1].index == -1:
                    while output.startswith(' '):
                        sequence[-1].unicode = \
                            sequence[-1].unicode + output[0]
                        last[1] += 1
                        output = output[1:]
                if output.endswith((' ', '\n')) and i < i_max \
                        and textequiv_starts[i][0].index == -1:
                    while output.endswith((' ', '\n')):
                        j -= 1
                        output = output[:-1]
            textequiv.unicode = output
            textequiv.conf = float(np.mean(prob)) if prob else 1.0
            sequence.append(textequiv)
        last = [i, j]
    assert last == [i_max, j_max], (
        'alignment path did not reach top: %d/%d vs %d/%d in line "%s"'
        % (last[0], last[1], i_max, j_max, line.id))
    for i, textequiv in enumerate(sequence):
        assert not textequiv.unicode.split() or textequiv.index != -1, (
            'output "%s" will be lost at (whitespace) element %d in line '
            '"%s"' % (textequiv.unicode, i, line.id))
    return line, sequence


def _word_of(textequiv, level):
    parent = textequiv.parent
    if level == 'glyph' and parent is not None and parent.tag == 'Glyph':
        return parent.parent
    return parent


def _resegment_sequence(sequence, level, logger=None):
    """Merge Words around deleted whitespace; split at introduced
    whitespace (reference transcode.py:488-548).

    Successive operations may touch the same Word (e.g. a merge at one
    whitespace followed by a split inside the merged word, or two merges
    sharing a word): a replacement map resolves stale references to the
    word that currently holds the content. (The reference silently loses
    the later edit in these corners, transcode.py:527-548.)"""
    import logging
    logger = logger or logging.getLogger(__name__)
    replaced = {}

    def resolve(word):
        while word is not None and id(word.elem) in replaced:
            word = replaced[id(word.elem)]
        return word

    def in_line(textline, word):
        return any(e is word.elem for e in textline.elem)

    for i, textequiv in enumerate(sequence):
        word = resolve(_word_of(textequiv, level))
        if word is None or word.tag != 'Word':
            continue
        textline = word.parent
        if textequiv.index == -1:
            if not textequiv.unicode:
                # whitespace deleted: merge adjacent words
                if i == 0 or i == len(sequence) - 1:
                    logger.error('cannot merge Words at the %s of line "%s"',
                                 'end' if i else 'start', textline.id)
                    continue
                prev_word = resolve(_word_of(sequence[i - 1], level))
                next_word = resolve(_word_of(sequence[i + 1], level))
                if prev_word is None or next_word is None or \
                        prev_word.elem is next_word.elem:
                    continue
                if not (in_line(textline, prev_word)
                        and in_line(textline, next_word)):
                    logger.warning('skipping merge of displaced words '
                                   'in line "%s"', textline.id)
                    continue
                merged = _merge_words(textline, prev_word, next_word,
                                      logger)
                replaced[id(prev_word.elem)] = merged
                replaced[id(next_word.elem)] = merged
        elif ' ' in textequiv.unicode:
            # whitespace introduced: split word
            if not in_line(textline, word):
                logger.warning('skipping split of displaced word '
                               'in line "%s"', textline.id)
                continue
            if level == 'glyph':
                glyph = textequiv.parent
                right = _split_word_at_glyph(textline, word, glyph)
            else:
                right = _split_word_at_spaces(textline, word)
            if right is not None:
                # later references (e.g. a following whitespace merge)
                # concern the rightmost fragment
                replaced[id(word.elem)] = right


def _union_points(a, b):
    pts = a + b
    if not pts:
        return []
    x0, y0, x1, y1 = P.points_bbox(pts)
    return P.bbox_points(x0, y0, x1, y1)


def _merge_words(textline, prev_word, next_word, logger):
    doc = textline.doc
    merged = P.add_word(textline, (prev_word.id or '') + '.' +
                        (next_word.id or ''))
    pts = _union_points(prev_word.get_points(), next_word.get_points())
    if pts:
        merged.set_points(pts)
    # move glyphs
    for glyph in prev_word.get_glyphs() + next_word.get_glyphs():
        merged.elem.append(glyph.elem)
    pt = prev_word.get_textequivs()
    nt = next_word.get_textequivs()
    text = (pt[0].unicode if pt else '') + (nt[0].unicode if nt else '')
    conf = 1.0
    if pt and pt[0].conf is not None:
        conf *= pt[0].conf
    if nt and nt[0].conf is not None:
        conf *= nt[0].conf
    merged.add_textequiv(text, conf=conf)
    # place merged at prev position, drop both originals
    pos = textline.index_of(prev_word)
    textline.remove_child(merged)
    textline.insert_child(pos, merged.elem)
    textline.remove_child(prev_word)
    textline.remove_child(next_word)
    logger.debug('merged %s and %s to %s in line %s', prev_word.id,
                 next_word.id, merged.id, textline.id)
    return merged


def _split_box(word_pts, fract):
    if not word_pts:
        return [], []
    x0, y0, x1, y1 = P.points_bbox(word_pts)
    xm = int(x0 + (x1 - x0) * fract)
    return P.bbox_points(x0, y0, xm, y1), P.bbox_points(xm, y0, x1, y1)


def _split_word_at_glyph(textline, word, glyph):
    """Split `word` at `glyph` (removed), distributing glyphs.
    Returns the right part (or None when the glyph is missing)."""
    glyphs = word.get_glyphs()
    try:
        pos = next(i for i, g in enumerate(glyphs)
                   if g.elem is glyph.elem)
    except StopIteration:
        return None
    gp = glyph.get_points()
    wp = word.get_points()
    if gp and wp:
        x0, y0, x1, y1 = P.points_bbox(wp)
        gx0, _, gx1, _ = P.points_bbox(gp)
        prev_pts = P.bbox_points(x0, y0, gx0, y1)
        next_pts = P.bbox_points(gx0, y0, x1, y1)
    else:
        prev_pts = next_pts = []
    idx = textline.index_of(word)
    prev_ = P.add_word(textline, (word.id or 'w') + '_l')
    next_ = P.add_word(textline, (word.id or 'w') + '_r')
    if prev_pts:
        prev_.set_points(prev_pts)
    if next_pts:
        next_.set_points(next_pts)
    for g in glyphs[:pos]:
        prev_.elem.append(g.elem)
    for g in glyphs[pos + 1:]:
        next_.elem.append(g.elem)
    textline.remove_child(prev_)
    textline.remove_child(next_)
    textline.insert_child(idx, next_.elem)
    textline.insert_child(idx, prev_.elem)
    textline.remove_child(word)
    return next_


def _split_word_at_spaces(textline, word):
    """Split `word` at every space in its first TextEquiv, proportionally
    splitting the bounding box (reference transcode.py:602-628)."""
    te = word.get_textequivs()
    text = te[0].unicode if te else ''
    conf = te[0].conf if te and te[0].conf is not None else 1.0
    parts = text.split(' ')
    if len(parts) < 2:
        return None
    idx = textline.index_of(word)
    wp = word.get_points()
    total = max(len(text), 1)
    offset = 0
    new_words = []
    for k, part in enumerate(parts):
        w = P.add_word(textline, '%s_%d' % (word.id or 'w', k))
        if wp:
            f0 = offset / total
            f1 = min((offset + len(part)) / total, 1.0)
            x0, y0, x1, y1 = P.points_bbox(wp)
            w.set_points(P.bbox_points(int(x0 + (x1 - x0) * f0), y0,
                                       int(x0 + (x1 - x0) * f1), y1))
        w.add_textequiv(part, conf=conf)
        new_words.append(w)
        offset += len(part) + 1
    for w in new_words:
        textline.remove_child(w)
    for w in reversed(new_words):
        textline.insert_child(idx, w.elem)
    textline.remove_child(word)
    return new_words[-1]


def _first_unicode(element):
    tes = element.get_textequivs()
    return tes[0].unicode if tes else ''


def _first_conf(element):
    tes = element.get_textequivs()
    if tes and tes[0].conf is not None:
        return tes[0].conf
    return 1.0


def page_update_higher_textequiv_levels(level, doc, overwrite=True):
    """Recompute word/line/region text bottom-up, honoring
    readingDirection, textLineOrder, ReadingOrder and Relation type=join
    (reference transcode.py:630-742)."""
    page = doc.page
    joins = []
    for rels in page.children('Relations'):
        for rel in rels.children('Relation'):
            if rel.attr('type') == 'join':
                src = rel.children('SourceRegionRef')
                tgt = rel.children('TargetRegionRef')
                if src and tgt:
                    joins.append((src[0].attr('regionRef'),
                                  tgt[0].attr('regionRef')))
    if level == 'region':
        return
    ro_map = doc.reading_order_map()
    # children first: document order lists a parent region before its
    # nested subregions, so reverse it — a parent's concatenation must
    # read its children's freshly updated TextEquivs (the reference's
    # "traverse in a depth-first strategy"; sibling order is irrelevant
    # here because each region only reads its own descendants)
    for region in reversed(doc.get_regions(order=False)):
        subregions = region.children('TextRegion')
        if subregions:
            # concatenate in ReadingOrder when all subregions are listed
            # there as an ordered group (reference transcode.py:666-677)
            if all(s.id in ro_map for s in subregions) and \
                    ro_map[subregions[0].id][0] in ('OrderedGroup',
                                                    'OrderedGroupIndexed'):
                subregions = sorted(subregions,
                                    key=lambda s: ro_map[s.id][1])
            region_unicode = _first_unicode(subregions[0])
            for sub, nxt in zip(subregions, subregions[1:]):
                if (sub.id, nxt.id) not in joins:
                    region_unicode += '\n'
                region_unicode += _first_unicode(nxt)
            region_conf = (sum(_first_conf(s) for s in subregions)
                           / len(subregions))
        else:
            lines = region.get_lines()
            if (region.attr('textLineOrder')
                    or page.attr('textLineOrder')) == 'bottom-to-top':
                lines = list(reversed(lines))
            if level != 'line':
                for line in lines:
                    words = line.get_words()
                    if (line.attr('readingDirection')
                            or region.attr('readingDirection')
                            or page.attr('readingDirection')) == \
                            'right-to-left':
                        words = list(reversed(words))
                    if level != 'word':
                        for word in words:
                            glyphs = word.get_glyphs()
                            if (word.attr('readingDirection')
                                    or line.attr('readingDirection')
                                    or region.attr('readingDirection')
                                    or page.attr('readingDirection')) == \
                                    'right-to-left':
                                glyphs = list(reversed(glyphs))
                            word_unicode = ''.join(
                                _first_unicode(g) for g in glyphs)
                            word_conf = (sum(_first_conf(g) for g in glyphs)
                                         / len(glyphs)) if glyphs else 1.0
                            if not word.get_textequivs() or overwrite:
                                word.remove_textequivs()
                                word.add_textequiv(word_unicode,
                                                   conf=word_conf)
                    line_unicode = ' '.join(
                        _first_unicode(w) for w in words)
                    line_conf = (sum(_first_conf(w) for w in words)
                                 / len(words)) if words else 1.0
                    if not line.get_textequivs() or overwrite:
                        line.remove_textequivs()
                        line.add_textequiv(line_unicode, conf=line_conf)
            region_unicode = ''
            region_conf = 0.0
            if lines:
                region_unicode = _first_unicode(lines[0])
                for line, nxt in zip(lines, lines[1:]):
                    words = line.get_words()
                    next_words = nxt.get_words()
                    if not (words and next_words
                            and (words[-1].id, next_words[0].id) in joins):
                        region_unicode += '\n'
                    region_unicode += _first_unicode(nxt)
                region_conf = (sum(_first_conf(l) for l in lines)
                               / len(lines))
        if not region.get_textequivs() or overwrite:
            region.remove_textequivs()
            region.add_textequiv(region_unicode, conf=region_conf)


def page_remove_lower_textequiv_levels(level, doc):
    """Drop hierarchy levels below `level` (reference transcode.py:778-793)."""
    if level == 'region':
        for region in doc.get_regions(order=False):
            region.remove_textequivs()
        return
    for line in doc.get_lines():
        if level == 'line':
            line.remove_children('Word')
        else:
            for word in line.get_words():
                if level == 'word':
                    word.remove_children('Glyph')
                else:
                    for glyph in word.get_glyphs():
                        glyph.remove_children('Graphemes')


ocrd_cor_asv_ann_process = processor_cli(ANNCorrection)


if __name__ == '__main__':
    ocrd_cor_asv_ann_process()
