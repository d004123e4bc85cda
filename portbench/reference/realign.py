"""The reference's account of what the processor writes into a page.

ocrd-cor-asv-ann-process at the glyph level, after the model corrected a
line (the reference's wrapper/transcode.py:279-548 and 630-742), done
again here on plain lists from the page spec and the served line, its
probabilities and its alignment rows:

1. `viterbi_path`: the soft alignment (one row over the input positions
   per output character) becomes a hard monotone path, input position
   -> output position, by a Viterbi search over the cells whose score
   exceeds 1/V, ending at the best of the last rows or columns where the
   lengths differ;
2. `update_line`: each input element (a glyph, the space between two
   words, the closing newline) takes the output between its start and
   the next element's on that path, with the whitespace rules (a space
   element keeps only whitespace and passes letters to its left
   neighbour; a glyph neither starts after a space element with a space
   nor ends before one with whitespace), and as its confidence the mean
   probability of the characters it took at first;
3. `resegment`: an emptied space merges its two words (id
   ``<left>.<right>``); a glyph whose text holds a space splits its word
   there and is dropped (ids ``<word>_l`` and ``<word>_r``); a later
   operation on a word that is gone acts on the word that took its
   place;
4. `line_output`: words take the concatenation of their glyphs' texts
   and their mean confidence, the line its words joined by a space.

Confidences are written as the PAGE attribute is, to 6 significant
digits, and read back before a mean is taken of them.
"""

import numpy as np


def fmt(conf):
    """A confidence as the PAGE attribute holds it, read back."""
    return float('%.6g' % conf)


def viterbi_path(rows, i_max, j_max, min_score):
    """{input position: output position} of the best monotone path."""
    if i_max < 1 or j_max < 1 or not len(rows):
        return {0: 0, i_max: j_max}
    a = np.zeros((j_max, i_max), np.float32)
    for j, row in enumerate(rows[:j_max]):
        row = np.asarray(row, np.float32)[:i_max]
        a[j, :len(row)] = row
    score = np.zeros((i_max, j_max), np.float32)
    for j in range(j_max):
        for i in range(i_max):
            if not (a[j, i] > min_score or (i == 0 and j == 0)):
                continue
            prev = [np.float32(0.0)]
            if i > 0:
                prev.append(score[i - 1, j])
            if j > 0:
                prev.append(score[i, j - 1])
            if i > 0 and j > 0:
                prev.append(score[i - 1, j - 1])
            score[i, j] = a[j, i] + max(prev)
    # the end: the last input and output position where the lengths
    # agree, else the best of the last rows (or columns), as the
    # reference's negative slices take them
    if i_max <= j_max:
        i = i_max - 1
    else:
        i = max(0, j_max - 2 + int(np.argmax(
            score[j_max - i_max - 2:, j_max - 1])))
    if j_max <= i_max:
        j = j_max - 1
    else:
        j = max(0, i_max - 2 + int(np.argmax(
            score[i_max - 1, i_max - j_max - 2:])))
    path = {i_max: j_max}
    while i >= 0 and j >= 0:
        path[i] = j
        up = score[i - 1, j] if i > 0 else -1
        left = score[i, j - 1] if j > 0 else -1
        diag = score[i - 1, j - 1] if i > 0 and j > 0 else -1
        if up > left and up > diag:
            i -= 1
        elif up > left or left <= diag:
            i, j = i - 1, j - 1
        else:
            j -= 1
    path[0] = 0
    return path


def update_line(kinds, path, out, prob):
    """The text and confidence of each element of a line.

    kinds: per element 'g' (a glyph, one input position), 's' (the space
    between two words) or 'n' (the newline); path from `viterbi_path`;
    out, prob: the served line and its characters' probabilities.
    Returns [text, conf] per element."""
    n = len(kinds)
    done = []
    last = None
    for i in range(n + 1):
        j = path[i] if i in path else last[1]
        if last is not None:
            lo = last[1]
            text = out[lo:j]
            p = prob[lo:j]
            if kinds[last[0]] != 'g':
                if text and not text.startswith((' ', '\n')) and done:
                    while text and not text.startswith((' ', '\n')):
                        done[-1][0] += text[0]
                        last[1] += 1
                        text = text[1:]
                if text and not text.endswith((' ', '\n')):
                    j -= len(text.split(' ')[-1])
                    text = out[last[1]:j]
                if text.split() and done:
                    while text.split():
                        done[-1][0] += text[0]
                        last[1] += 1
                        text = text[1:]
            else:
                if text.startswith(' ') and done \
                        and kinds[last[0] - 1] != 'g':
                    while text.startswith(' '):
                        done[-1][0] += text[0]
                        last[1] += 1
                        text = text[1:]
                if text.endswith((' ', '\n')) and i < n and kinds[i] != 'g':
                    while text.endswith((' ', '\n')):
                        j -= 1
                        text = text[:-1]
            done.append([text, float(np.mean(p)) if p else 1.0])
        last = [i, j]
    if last != [n, len(out)]:
        raise ValueError('the path ends at %r, not at %r'
                         % (last, [n, len(out)]))
    return done


def resegment(kinds, owner, words, texts):
    """Words after the merges and splits a line's new texts call for.

    kinds, texts: per element (texts from `update_line`); owner: per
    element, the id of the word it was read from (a space's and the
    newline's: the word before them); words: [(id, [glyph ids])] in
    order, the glyph ids in element order. Returns the line's words as
    [id, [glyph ids]]."""
    line = [[w, list(g)] for w, g in words]
    took = {}
    flat = iter([g for _, gs in words for g in gs])
    glyph_of = {e: next(flat) for e, kind in enumerate(kinds) if kind == 'g'}

    def find(w):
        while w in took:
            w = took[w]
        return next(x for x in line if x[0] == w)

    for e, kind in enumerate(kinds):
        word = find(owner[e])
        if kind != 'g':
            if texts[e] or e in (0, len(kinds) - 1):
                continue
            left, right = find(owner[e - 1]), find(owner[e + 1])
            if left is right:
                continue
            merged = ['%s.%s' % (left[0], right[0]), left[1] + right[1]]
            line[line.index(left)] = merged
            line.remove(right)
            took[left[0]] = took[right[0]] = merged[0]
        elif ' ' in texts[e]:
            if glyph_of[e] not in word[1]:
                continue
            at = word[1].index(glyph_of[e])
            lpart = [word[0] + '_l', word[1][:at]]
            rpart = [word[0] + '_r', word[1][at + 1:]]
            k = line.index(word)
            line[k:k + 1] = [lpart, rpart]
            took[word[0]] = rpart[0]
    return line


def line_output(kinds, owner, words, texts):
    """What the processor writes for one line: its words as (id,
    [(glyph id, text, conf)], text, conf), and the line's text and
    confidence."""
    glyphs = {}
    k = 0
    ids = [g for _, gs in words for g in gs]
    for e, kind in enumerate(kinds):
        if kind == 'g':
            glyphs[ids[k]] = (texts[e][0], fmt(texts[e][1]))
            k += 1
    out = []
    for wid, gids in resegment(kinds, owner, words,
                               [t for t, _ in texts]):
        gl = [(g,) + glyphs[g] for g in gids]
        conf = fmt(sum(c for _, _, c in gl) / len(gl)) if gl else fmt(1.0)
        out.append((wid, gl, ''.join(t for _, t, _ in gl), conf))
    conf = fmt(sum(w[3] for w in out) / len(out)) if out else fmt(1.0)
    return out, ' '.join(w[2] for w in out), conf
