"""The synthetic Fraktur corpus and its OCR noise model.

A frozen copy of the word list and confusion table of the port's
``utils/synthdata.py`` (the corpus that the bundled test models were
trained on), so that the benchmark's traffic stays the same whatever the
program later does to its own copy.
"""

WORDS = ("der die das und ist ein eine mit von auf nicht sich auch als "
         "wird nach bei aus durch über unter vor zwischen gegen ohne "
         "Mensch Welt Leben Zeit Jahr Hand Tag Nacht Haus Land Stadt "
         "Wasser Feuer Erde Licht Aufklärung Vernunft Freiheit Wissen "
         "Schrift Buch Seite Wort Sprache Geschichte Natur Wesen Geist"
         ).split()

# systematic Fraktur-style confusions (long s, broken ascenders, ...)
NOISE = {'s': 'ſ', 'f': 'ſ', 't': 'l', 'e': 'c', 'n': 'u', 'u': 'n',
         'r': 'x', 'i': 'j', 'h': 'b', 'ä': 'a'}


def corrupt(text, rng, noise_rate, drop_rate):
    """Systematic substitutions at `noise_rate`, random character drops
    at `drop_rate` (the noise model of the corpus; a character that is
    substituted is not dropped)."""
    sub, drop = rng.random((2, len(text)))
    out = []
    for ch, s, d in zip(text, sub.tolist(), drop.tolist()):
        if ch in NOISE and s < noise_rate:
            out.append(NOISE[ch])
        elif d >= drop_rate:
            out.append(ch)
    return ''.join(out)


def word(rng):
    return WORDS[int(rng.integers(len(WORDS)))]


def grid(rng, rows, cols, n):
    """`n` (row, col) pairs: every pair of the two lists once a block,
    each block shuffled, so every seed draws the same sizes in another
    order."""
    block = [(r, c) for r in rows for c in cols]
    out = []
    while len(out) < n:
        out.extend(block[i] for i in rng.permutation(len(block)))
    return out[:n]


def stratified(rng, lo, hi, n):
    """`n` whole numbers from lo..hi (inclusive): the range repeated
    and each repetition shuffled, so every seed draws the same sizes in
    another order."""
    span = list(range(lo, hi + 1))
    out = []
    while len(out) < n:
        block = list(span)
        rng.shuffle(block)
        out.extend(block)
    return out[:n]


def fill_line(rng, width):
    """Corpus words, separated by one space, up to `width` characters
    (at least one word)."""
    words = [word(rng)]
    length = len(words[0])
    while True:
        w = word(rng)
        if length + 1 + len(w) > width:
            return words
        words.append(w)
        length += 1 + len(w)
