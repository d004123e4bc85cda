"""Synthetic historical-OCR corpus generator (single source of truth).

A copy of the JAX package's ``utils/synthdata.py`` (numpy only), kept
here so the port imports nothing of that package; a test holds the two
against each other. The bundled testmodels (soak.d2.w128,
flagship.d2.w512) were trained on this distribution.
"""

import numpy as np

WORDS = ("der die das und ist ein eine mit von auf nicht sich auch als "
         "wird nach bei aus durch über unter vor zwischen gegen ohne "
         "Mensch Welt Leben Zeit Jahr Hand Tag Nacht Haus Land Stadt "
         "Wasser Feuer Erde Licht Aufklärung Vernunft Freiheit Wissen "
         "Schrift Buch Seite Wort Sprache Geschichte Natur Wesen Geist"
         ).split()

# systematic Fraktur-style confusions (long s, broken ascenders, ...)
NOISE = {'s': 'ſ', 'f': 'ſ', 't': 'l', 'e': 'c', 'n': 'u', 'u': 'n',
         'r': 'x', 'i': 'j', 'h': 'b', 'ä': 'a'}


def make_line(rng, min_words=3, max_words=8):
    k = rng.integers(min_words, max_words)
    return ' '.join(rng.choice(WORDS) for _ in range(k))


def corrupt(text, rng, noise_rate=0.12, drop_rate=0.01):
    """Apply the synthetic OCR noise model: systematic substitutions at
    `noise_rate`, random character drops at `drop_rate`."""
    out = []
    for ch in text:
        if ch in NOISE and rng.random() < noise_rate:
            out.append(NOISE[ch])
        elif rng.random() < drop_rate:
            continue
        else:
            out.append(ch)
    return ''.join(out)


def make_pairs(n, seed=7):
    """(noisy, clean) line pairs — the held-out evaluation distribution
    of tests/test_quality.py."""
    rng = np.random.default_rng(seed)
    lines = [make_line(rng) for _ in range(n)]
    return [(corrupt(l, rng), l) for l in lines]
