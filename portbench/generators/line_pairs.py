"""Generator of training batches: (noisy OCR line, clean line) pairs.

Reads a traffic mix (``portbench/traffic/<mix>.json``, ``"generator":
"line_pairs"``) and draws, from the seed, batches of ``batch_size``
pairs as a training corpus of OCR-D line pairs feeds them:

- each batch comes from documents of one column width: its lines are at
  most ``line_chars[k]`` characters, the classes k drawn stratified
  (every seed gets the same classes in another order);
- a line holds ``words`` [lo, hi] corpus words, the last dropped while
  it is longer than its class allows (at least one word stays);
- the source is the line through the corpus's OCR noise model
  (``noise_rate``, ``drop_rate``), the target the clean line; both end
  in a newline, as the API's line readers give them.
"""

import numpy as np

from .. import synth


def batches(mix, seed, n_batches):
    """`n_batches` lists of ``batch_size`` (source, target) pairs."""
    rng = np.random.default_rng(seed)
    classes = mix['line_chars']
    order = [classes[k] for k in
             synth.stratified(rng, 0, len(classes) - 1, n_batches)]
    lo, hi = mix['words']
    out = []
    for limit in order:
        pairs = []
        for _ in range(mix['batch_size']):
            words = [synth.word(rng)
                     for _ in range(int(rng.integers(lo, hi + 1)))]
            while len(words) > 1 and len(' '.join(words)) > limit:
                words.pop()
            clean = ' '.join(words)
            noisy = synth.corrupt(clean, rng, mix['noise_rate'],
                                  mix['drop_rate'])
            pairs.append((noisy + '\n', clean + '\n'))
        out.append(pairs)
    return out
