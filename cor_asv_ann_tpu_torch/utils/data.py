"""Charset mapping, line readers and vectorization (host-side data core).

A copy of the JAX package's ``utils/data.py``
(numpy only), kept here so the port imports nothing of that package.
Re-derivation of the reference data pipeline (lib/seq2seq.py:555-588
map_files, :919-1018 gen_lines, :1020-1119 vectorize_lines), with padded
lengths *bucketed* to a small set of shapes.

Semantics preserved:
- char<->index mapping with index 0 reserved for the unknown/underspecified
  character '' and newline acting as end-of-sequence,
- the GAP character '\\a' is reserved and never mapped,
- true-zero timestep = encoder padding and decoder start symbol,
- decoder teacher forcing offset by one step, sample weights zero on padding,
- three pickle source formats: plain string, per-char (char, prob) tuples and
  full confusion networks ("confmat": list of chunks, each a list of
  (string, prob) alternatives),
- train/validation split by a shared random vector with ratio 0.2,
- NFC normalization and optional charmap translation before mapping.
"""

import pickle
import unicodedata

import numpy as np

GAP = '\a'

# Static length buckets (encoder timesteps). OCR lines are tens to a few
# hundred characters; bucketing bounds the set of decode shapes.
LENGTH_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def bucket_length(n, buckets=LENGTH_BUCKETS):
    """Smallest bucket >= n (or round up to a multiple of the largest)."""
    for b in buckets:
        if n <= b:
            return b
    # beyond the largest bucket: round up to a multiple of it
    top = buckets[-1]
    return ((n + top - 1) // top) * top


class CharMapping:
    """Bidirectional character<->index mapping with index 0 = unknown ''."""

    def __init__(self, chars=()):
        # index 0 is always the empty (underspecified) character
        chars = sorted(set(chars) - {'', GAP})
        self.c2i = {'': 0}
        self.i2c = {0: ''}
        for c in chars:
            i = len(self.c2i)
            self.c2i[c] = i
            self.i2c[i] = c

    @property
    def voc_size(self):
        return len(self.c2i)

    def __len__(self):
        return len(self.c2i)

    def __contains__(self, char):
        return char in self.c2i

    def get(self, char, default=0):
        return self.c2i.get(char, default)

    def to_codepoints(self):
        """uint32 codepoint array for the HDF5 ``config/mapping`` dataset
        (reference lib/seq2seq.py:1138-1141: 0 stands for the '' entry)."""
        return np.fromiter(
            (ord(self.i2c[i]) if self.i2c.get(i) else 0
             for i in range(self.voc_size)),
            dtype=np.uint32)

    @classmethod
    def from_codepoints(cls, codes):
        m = cls()
        for i, c in enumerate(np.asarray(codes).tolist()):
            if i == 0 and not c:
                continue
            ch = chr(c) if c > 0 else ''
            if ch == '':
                continue
            m.c2i[ch] = i
            m.i2c[i] = ch
        return m

    @classmethod
    def from_texts(cls, texts):
        chars = set()
        for t in texts:
            chars.update(t)
        return cls(chars)

    def lut(self):
        """Codepoint -> index lookup table (unmapped -> 0), cached.

        Enables vectorized encoding: utf-32 decode + one array gather
        instead of a Python loop per character."""
        if getattr(self, '_lut', None) is None or \
                self._lut_size != self.voc_size:
            max_code = max((ord(c) for c in self.c2i if c), default=0)
            lut = np.zeros(max_code + 2, np.int32)
            for c, i in self.c2i.items():
                if c:
                    lut[ord(c)] = i
            self._lut = lut
            self._lut_size = self.voc_size
        return self._lut

    def inverse_lut(self):
        """Index -> codepoint lookup table ('' entry -> 0), cached with
        the same invalidation rule as :meth:`lut` (one rule, both
        directions). Enables vectorized decoding: one gather + utf-32
        encode instead of a dict lookup per character."""
        if getattr(self, '_inv_lut', None) is None or \
                self._inv_lut_size != self.voc_size:
            self._inv_lut = self.to_codepoints().astype('<u4')
            self._inv_lut_size = self.voc_size
        return self._inv_lut

    def encode(self, text):
        """Vectorized char->index array for `text` (unmapped -> 0)."""
        if not text:
            return np.zeros(0, np.int32)
        codes = np.frombuffer(text.encode('utf-32-le'), dtype=np.uint32)
        lut = self.lut()
        return lut[np.minimum(codes, len(lut) - 1)]

    def grow(self, texts):
        """Return a new mapping including all chars of `texts` (sorted afresh,
        like the reference's incremental map_files) and whether it grew."""
        chars = set(self.c2i) - {''}
        before = len(chars)
        for t in texts:
            chars.update(t)
        chars.discard(GAP)
        chars.discard('')
        if len(chars) == before:
            return self, False
        return CharMapping(chars), True


def _parse_pickled_entry(entry):
    """One pickle entry -> (src_text, src_conf, tgt_text).

    Three source layouts exist (reference lib/seq2seq.py:949-958 and
    scripts/train.py:43-48): a plain string, a per-char (char, prob)
    list, or a confusion network (list of chunks of (string, prob)
    alternatives).  An entry whose text does not end in a newline is
    replaced by a bare end-of-sequence, like the reference does
    (seq2seq.py:961-965) — but in the entry's OWN format (the reference
    always substitutes a confmat, which poisons the batch's format
    detection and crashes its vectorization on prob-line sources; same
    for plain strings, which it misreads as confmats)."""
    src, tgt = entry
    if isinstance(src, str):
        # plain-string source: text only, no confidence channel
        text, conf = src, None
    elif not src:
        text, conf = '', []
    elif isinstance(src[0], tuple):
        chars, probs = zip(*src)
        text, conf = ''.join(chars), list(probs)
    else:
        conf = src
        text = ''.join(chunk[0][0] if chunk else '' for chunk in conf)
    if not text.endswith('\n'):
        text = '\n'
        if conf is not None:
            conf = [[('\n', 1.0)]] if conf and isinstance(conf[0], list) \
                else [1.0]
    return text, conf, tgt


def _parse_text_row(raw, unsupervised):
    """One text/TSV row -> (src_text, None, tgt_text); the source side
    gains the end-of-sequence newline the tab stripped."""
    if unsupervised and '\t' not in raw:
        return raw, None, raw
    # maxsplit keeps a stray tab inside the target from killing the run
    # (the reference's bare split() raises ValueError on such rows)
    src, tgt = raw.split('\t', 1)
    return src + '\n', None, tgt


def _iter_file_lines(filename, unsupervised=False, charmap=None):
    """Yield NFC-normalized (source_text, source_conf_or_None,
    target_text) per line of a .pkl (prob lines / confmats) or
    plain-text/TSV file (reference gen_lines, lib/seq2seq.py:936-979).
    """
    handle = None
    if filename.endswith('.pkl'):
        with open(filename, 'rb') as f:
            rows = [_parse_pickled_entry(e) for e in pickle.load(f)]
    else:
        handle = open(filename, 'r', encoding='utf-8')
        rows = (_parse_text_row(raw, unsupervised) for raw in handle)
    try:
        for src, conf, tgt in rows:
            if unsupervised:
                tgt = src
            if charmap:
                src = src.translate(charmap)
                tgt = tgt.translate(charmap)
            src = unicodedata.normalize('NFC', src)
            if conf and not isinstance(conf[0], list) \
                    and len(conf) != len(src):
                # NFC composition changed the char count after the
                # per-char confidences were extracted: keep them aligned
                # by truncating/padding (the reference silently ignores
                # surplus conf entries; a shortfall crashes it)
                conf = (list(conf) + [1.0] * len(src))[:len(src)]
            yield (src, conf, unicodedata.normalize('NFC', tgt))
    finally:
        if handle:
            handle.close()


def scan_files(filenames, charmap=None):
    """Collect the character inventory and line count over all files
    (reference map_files, lib/seq2seq.py:555-588). For confmat sources,
    every alternative of every chunk contributes characters (the decoded
    top line alone would miss alternatives-only characters)."""
    chars = set()
    num_lines = 0
    if charmap:
        charmap = str.maketrans(charmap)
    for filename in filenames:
        for src, conf, tgt in _iter_file_lines(filename, charmap=charmap):
            chars.update(src)
            chars.update(tgt)
            if conf and isinstance(conf[0], list):  # confmat
                for chunk in conf:
                    for alt, _prob in chunk:
                        chars.update(alt)
            num_lines += 1
    chars.discard(GAP)
    return chars, num_lines


def gen_line_batches(filenames, batch_size, repeat=False, split=None,
                     train=False, unsupervised=False, charmap=None,
                     is_bad=None):
    """Generate (sources, confs_or_None, targets, filenames) batches.

    `split` is a shared random vector over line numbers; lines whose value
    is below 0.2 belong to validation (train=False keeps them, train=True
    skips them) — reference lib/seq2seq.py:944-948. Reference-faithful
    quirk: the line number restarts per FILE (both here and in the
    reference), so with multiple files the same split entries are reused
    per file (line k of every file shares one fate) and entries beyond
    the longest file are never consulted; the i.i.d. uniform draw keeps
    the validation fraction at ~0.2 regardless.
    `is_bad(source, target) -> bool` filters badly aligned training pairs.
    When `repeat`, yields None at each epoch end (epoch marker) and the
    trailing partial batch is dropped — the reference's deliberate "bury
    remaining lines" (seq2seq.py:1005-1007); otherwise the final partial
    batch is padded with empty lines, like the reference.
    """
    split_ratio = 0.2
    if charmap:
        charmap = str.maketrans(charmap)
    epoch = 0
    while True:
        srcs, confs, tgts, names = [], [], [], []
        any_conf = False
        for filename in filenames:
            for line_no, (src, conf, tgt) in enumerate(
                    _iter_file_lines(filename, unsupervised, charmap)):
                if (isinstance(split, np.ndarray)
                        and (split[line_no] < split_ratio) == train):
                    continue
                if train and is_bad is not None and is_bad(src, tgt):
                    continue
                srcs.append(src)
                tgts.append(tgt)
                confs.append(conf)
                any_conf = any_conf or conf is not None
                names.append(filename)
                if len(srcs) == batch_size:
                    yield (srcs, confs if any_conf else None, tgts, names)
                    srcs, confs, tgts, names = [], [], [], []
                    any_conf = False
        epoch += 1
        if repeat:
            yield None  # epoch marker (autosized training loop protocol)
        else:
            if srcs:
                pad = batch_size - len(srcs)
                srcs.extend([''] * pad)
                tgts.extend([''] * pad)
                confs.extend([[] if any_conf else None] * pad)
                names.extend([None] * pad)
                yield (srcs, confs if any_conf else None, tgts, names)
            return


def vectorize_lines(mapping, sources, targets, confs=None,
                    pad_encoder=None, pad_decoder=None, bucketed=True,
                    logger=None):
    """Convert line batches into dense (B, T, V) arrays.

    Faithful to reference vectorize_lines (lib/seq2seq.py:1020-1119):
    - encoder input: one-hot (or probability) vectors, zero rows = padding,
    - unmapped characters (except GAP) map to index 0 (underspecification),
    - decoder input: shifted right by one (position 0 = zero start symbol),
    - decoder output: teacher forcing target, newline = end-of-sequence,
    - sample weights zero where the decoder output row is all-zero (padding),
    - confmat sources place alternatives of each chunk at shared timesteps
      with their probabilities.

    Deviation from the reference: `bucketed` pads T to a static bucket length (see
    LENGTH_BUCKETS) instead of exactly the batch max; pass explicit
    `pad_encoder`/`pad_decoder` to pin lengths (e.g. for parity testing).
    """
    voc_size = mapping.voc_size
    batch = len(sources)
    with_confmat = False
    enc_lens = [len(s) for s in sources]
    if confs is not None and any(c for c in confs):
        first = next(c for c in confs if c)
        if first and isinstance(first[0], list):
            with_confmat = True
            # the format is detected batch-wide from the first line with
            # conf; coerce per-char prob lines (and conf-less text
            # lines, prob 1.0) in the batch into the equivalent
            # single-alternative chunks over their source text
            def _chunks(c, s):
                if c and isinstance(c[0], list):
                    return c
                if c:
                    return [[(ch, p)] for ch, p in zip(s, c)]
                return [[(ch, 1.0)] for ch in s]
            confs = [_chunks(c, s) for c, s in zip(confs, sources)]
            enc_lens = [
                sum(max((len(alt[0]) for alt in chunk), default=0)
                    for chunk in (c or []))
                for c in confs]
    max_enc = max(max(enc_lens), 1) if enc_lens else 1
    max_dec = max(max((len(t) for t in targets), default=1), 1)
    if pad_encoder is None:
        pad_encoder = bucket_length(max_enc) if bucketed else max_enc
    if pad_decoder is None:
        pad_decoder = (bucket_length(max_dec + 1) if bucketed
                       else max_dec + 1)
    assert pad_encoder >= max_enc and pad_decoder >= max_dec + 1

    enc = np.zeros((batch, pad_encoder, voc_size), dtype=np.float32)
    dec_in = np.zeros((batch, pad_decoder, voc_size), dtype=np.float32)
    dec_out = np.zeros((batch, pad_decoder, voc_size), dtype=np.float32)

    def _idx(char, where):
        if char not in mapping.c2i:
            if char != GAP and logger is not None:
                logger.error('unmapped character "%s" at %s', char, where)
            return 0
        return mapping.c2i[char]

    for i in range(batch):
        if with_confmat:
            j = 0
            for chunk in (confs[i] or []):
                max_chars = max((len(alt[0]) for alt in chunk), default=0)
                for chars, conf in chunk:
                    for k, char in enumerate(chars):
                        enc[i, j + k, _idx(char, f'encoder line {i}')] = conf
                j += max_chars
        else:
            idx = mapping.encode(sources[i])
            if logger is not None and (idx == 0).any():
                for k in np.nonzero(idx == 0)[0]:
                    if sources[i][k] != GAP:
                        logger.error('unmapped character "%s" at encoder '
                                     'input sequence %d', sources[i][k], i)
            pos = np.arange(len(idx))
            ci = confs[i] if confs is not None else None
            if ci and isinstance(ci[0], list):
                # confmat line in a per-char prob batch: per-char probs
                # of the top alternatives (the source text is exactly
                # their concatenation, _parse_pickled_entry)
                ci = [p for chunk in ci if chunk
                      for p in [chunk[0][1]] * len(chunk[0][0])]
            if ci:
                enc[i, pos, idx] = np.asarray(ci, np.float32)
            else:
                enc[i, pos, idx] = 1.0
        idx = mapping.encode(targets[i])
        if logger is not None and (idx == 0).any():
            for k in np.nonzero(idx == 0)[0]:
                if targets[i][k] != GAP:
                    logger.error('unmapped character "%s" at decoder '
                                 'input sequence %d', targets[i][k], i)
        pos = np.arange(len(idx))
        dec_in[i, pos + 1, idx] = 1.0
        dec_out[i, pos, idx] = 1.0

    weights = np.ones(dec_out.shape[:2], dtype=np.float32)
    weights[np.all(dec_out == 0, axis=2)] = 0.0
    return enc, dec_in, dec_out, weights


def vectorize_lines_indices(mapping, sources, targets, bucketed=True,
                            logger=None):
    """Compact index form of `vectorize_lines` for inputs without
    per-character confidences: (enc_idx (B,Te), dec_in_idx (B,Td),
    dec_out_idx (B,Td), weights (B,Td)) with -1 at padding (and at the
    decoder start symbol, which is the zero row in the dense form).

    One-hot expansion happens on device (seq2seq.py:ensure_onehot); the
    loss consumes index targets directly (train.py:weighted_xent). A
    batch ships V times less data to the device. Semantics identical to
    vectorize_lines.
    """
    enc_idx = lines_to_index_batch(mapping, sources, bucketed=bucketed,
                                   logger=logger)
    max_dec = max(max((len(t) for t in targets), default=1), 1)
    pad_dec = bucket_length(max_dec + 1) if bucketed else max_dec + 1
    B = len(targets)
    dec_in = np.full((B, pad_dec), -1, np.int32)
    dec_out = np.full((B, pad_dec), -1, np.int32)
    for i, t in enumerate(targets):
        idx = mapping.encode(t)
        if logger is not None and (idx == 0).any():
            for k in np.nonzero(idx == 0)[0]:
                if t[k] != GAP:
                    logger.error('unmapped character "%s" at decoder '
                                 'input sequence %d', t[k], i)
        dec_in[i, 1:1 + len(idx)] = idx
        dec_out[i, :len(idx)] = idx
    weights = (dec_out >= 0).astype(np.float32)
    return enc_idx, dec_in, dec_out, weights


def lines_to_index_batch(mapping, lines, pad_to=None, bucketed=True,
                         logger=None):
    """Encode plain-text lines as a (B, T) int32 index batch, -1 = padding.

    The compact host->device form of `vectorize_lines`' encoder input for
    inputs without per-character confidences: the (B, T, V) one-hot
    expansion happens on device (models/seq2seq.py:ensure_onehot), so a
    batch ships V times less data over the host link. Index semantics
    match vectorize_lines exactly: unmapped characters (except GAP) log
    an error and map to 0 (underspecification); -1 rows one-hot to zero
    vectors (padding, like the reference's zero rows, seq2seq.py:1026).
    """
    max_len = max(max((len(l) for l in lines), default=1), 1)
    if pad_to is None:
        pad_to = bucket_length(max_len) if bucketed else max_len
    assert pad_to >= max_len
    out = np.full((len(lines), pad_to), -1, np.int32)
    for i, line in enumerate(lines):
        idx = mapping.encode(line)
        if logger is not None and (idx == 0).any():
            for k in np.nonzero(idx == 0)[0]:
                if line[k] != GAP:
                    logger.error('unmapped character "%s" at encoder '
                                 'input sequence %d', line[k], i)
        out[i, :len(idx)] = idx
    return out
