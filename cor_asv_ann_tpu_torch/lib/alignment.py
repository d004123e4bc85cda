"""Sequence alignment, error-rate metrics and streaming aggregation (host).

A copy of the JAX package's ``lib/alignment.py`` (standard library only),
kept here so the port imports nothing of that package; the edit distance
goes through the same backends (rapidfuzz, else the port's own copy of
the native editops library, else pure Python). Re-derivation of the
reference alignment/metrics layer
(lib/alignment.py:140-486): a difflib-based pair aligner with explicit gap
elements and grapheme-cluster recombination, the adjusted-distance metric
family (NFC/NFKC/Levenshtein/historic_latin with GT levels), confusion
tables, and the numerically stable streaming `Edits` aggregator
(Chan et al. 1979 parallel mean/variance merging).

The historic-Latin equivalence data (umlaut forms, long s, quote/dash
families; ligature and PUA replacements) reproduces the factual
orthographic equivalences the reference metrics are defined over
(alignment.py:8-119) — these are data tables, required for metric parity.

Word segmentation follows UAX-29 intent (dinglehopper-style: drop tokens
that contain only punctuation/whitespace/symbols); implemented with a
small fallback segmenter when `uniseg` is unavailable.
"""

import heapq
import logging
import unicodedata
from difflib import SequenceMatcher
from typing import NamedTuple, Tuple

# Level-1 historic Latin equivalence classes: sets of codepoint variants
# counted as distance 0 at GT level 1 (reference alignment.py:8-45).
L1_HISTLAT_EQV = [
    {"\u00e4", "a\u0308", "a\u0364"},   # a umlaut: precomposed, decomposed, combining e
    {"\u00f6", "o\u0308", "o\u0364"},   # o umlaut
    {"\u00fc", "u\u0308", "u\u0364"},   # u umlaut
    {"\u00c4", "A\u0308", "A\u0364"},   # A umlaut
    {"\u00d6", "O\u0308", "O\u0364"},   # O umlaut
    {"\u00dc", "U\u0308", "U\u0364"},   # U umlaut
    {"s", "\u017f"},                      # long s
    {"r", "\ua75b"},                      # r rotunda
    {"z", "\u0292"},                      # ezh/yogh
    {"Z", "\u01b7"},
    {"n", "\u019e"},                      # n with long right leg
    {"\u03bc", "\u00b5"},                # Greek vs micro mu
    {"\u03c0", "\U0001d6d1", "\U0001d70b", "\U0001d745",
     "\U0001d77f", "\U0001d7b9"},        # Greek vs math pi
    {"0", "\u2070"}, {"1", "\u00b9"}, {"2", "\u00b2"}, {"3", "\u00b3"},
    {"4", "\u2074"}, {"5", "\u2075"}, {"6", "\u2076"}, {"7", "\u2077"},
    {"8", "\u2078"}, {"9", "\u2079", "\ua770"},
    {"\u201e", "\u00bb", "\u203a", "\u301f"},   # opening double quotes
    {"\u201c", "\u00ab", "\u2039", "\u301e"},   # closing double quotes
    {"'", "\u02b9", "\u02bc", "\u2032", "\u2018", "\u2019",
     "\u201b", "\u1fbd", "`"},                    # single quotes
    {",", "\u201a"},
    {"-", "\u2212", "\u2014", "\u2010", "\u2011", "\u2012",
     "\u2013", "\u2043", "\ufe58", "\u2015", "\u2500", "\u2e17"},
    {"\u201f", "\u3003", "\u201d", "\u2033"},   # ditto signs
    {"~", "\u223c", "\u02dc", "\u1fc0", "\u2053"},
    {"(", "\u27e8", "\u207d"}, {")", "\u27e9", "\u207e"},
    {"/", "\u29f8", "\u2044", "\u2215"},
    {"\\", "\u29f9", "\u2216", "\u29f5"},
]

# Level-2 replacements applied below GT level 3: ligatures, abbreviation
# glyphs and font-private (PUA) codepoints mapped to accepted spellings
# (reference alignment.py:47-119; where the reference dict repeats a key,
# the effective last value is kept).
L2_HISTLAT_EQV = {
    '\uf502': 'ch', '\ueec4': 'ck',
    '\ufb05': '\u017ft',                 # st ligature -> long-s t
    '\ufb01': 'fi', '\ufb00': 'ff', '\ufb02': 'fl', '\ufb03': 'ffi',
    '\uf4fc': '\u017fk',
    '\ueedc': 't\u0292',                 # tz ligature -> t ezh
    '\uf532': 'as', '\uf533': 'is', '\uf534': 'us', '\uf535': 'Qu',
    '\u0133': 'ij',
    '\ue8bf': 'q\u0292',                 # q + final et -> q ezh
    '\ueba5': '\u017fp',
    '\ufb06': 'st',
    'q\u0308': 'q\u1dd3',                # quam abbreviation
    'c\u0308': 'c\u1dd3',                # cetera abbreviation
    '\u1e21': 'g\u1dd3',
    'v\u0309': 'v\u1de3', 'v\u1dce': 'v\u1de3',
    'b\u1dce': 'b\u1de3', 'p\u1dce': 'p\u1de3',
    'd\u0309': '\u00f0',                 # d + hook -> eth
    '\ua75f': 'v\u1de3',
    't\u1de3': 't\u1dd1',                # -tur abbreviation
    '\ueada': '\u017ft', '\ueba2': '\u017fi', '\ueba3': '\u017fl',
    '\ueba6': '\u017f\u017f', '\ueba7': '\u017f\u017fi',
    '\uf4ff': '\u017f\u017ft', '\uf52c': '\u017fp',
    '\ueec5': 'ct', '\ueecb': 'ft',
    '\ue5d2': 'm\u0303', '\ue5dc': '\u00f1', '\ue665': 'p\u0303',
    '\ue42c': 'a\u0364', '\ue644': 'o\u0364', '\ue72b': 'u\u0364',
    '\ue72d': '\u016f',
    '\uebac': '\u00df',
    '\ue8b7': '\u017f\u1de3',           # long s + r rotunda
    '\uf1a6': '\ua770', '\uf223': 'm', '\uf158': '\u204a',
    '\uf159': '\u00f0', '\uf160': ':',
    'q\uf02f': 'q\u0365', 't\uf1cc': 't\u1dd1',
    '\uf4f9': 'll',
    # precomposed macron keys exactly as the reference has them (NFC
    # input produces these forms; decomposed keys would never match)
    '\u0101': 'a\u0303', '\u0113': '\u1ebd', '\u012b': '\u0129',
    '\u014d': '\u00f5', '\u016b': '\u0169', 'c\u0304': 'c\u0303',
    'q\u0304': 'q\u0303', 'r\u0304': 'r\u0303',
    '\uf50e': 'q\u0301',
}


_HISTLAT_L2_CACHE = None


def _histlat_l2_tables():
    """(str.maketrans table for single-char keys, tuple of multi-char
    (key, value) pairs) over L2_HISTLAT_EQV, built once."""
    global _HISTLAT_L2_CACHE
    if _HISTLAT_L2_CACHE is None:
        single = {k: v for k, v in L2_HISTLAT_EQV.items() if len(k) == 1}
        multi = tuple((k, v) for k, v in L2_HISTLAT_EQV.items()
                      if len(k) > 1)
        _HISTLAT_L2_CACHE = (str.maketrans(single), multi)
    return _HISTLAT_L2_CACHE


class Confusion(NamedTuple):
    """One ranked confusion-table entry: how often `pair` was confused.

    Plain value type; ranking lives in ``Alignment.get_confusion``.  As a
    tuple subclass it renders as ``(count, pair)`` inside report JSON —
    the serialization format the reference's evaluation reports use
    (reference evaluate.py:289-294), kept for report compatibility.
    """
    count: int
    pair: Tuple

    def __repr__(self):
        return repr((self.count, self.pair))


class Alignment:
    """Pairwise sequence aligner with explicit gap element.

    Wraps difflib.SequenceMatcher (Ratcliff-Obershelp; autojunk off) like
    the reference (alignment.py:146-148); works on strings or token lists.
    """

    def __init__(self, gap_element=0, logger=None, confusion=False):
        self.confusion = dict() if confusion else None
        self.gap_element = gap_element
        self.logger = logger or logging.getLogger(__name__)
        self.matcher = SequenceMatcher(isjunk=None, autojunk=False)
        self.source_text = []
        self.target_text = []

    def set_seqs(self, source_text, target_text):
        self.matcher.set_seqs(source_text, target_text)
        self.source_text = source_text
        self.target_text = target_text

    def is_bad(self):
        """Training-data filter (reference alignment.py:160-163)."""
        return bool(self.matcher.quick_ratio() < 0.5
                    and len(self.source_text) > 5)

    def get_best_alignment(self, eq=None):
        """Convert matcher opcodes into a per-symbol pair alignment.

        'replace' spans of unequal length are decomposed into substitution
        plus deletion/insertion tails; afterwards combining codepoints are
        re-attached to the preceding base letter (grapheme recombination,
        reference alignment.py:206-242). Pairs are also accumulated into
        the confusion dict (gap-adjacent pairs merged into multi-char
        entries), skipping pairs `eq` deems equivalent.
        """
        gap = self.gap_element
        src, tgt = self.source_text, self.target_text
        pairs = []
        for op, sb, se, tb, te in self.matcher.get_opcodes():
            if op == 'equal':
                pairs.extend(zip(src[sb:se], tgt[tb:te]))
            elif op == 'replace':
                delta = (se - sb) - (te - tb)
                if delta > 0:  # substitution + deletion tail
                    pairs.extend(zip(src[sb:se - delta], tgt[tb:te]))
                    pairs.extend((s, gap) for s in src[se - delta:se])
                else:          # substitution + insertion tail
                    pairs.extend(zip(src[sb:se], tgt[tb:te + delta]))
                    pairs.extend((gap, t) for t in tgt[te + delta:te])
            elif op == 'insert':
                pairs.extend((gap, t) for t in tgt[tb:te])
            elif op == 'delete':
                pairs.extend((s, gap) for s in src[sb:se])
            else:
                raise ValueError('unexpected opcode %r' % op)

        if not isinstance(src, list):
            pairs = self._recombine_graphemes(pairs)

        if self.confusion is not None:
            self._count_confusion(pairs, eq)
        return pairs

    def _recombine_graphemes(self, pairs):
        """Attach combining codepoints to the preceding base letter on
        either side (never combining with a gap or non-letter)."""
        gap = self.gap_element

        def extendable(prev_sym):
            return (prev_sym != gap
                    and unicodedata.category(prev_sym[0])[0] == 'L')

        out = []
        changed = False
        for s, t in pairs:
            if (s != gap and unicodedata.combining(s) and out
                    and extendable(out[-1][0])):
                out[-1][0] += s
                changed = True
                if t == gap:
                    continue
                if (unicodedata.combining(t) and extendable(out[-1][1])):
                    out[-1][1] += t
                    continue
                s = gap
            elif (t != gap and unicodedata.combining(t) and out
                    and extendable(out[-1][1])):
                out[-1][1] += t
                changed = True
                if s == gap:
                    continue
                t = gap
            out.append([s, t])
        if changed:
            return [tuple(p) for p in out]
        return pairs

    def _count_confusion(self, pairs, eq):
        gap = self.gap_element
        for pos, pair in enumerate(pairs):
            if gap in pair:
                # merged into the following non-gap pair below; a
                # TRAILING gap run has no such pair and is dropped —
                # reference-faithful (its rationale "we always end with
                # newline" holds for evaluate's line texts; compare.py
                # strips newlines, where end-of-line edits then escape
                # the confusion table there exactly as in the reference)
                continue
            while pos and gap in pairs[pos - 1]:
                pos -= 1
                prev = pairs[pos]
                pair = tuple((a or '') + (b or '')
                             for a, b in zip(prev, pair))
            if eq and eq(*pair):
                continue
            self.confusion[pair] = self.confusion.get(pair, 0) + 1

    def get_confusion(self, limit=None):
        """Top-`limit` non-identity confusion pairs + total pair count.

        Entries are ranked most-frequent-first; among equal counts the
        pair whose first occurrence was seen latest ranks first (the
        counting dict preserves first-occurrence order, so recency is
        just the reversed iteration order).
        """
        if self.confusion is None:
            raise RuntimeError('aligner was not configured to count confusion')
        total = sum(self.confusion.values())
        freshest_first = [Confusion(count, pair)
                          for pair, count in reversed(self.confusion.items())
                          if pair[0] != pair[1]]
        # stable sort over the recency-ordered list: count decides,
        # recency breaks ties
        freshest_first.sort(key=lambda entry: entry.count, reverse=True)
        if limit:
            del freshest_first[limit:]
        return freshest_first, total

    @staticmethod
    def get_levenshtein_distance(source_text, target_text):
        """Raw codepoint edit distance over the max sequence length
        ("Levenshtein-fast", reference alignment.py:281-290).

        Backends in preference order: rapidfuzz (C++), the first-party
        native editops library (C++), pure Python."""
        try:
            from rapidfuzz.distance import Levenshtein
            dist = Levenshtein.distance(source_text, target_text)
        except ImportError:  # pragma: no cover
            from . import native
            if (native.available() and isinstance(source_text, str)
                    and isinstance(target_text, str)):
                dist = native.lev_distance(source_text, target_text)
            else:
                dist = _levenshtein(source_text, target_text)
        return dist, max(len(target_text), len(source_text))

    def get_adjusted_distance(self, source_text, target_text,
                              normalization=None, gtlevel=1,
                              return_alignment=False):
        """Metric family over the alignment path (alignment.py:292-356).

        normalization in {None, 'NFC', 'NFKC', 'historic_latin'}; under
        historic_latin, L2 replacements apply below GT level 3 and the L1
        equivalence classes count as distance 0 at GT level 1. Works on
        strings (CER) and word lists (WER). The denominator is the
        alignment path length.
        """
        # the L2 translate table and multi-char list depend only on
        # gtlevel; build once per call, not once per word (WER with
        # historic_latin normalizes every word of every line)
        if normalization == 'historic_latin' and gtlevel < 3:
            l2_table, l2_multi = _histlat_l2_tables()
        else:
            l2_table, l2_multi = {}, ()

        def normalize(seq):
            if isinstance(seq, list):
                return [normalize(s) for s in seq]
            if normalization in ('NFC', 'NFKC'):
                return unicodedata.normalize(normalization, seq)
            if normalization == 'historic_latin':
                for key, val in l2_multi:
                    seq = seq.replace(key, val)
                return seq.translate(l2_table)
            return seq

        if normalization == 'historic_latin' and gtlevel == 1:
            equivalences = L1_HISTLAT_EQV
        else:
            equivalences = []

        def equivalent(x, y):
            if isinstance(x, list):
                return len(x) == len(y) and all(
                    equivalent(a, b) for a, b in zip(x, y))
            if x == y:
                return True
            return any(x in eqv and y in eqv for eqv in equivalences)

        self.set_seqs(normalize(source_text), normalize(target_text))
        alignment = self.get_best_alignment(eq=equivalent)
        dist = float(sum(
            1 for s, t in alignment if s != t and not equivalent(s, t)))
        length = len(alignment)
        if return_alignment:
            return dist, length, alignment
        return dist, length

    @staticmethod
    def best_alignment(source_text, target_text, with_confusion=False):
        aligner = Alignment(confusion=with_confusion)
        aligner.set_seqs(source_text, target_text)
        if with_confusion:
            return aligner.get_best_alignment(), aligner.get_confusion()
        return aligner.get_best_alignment()


def _levenshtein(a, b):  # pragma: no cover - fallback when rapidfuzz absent
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class WorstLine:
    """One entry on the worst-lines leaderboard kept by `Edits`."""

    __slots__ = ('name', 'rate', 'length')

    def __init__(self, name, rate, length):
        self.name = name or ''
        self.rate = rate
        self.length = length

    @property
    def errors(self):
        """Absolute error mass of the line (the leaderboard key)."""
        return self.rate * self.length

    def __str__(self):
        label = self.name + ': ' if self.name else ''
        return '%srate %.3f over %d tokens' % (label, self.rate, self.length)

    __repr__ = __str__


class Edits:
    """Streaming per-line error-rate statistics over a corpus.

    Design: raw weighted moments are accumulated (`length` = total token
    weight, error mass = Σ rateᵢ·lenᵢ, and the weighted sum of squared
    deviations); `mean` and `varia` are derived read-only views, and two
    aggregators combine via the standard parallel-moments identity — so
    sequential adds and `merge()` of partial aggregators yield identical
    statistics (pinned by tests/test_alignment.py). Also keeps optional
    per-token histograms and a bounded worst-lines leaderboard (min-heap
    keyed by absolute error mass, sized to ~1% of lines seen, at least
    10). Exposes the same observable statistics as the reference's
    aggregator (reference alignment.py:366-459) with a different
    internal architecture.
    """

    def __init__(self, logger=None, histogram=False):
        self.logger = logger or logging.getLogger(__name__)
        self.steps = 0        # number of (non-empty) lines seen
        self.length = 0       # total token weight
        self.score = 0.0      # free accumulator (−log p sums in evaluate)
        self._errmass = 0.0   # Σ rateᵢ · lenᵢ
        self._sqdev = 0.0     # Σ lenᵢ · (rateᵢ − mean)²  (weighted M2)
        self._histogram = bool(histogram)
        self.hist1 = {}
        self.hist2 = {}
        self._heap = []       # min-heap of (error mass, tie seq, WorstLine)
        self._tie = 0

    @property
    def mean(self):
        return self._errmass / self.length if self.length else 0.0

    @property
    def varia(self):
        return self._sqdev / self.length if self.length else 0.0

    @property
    def worst(self):
        """Leaderboard entries, worst (highest error mass) first."""
        return [entry for _, _, entry in
                sorted(self._heap, key=lambda item: (-item[0], item[1]))]

    def __repr__(self):
        return '<Edits lines=%d tokens=%d rate=%.4f var=%.4f>' % (
            self.steps, self.length, self.mean, self.varia)

    def hist(self):
        keys = set(self.hist1) | set(self.hist2)
        return {key: (self.hist1.get(key, 0), self.hist2.get(key, 0))
                for key in sorted(keys)}

    def _absorb(self, steps, weight, errmass, sqdev):
        """Fold another population's raw moments into this one."""
        if weight <= 0:
            return
        if self.length:
            delta = errmass / weight - self._errmass / self.length
            self._sqdev += sqdev + (delta * delta * weight * self.length
                                    / (weight + self.length))
        else:
            self._sqdev = sqdev
        self._errmass += errmass
        self.length += weight
        self.steps += steps

    def _note_worst(self, entry):
        cap = max(10, self.steps // 100)
        self._tie += 1
        heapq.heappush(self._heap, (entry.errors, self._tie, entry))
        while len(self._heap) > cap:
            heapq.heappop(self._heap)

    def _count_tokens(self, seq1, seq2):
        for tok in seq1:
            self.hist1[tok] = self.hist1.get(tok, 0) + 1
        for tok in seq2:
            self.hist2[tok] = self.hist2.get(tok, 0) + 1

    def add(self, dist, length, seq1, seq2, name=None):
        """Record one line: `dist` edit operations over `length` tokens."""
        rate = dist / length if length else 0.0
        if self._histogram:
            self._count_tokens(seq1, seq2)
        self._absorb(1, length, rate * length, 0.0)
        self._note_worst(WorstLine(name, rate, length))

    def merge(self, edits, name_prefix=None):
        """Fold a partial aggregator into this one (stats, histograms,
        and leaderboard); optionally prefix the absorbed line names."""
        self._absorb(edits.steps, edits.length,
                     edits._errmass, edits._sqdev)
        for ours, theirs in ((self.hist1, edits.hist1),
                             (self.hist2, edits.hist2)):
            for tok, count in theirs.items():
                ours[tok] = ours.get(tok, 0) + count
        for entry in edits.worst:
            if name_prefix:
                entry.name = name_prefix + entry.name
            self._note_worst(entry)


def _unwanted(c):
    cat = unicodedata.category(c)
    return cat[0] in 'OMPZS' or cat in ('Cc', 'Cf')


def _words(text):
    """UAX-29-style word segmentation; uses uniseg when available, else a
    small fallback that splits on category transitions. Tokens consisting
    only of punctuation/whitespace/symbols are dropped (dinglehopper
    convention, reference alignment.py:461-486)."""
    try:
        import uniseg.wordbreak
        tokens = uniseg.wordbreak.words(text)
    except ImportError:
        tokens = _simple_words(text)
    for word in tokens:
        if not all(_unwanted(c) for c in word):
            yield word


# UAX-29 medial classes (the subset relevant to OCR text): a single
# such char between two same-kind word chars does not break the word
# (WB6/WB7 for letters, WB11/WB12 for numerics, MidNumLet for both)
_MIDLETTER = {':', '·', '״', '˗', '﹕', '：'}
_MIDNUMLET = {'.', "'", '’', '․', '﹒', '＇', '．'}
_MIDNUM = {',', ';', '٬', '﹐', '﹔', '，', '；'}


def _simple_words(text):
    """Fallback segmentation when `uniseg` is unavailable: maximal runs
    of letters/digits/marks, keeping UAX-29 medial punctuation inside —
    apostrophes/colons between letters ("don't", Swedish "a:b"),
    periods between letters or digits ("3.14", "e.g"), commas between
    digits ("1,000")."""
    def kind(c):
        cat = unicodedata.category(c)
        if cat[0] == 'L' or cat[0] == 'M':
            return 'L'
        if cat[0] == 'N':
            return 'N'
        return None

    out = []
    cur = ''
    for i, c in enumerate(text):
        k = kind(c)
        if k:
            cur += c
            continue
        prev = kind(cur[-1]) if cur else None
        nxt = kind(text[i + 1]) if i + 1 < len(text) else None
        joins = (prev and prev == nxt
                 and ((c in _MIDLETTER and prev == 'L')
                      or (c in _MIDNUM and prev == 'N')
                      or c in _MIDNUMLET))
        if joins:
            cur += c
        else:
            if cur:
                out.append(cur)
                cur = ''
            out.append(c)
    if cur:
        out.append(cur)
    return out


def splitwords(text):
    return list(_words(text))
