"""Spellcheck marking processor (ocrd-cor-asv-ann-mark).

A copy of the JAX package's ``wrapper/mark.py`` (host code), kept here so
the port imports nothing of that package.

Re-derivation of reference MarkWords (wrapper/mark.py:21-137): run each
word's letter-normalized text through an external lookup command (e.g.
``hunspell -i utf-8 -w -L de_historical``, which echoes unknown words);
unknown words get marked via @comments (default) or conf=0.123. A word
ending in a hyphen retries joined with the following line's first word
(dehyphenation), undoing the previous mark when the joined form is known.
"""

import subprocess
import unicodedata

from .base import PageProcessor, processor_cli

HYPHENS = ('-', '⸗')


class SpellLookup:
    """Letter-normalization + external lookup command (e.g. hunspell
    ``-w -L``, which echoes every unknown word back)."""

    def __init__(self, command, normalization):
        self.command = command
        self.normalization = normalization

    def letters(self, token):
        """Apply the char normalization map, keep letters/marks only."""
        for old, new in self.normalization.items():
            token = token.replace(old, new)
        return ''.join(char for char in token
                       if unicodedata.category(char)[0] in 'LM')

    def unknown_batch(self, words):
        """(set of unknown words, returncode, stderr) for all `words` in
        ONE lookup invocation (hunspell ``-w -L`` style: unknown words
        are echoed back one per line). Spawning the command per word
        reloads its dictionary thousands of times per page."""
        words = [w for w in words if w]
        if not words:
            return set(), 0, ''
        proc = subprocess.run(self.command,
                              input='\n'.join(words) + '\n',
                              encoding='utf-8', shell=True,
                              capture_output=True, text=True)
        return set(proc.stdout.split()), proc.returncode, proc.stderr


class MarkWords(PageProcessor):
    """Mark words not recognized by a spellchecker command."""

    executable = 'ocrd-cor-asv-ann-mark'
    parameter_schema = {
        'command': {'type': 'string', 'required': True},
        'normalization': {'type': 'object', 'default': {}},
        'format': {'type': 'string', 'default': 'OOV'},
    }

    def setup(self):
        # initialized here (not only in start_document) so per-page use
        # without the workspace runner — e.g. through the OCR-D core
        # adapter, which drives document iteration itself — still works
        self.total_candidates = 0
        self.total_nonmatches = 0

    def start_document(self, workspace, input_grps, output_grp):
        self.total_candidates = 0
        self.total_nonmatches = 0

    def end_document(self, workspace, input_grps, output_grp):
        self.logger.info(
            'marked %d unmatched words out of %d tokens (%d%%) overall',
            self.total_nonmatches, self.total_candidates,
            100 * self.total_nonmatches / self.total_candidates
            if self.total_candidates else 0)

    def _mark(self, equiv):
        if self.parameter['format'] == 'conf':
            equiv.conf = 0.123
        else:
            equiv.comments = self.parameter['format']

    def _unmark_closure(self, equiv):
        """Capture the pre-mark state of a hyphenated word so a
        successful dehyphenation join can revert the mark later."""
        attr = 'conf' if self.parameter['format'] == 'conf' else 'comments'
        old = getattr(equiv, attr)
        return lambda: setattr(equiv, attr, old)

    def process_page(self, docs, page_id):
        doc = docs[0]
        lookup = SpellLookup(self.parameter['command'],
                             self.parameter['normalization'])
        # phase 1: gather the page's lookup candidates (per-word flags
        # mirror the reference loop: consult/clear positions depend on
        # the word being the line's literal first/last element)
        entries = []
        for line in doc.get_lines():
            words = line.get_words()
            for word in words:
                equivs = word.get_textequivs()
                if not equivs:
                    self.logger.warning('Word "%s" contains no text results',
                                        word.id)
                    continue
                text = equivs[0].unicode
                if not text:
                    self.logger.warning('Word "%s" contains empty text',
                                        word.id)
                    continue
                stripped = lookup.letters(text)
                if not stripped:
                    continue
                entries.append((word is words[0], word is words[-1],
                                text, stripped, equivs[0]))
        candidates = len(entries)

        # phase 2: resolve every word in ONE lookup invocation
        unknown_set, status, err = lookup.unknown_batch(
            sorted({e[3] for e in entries}))
        if status != 0:
            self.logger.error('word lookup failed (%d): %s', status, err)
            unknown_set = set()  # like the per-word failure: mark nothing

        # phase 3: walk the reference's marking logic on the resolved
        # sets. Pending dehyphenation candidate: (revert_fn, text minus
        # the hyphen) of the most recent line-final hyphen-terminated
        # word. NOTE: faithfully kept from the reference
        # (mark.py:107-124), including its quirk — the pending entry is
        # only consulted and cleared when a MARKABLE UNKNOWN word is
        # processed, so it survives skipped (letterless/empty) line
        # starts, known first words and lines without unknown words,
        # and may join with a first word several lines later.
        # Which joins get attempted depends only on the word-unknown
        # set (pending clears after every consult either way), so the
        # join queries can be collected in a dry walk and resolved in a
        # second batched invocation before the marking walk.
        def walk(joined_known, apply):
            pending = None
            queries = []
            nonmatches = 0
            for is_first, is_last, text, stripped, equiv in entries:
                if stripped not in unknown_set:
                    continue
                if pending and is_first:
                    # unknown word opening a line after a hyphenated
                    # line end: retry the joined form
                    revert, head = pending
                    joined = lookup.letters(head + text)
                    queries.append(joined)
                    if joined_known(joined):
                        if apply:
                            revert()
                        pending = None
                        nonmatches -= 1
                        continue
                pending = None
                if is_last and text.endswith(HYPHENS):
                    pending = self._unmark_closure(equiv), text[:-1]
                nonmatches += 1
                if apply:
                    self._mark(equiv)
            return queries, nonmatches

        queries, _ = walk(lambda q: False, apply=False)
        joined_unknown = set()
        if queries:
            joined_unknown, jstatus, jerr = lookup.unknown_batch(
                sorted(set(queries)))
            if jstatus != 0:
                self.logger.error('join lookup failed (%d): %s',
                                  jstatus, jerr)
                joined_unknown = set(queries)  # failure = no revert
        _, nonmatches = walk(lambda q: q not in joined_unknown,
                             apply=True)
        self.logger.info(
            'marked %d unmatched words out of %d tokens (%d%%) on %s',
            nonmatches, candidates,
            100 * nonmatches / candidates if candidates else 0, page_id)
        with self._lock:    # page-parallel safe (cf. reference mark.py:32)
            self.total_candidates += candidates
            self.total_nonmatches += nonmatches
        return doc


ocrd_cor_asv_ann_mark = processor_cli(MarkWords)


if __name__ == '__main__':
    ocrd_cor_asv_ann_mark()
