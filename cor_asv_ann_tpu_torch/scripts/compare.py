"""cor-asv-ann-compare CLI (reference scripts/compare.py:16-173).

A copy of the JAX package's ``scripts/compare.py`` (host code), kept here so
the port imports nothing of that package.

Model-free 1:n comparison of PAGE-XML or plain-text files, producing a
JSON report with per-line CER/WER, aggregate statistics, worst lines,
confusion tables and histograms.  The option surface and report schema
follow the reference; the implementation is organized around a
per-pair streaming accumulator (PairStats) instead of parallel aligner
lists.
"""

import json
import logging
import math
import os
import sys

import click

from ..lib.alignment import Alignment, Edits, splitwords

CONTEXT_SETTINGS = dict(help_option_names=['-h', '--help'])


def get_lines(fname, flist=False):
    """Read lines from a PAGE-XML file (dict by line id), a plain text
    file (list), or a file list (dict by base name)."""
    with open(fname, 'r', encoding='utf-8') as fd:
        rawlines = [line.rstrip('\r\n') for line in fd.readlines()]
    first = rawlines[0].lstrip() if rawlines else ''
    # PAGE-XML may legally omit the <?xml?> declaration; detect any
    # XML-looking file and surface parse failures instead of silently
    # comparing raw markup lines as text
    if first.startswith('<'):
        from ..utils.page import parse_page
        from ..wrapper.evaluate import page_get_lines
        try:
            doc = parse_page(fname)
        except Exception as err:
            logging.getLogger('cor-asv-ann-compare').warning(
                '%s looks like XML but does not parse as PAGE (%s); '
                'treating it as plain text', fname, err)
        else:
            return page_get_lines(doc, 'id')
    if not flist:
        return rawlines
    # ocropy convention: each entry is the path of a single-line file
    # (e.g. -F <(ls -1 *.gt.txt) <(ls -1 *.ocr.txt)); key by the path
    # with extensions stripped so GT/OCR lists with different suffixes
    # still pair up
    by_key = {}
    for path in rawlines:
        key = path
        if path.endswith('.txt'):
            parent, leaf = os.path.split(path)
            key = os.path.join(parent, leaf.split('.')[0])
        with open(path, 'r', encoding='utf-8') as fd:
            by_key[key] = fd.readline()
    return by_key


def iter_keyed(lines):
    """Yield (key, line) whether `lines` is a dict or a list."""
    if isinstance(lines, dict):
        yield from lines.items()
    else:
        yield from enumerate(lines)


def lookup(lines, key):
    """Return lines[key], or None when absent (dict or list).

    A string line id against a plain list (PAGE-XML OCR vs plain-text
    GT) cannot match positionally — treat as missing instead of
    comparing str with int."""
    if isinstance(lines, dict):
        return lines.get(key)
    if not isinstance(key, int):
        return None
    return lines[key] if key < len(lines) else None


class PairStats:
    """Streaming CER/WER statistics for one (OCR file, GT file) pair."""

    def __init__(self, log, metric, gt_level, want_confusion,
                 want_histogram):
        self.log = log
        self.metric = metric
        self.gt_level = gt_level
        self.chars = Edits(logger=log, histogram=want_histogram)
        self.words = Edits(logger=log)
        self.char_aligner = Alignment(logger=log,
                                      confusion=want_confusion)
        self.word_aligner = Alignment(logger=log)
        self.records = []

    def _distances(self, ocr_line, gt_line, ocr_words, gt_words):
        if self.metric == 'Levenshtein-fast':
            cdist = self.char_aligner.get_levenshtein_distance(
                ocr_line, gt_line)
            wdist = self.word_aligner.get_levenshtein_distance(
                ocr_words, gt_words)
            return cdist, wdist
        norm = None if self.metric == 'Levenshtein' else self.metric
        cdist = self.char_aligner.get_adjusted_distance(
            ocr_line, gt_line, normalization=norm, gtlevel=self.gt_level)
        wdist = self.word_aligner.get_adjusted_distance(
            ocr_words, gt_words, normalization=norm,
            gtlevel=self.gt_level)
        return cdist, wdist

    def measure(self, key, ocr_line, gt_line):
        """Accumulate one line pair and append its report record."""
        ocr_line, gt_line = ocr_line.strip(), gt_line.strip()
        length_gap = abs(len(gt_line) - len(ocr_line))
        if length_gap > 5 and \
                length_gap > 0.2 * (len(gt_line) + len(ocr_line)):
            self.log.warning(
                'length of line %r differs a lot between OCR and GT '
                '(%d vs %d chars)', key, len(ocr_line), len(gt_line))
        ocr_words, gt_words = splitwords(ocr_line), splitwords(gt_line)
        (cdist, clen), (wdist, wlen) = self._distances(
            ocr_line, gt_line, ocr_words, gt_words)
        _, edit_ops = Alignment.best_alignment(ocr_line, gt_line, True)
        self.chars.add(cdist, clen, ocr_line, gt_line, name=str(key))
        self.words.add(wdist, wlen, ocr_words, gt_words, name=str(key))
        self.records.append({str(key): {
            'char-length': len(gt_line),
            'char-error-rate': cdist / clen if clen else 0,
            'word-error-rate': wdist / wlen if wlen else 0,
            'gt': gt_line, 'ocr': ocr_line,
            'edits': repr(edit_ops)}})

    def missing(self, key):
        self.records.append({str(key): 'missing'})

    def summary(self, confusion_count, want_histogram):
        """The pair-level report section (schema per the reference)."""
        section = {
            'lines': self.records,
            'num-lines': self.chars.steps,
            'num-words': self.words.length,
            'num-chars': self.chars.length,
            'char-error-rate-mean': self.chars.mean,
            'char-error-rate-varia': self.chars.varia,
            'word-error-rate-mean': self.words.mean,
            'word-error-rate-varia': self.words.varia,
            'char-error-worst-lines': [str(example)
                                       for example in self.chars.worst],
        }
        if confusion_count and self.chars.length:
            section['confusion'] = repr(
                self.char_aligner.get_confusion(confusion_count))
        if want_histogram:
            section['histogram'] = repr(self.chars.hist())
        return section


@click.command(context_settings=CONTEXT_SETTINGS)
@click.option('-o', '--output-file', default='-',
              help='path name of generated report (default: stdout)',
              type=click.Path(dir_okay=False, writable=True,
                              allow_dash=True))
@click.option('-n', '--normalization', default='historic_latin',
              type=click.Choice(['Levenshtein-fast', 'Levenshtein', 'NFC',
                                 'NFKC', 'historic_latin']),
              help='normalize character sequences before comparison')
@click.option('-l', '--gt-level', default=1, type=click.IntRange(1, 3),
              help='GT transcription level for historic_latin')
@click.option('-c', '--confusion', default=10, type=click.IntRange(min=0),
              help='show this number of most frequent (non-identity) edits')
@click.option('-H', '--histogram', is_flag=True,
              help='aggregate and compare character histograms')
@click.option('-F', '--file-lists', is_flag=True,
              help='interpret files as lists of single-line text file paths')
@click.argument('gt_file', type=click.Path(dir_okay=False, exists=True))
@click.argument('ocr_files', type=click.Path(dir_okay=False, exists=True),
                nargs=-1)
def cli(output_file, normalization, gt_level, confusion, histogram,
        file_lists, gt_file, ocr_files):
    """Compare text lines by aligning and computing the textual distance
    and character error rate.

    This compares 1:n given PAGE-XML or plain text files.

    If `--file-lists` is given and files are plain text, then they will
    be interpreted as (newline-separated) lists of path names for
    single-line text files (Ocropus convention).

    Writes a JSON report file to `--output-file`.
    """
    logging.basicConfig(
        format='%(asctime)s.%(msecs)03d %(levelname)s %(name)s - %(message)s',
        datefmt='%H:%M:%S', level=logging.INFO)
    log = logging.getLogger(__name__)

    log.info('reading GT from %r', gt_file)
    gt_lines = get_lines(gt_file, file_lists)
    if not gt_lines:
        log.critical('file %r contains no text lines to compare', gt_file)
        sys.exit(1)
    report = {}
    for ocr_file in ocr_files:
        log.info('comparing %r against GT', ocr_file)
        ocr_lines = get_lines(ocr_file, file_lists)
        if not ocr_lines:
            log.error('file %r contains no text lines to compare',
                      ocr_file)
            continue
        stats = PairStats(log, normalization, gt_level,
                          bool(confusion), bool(histogram))
        for key, ocr_line in iter_keyed(ocr_lines):
            gt_line = lookup(gt_lines, key)
            if gt_line is None:
                log.error('line %r of %r has no counterpart in GT %r',
                          key, ocr_file, gt_file)
                stats.missing(key)
            else:
                stats.measure(key, ocr_line, gt_line)
        log.info('%5d lines CER %.3f±%.3f WER %.3f±%.3f for %s vs %s',
                 stats.chars.length, stats.chars.mean,
                 math.sqrt(stats.chars.varia), stats.words.mean,
                 math.sqrt(stats.words.varia), ocr_file, gt_file)
        report[ocr_file + ',' + gt_file] = stats.summary(
            confusion, histogram)

    # explicit utf-8: the report holds historic-Latin text and
    # ensure_ascii=False would crash under a non-UTF-8 locale otherwise
    output = sys.stdout if output_file == '-' \
        else open(output_file, 'w', encoding='utf-8')
    json.dump(report, output, indent=2, ensure_ascii=False)
    if output is not sys.stdout:
        output.close()


if __name__ == '__main__':
    cli()
