"""Line-level evaluation processor (ocrd-cor-asv-ann-evaluate).

A copy of the JAX package's ``wrapper/evaluate.py`` (host code), kept here so
the port imports nothing of that package.

Re-derivation of reference EvaluateLines (wrapper/evaluate.py:28-373):
compare TextLine annotations across input fileGrps (or across
TextEquiv/@index within one fileGrp), with the first input as ground
truth; per-line CER/WER under the chosen metric, aggregated per page and
globally (streaming Edits merging); JSON reports per page plus one
document-level report including confusion tables, histograms and worst
lines.
"""

import json
import math

from ..lib.alignment import Alignment, Edits, splitwords
from .base import PageProcessor, processor_cli


def _linekey(line, match_on, logger=None):
    if match_on == 'id':
        return line.id
    if match_on == 'baseline':
        pts = line.get_points('Baseline')
        if not pts:
            if logger:
                logger.error('cannot extract baseline from line "%s"',
                             line.id)
            pts = line.get_points()
        return tuple(pts)
    if match_on == 'coords':
        return tuple(line.get_points())
    return line.id


def page_get_lines(doc, match_on='id', logger=None):
    """All TextLines of the page keyed by id/coords/baseline, or per
    TextEquiv index when match_on=index (reference evaluate.py:326-373)."""
    result = dict()
    regions = doc.get_regions()
    if not regions and logger:
        logger.warning('Page contains no text regions')
    for region in regions:
        lines = region.get_lines()
        if not lines:
            if logger:
                logger.warning('Region "%s" contains no text lines',
                               region.id)
            continue
        for line in lines:
            textequivs = line.get_textequivs()
            if not textequivs:
                if logger:
                    logger.warning('Line "%s" contains no text results',
                                   line.id)
                continue
            if match_on == 'index':
                for i, textequiv in enumerate(textequivs):
                    index = textequiv.index if textequiv.index is not None \
                        else i
                    lined = result.setdefault(line.id, dict())
                    lined[index] = textequiv.unicode
            else:
                result[_linekey(line, match_on, logger)] = \
                    textequivs[0].unicode
    return result


class EvaluateLines(PageProcessor):
    """Evaluate OCR (and post-correction) quality against ground truth."""

    executable = 'ocrd-cor-asv-ann-evaluate'
    input_file_grp_cardinality = (1, None)
    # aggregates document-level Edits across pages in order; serial like
    # the reference (evaluate.py:29)
    max_workers = 1
    parameter_schema = {
        'match_on': {'type': 'string', 'default': 'id',
                     'enum': ['index', 'id', 'coords', 'baseline']},
        'metric': {'type': 'string', 'default': 'Levenshtein-fast',
                   'enum': ['Levenshtein-fast', 'Levenshtein', 'NFC',
                            'NFKC', 'historic_latin']},
        'gt_level': {'type': 'number', 'default': 1, 'enum': [1, 2, 3]},
        'confusion': {'type': 'number', 'default': 0},
        'histogram': {'type': 'boolean', 'default': False},
    }

    def verify(self, input_grps):
        from .base import ParameterError
        if self.parameter['match_on'] == 'index':
            if len(input_grps) != 1:
                raise ParameterError(
                    'only 1 input fileGrp when match_on==index')
        elif len(input_grps) < 2:
            raise ParameterError(
                'need multiple input fileGrps to compare when '
                'match_on!=index')
        if self.parameter['confusion'] and \
                self.parameter['metric'] == 'Levenshtein-fast':
            # the fast metric never feeds the confusion aligners; a
            # silently empty table over thousands of lines is worse
            # than an upfront error
            raise ParameterError(
                'confusion > 0 requires a full alignment metric '
                '(Levenshtein/NFC/NFKC/historic_latin), not '
                'Levenshtein-fast')

    def _pair(self, i):
        if self.parameter['match_on'] == 'index':
            return '%d,0' % i
        return self.input_file_grps[i] + ',' + self.input_file_grps[0]

    def _name(self, i):
        if self.parameter['match_on'] == 'index':
            return 'index %d' % i
        return self.input_file_grps[i]

    def _grow_stats(self, n):
        confusion = self.parameter['confusion']
        histogram = self.parameter['histogram']
        while len(self.cedits) < n:
            self.cedits.append(Edits(self.logger, histogram=histogram))
            self.wedits.append(Edits(self.logger))
            self.caligners.append(Alignment(logger=self.logger,
                                            confusion=bool(confusion)))
            self.waligners.append(Alignment(logger=self.logger))

    def setup(self):
        # initialized here (not only in start_document / the
        # process_workspace override) so per-page use without the
        # workspace runner — e.g. through the OCR-D core adapter, which
        # drives document iteration itself — still works
        self.input_file_grps = None
        self.cedits, self.wedits = [], []
        self.caligners, self.waligners = [], []
        self._workspace = None
        self._output_grp = None
        self._page_report = None
        self.report = None

    def start_document(self, workspace, input_grps, output_grp):
        self.input_file_grps = input_grps
        self.cedits, self.wedits = [], []
        self.caligners, self.waligners = [], []
        self._grow_stats(len(input_grps))

    def _report_pair(self, report, i, cedits, wedits):
        pair = self._pair(i)
        entry = report.setdefault(pair, dict())
        entry[''] = self._name(i)
        entry['num-lines'] = cedits[i].steps
        entry['num-words'] = wedits[i].length
        entry['num-chars'] = cedits[i].length
        entry['char-error-rate-mean'] = cedits[i].mean
        entry['char-error-rate-varia'] = cedits[i].varia
        entry['word-error-rate-mean'] = wedits[i].mean
        entry['word-error-rate-varia'] = wedits[i].varia
        entry['char-error-worst-lines'] = [str(ex) for ex in cedits[i].worst]

    def process_page(self, docs, page_id):
        if self.input_file_grps is None:
            # bare per-page use: seed document state from the page shape
            self.start_document(
                None, ['input-%d' % i for i in range(len(docs))], None)
        metric = self.parameter['metric']
        gtlevel = int(self.parameter['gt_level'])
        confusion = self.parameter['confusion']
        histogram = self.parameter['histogram']
        match = self.parameter['match_on']
        file_cedits = [Edits(self.logger, histogram=histogram)
                       for _ in self.input_file_grps]
        file_wedits = [Edits(self.logger) for _ in self.input_file_grps]
        if match == 'index':
            line_indexes = page_get_lines(docs[0], match, self.logger)
            file_lines = []
            for line_id, indexes in line_indexes.items():
                for index in indexes:
                    while len(file_lines) <= index:
                        file_lines.append(dict())
                    file_lines[index][line_id] = indexes[index]
            while len(file_cedits) < len(file_lines):
                file_cedits.append(Edits(self.logger, histogram=histogram))
                file_wedits.append(Edits(self.logger))
            self._grow_stats(len(file_lines))
        else:
            for i, doc in enumerate(docs):
                if doc is None and i > 0:
                    # a page entirely missing from a non-GT fileGrp
                    # shrinks that column's aggregate silently otherwise
                    self.logger.error(
                        'page "%s" entirely missing from input %d (%s); '
                        'its lines are skipped for that pair', page_id,
                        i, self._name(i))
            file_lines = [page_get_lines(doc, match, self.logger)
                          if doc is not None else {} for doc in docs]
        report = dict()
        gt_lines = file_lines[0] if file_lines else {}
        for line_id in gt_lines:
            for i, input_lines in enumerate(file_lines):
                if i == 0:
                    continue
                pair = self._pair(i)
                report.setdefault(pair, dict()).setdefault('lines', list())
                if not input_lines:
                    continue
                if line_id not in input_lines:
                    self.logger.error(
                        'line "%s" is missing from input %d on page %s',
                        line_id, i, page_id)
                    report[pair]['lines'].append({str(line_id): 'missing'})
                    continue
                gt_line = gt_lines[line_id]
                ocr_line = input_lines[line_id]
                gt_words = splitwords(gt_line)
                ocr_words = splitwords(ocr_line)
                if 0.2 * (len(gt_line) + len(ocr_line)) < \
                        math.fabs(len(gt_line) - len(ocr_line)) > 5:
                    self.logger.warning(
                        'line "%s" from input %d deviates significantly in '
                        'length (%d vs %d) on page %s', line_id, i,
                        len(gt_line), len(ocr_line), page_id)
                if metric == 'Levenshtein-fast':
                    cdist, clen = Alignment.get_levenshtein_distance(
                        ocr_line, gt_line)
                    wdist, wlen = Alignment.get_levenshtein_distance(
                        ocr_words, gt_words)
                else:
                    norm = None if metric == 'Levenshtein' else metric
                    cdist, clen = self.caligners[i].get_adjusted_distance(
                        ocr_line, gt_line, normalization=norm,
                        gtlevel=gtlevel)
                    wdist, wlen = self.waligners[i].get_adjusted_distance(
                        ocr_words, gt_words, normalization=norm,
                        gtlevel=gtlevel)
                file_cedits[i].add(cdist, clen, ocr_line, gt_line,
                                   name=str(line_id))
                file_wedits[i].add(wdist, wlen, ocr_words, gt_words,
                                   name=str(line_id))
                report[pair]['lines'].append({str(line_id): {
                    'char-length': len(gt_line),
                    'char-error-rate': cdist / clen if clen else 0,
                    'word-error-rate': wdist / wlen if wlen else 0,
                    'gt': gt_line, 'ocr': ocr_line}})
        for i, input_lines in enumerate(file_lines):
            if i == 0 or not input_lines:
                continue
            self.logger.info(
                '%5d lines %.3f±%.3f CER %.3f±%.3f WER %s / %s',
                file_cedits[i].steps, file_cedits[i].mean,
                math.sqrt(file_cedits[i].varia), file_wedits[i].mean,
                math.sqrt(file_wedits[i].varia), page_id, self._pair(i))
            self._report_pair(report, i, file_cedits, file_wedits)
            prefix = self._name(i) + ':' + str(page_id) + ':'
            self.cedits[i].merge(file_cedits[i], name_prefix=prefix)
            self.wedits[i].merge(file_wedits[i], name_prefix=prefix)
        self._page_report = report
        if self._workspace is not None and self._output_grp:
            self._workspace.add_file(
                self._output_grp, page_id,
                json.dumps(report, indent=2, ensure_ascii=False),
                file_id='%s_%s' % (self._output_grp, page_id),
                mimetype='application/json', ext='.json')
        return None

    def process_workspace(self, workspace, input_grps, output_grp,
                          page_ids=None):
        from ..utils.workspace import Workspace
        if isinstance(workspace, str):
            workspace = Workspace(workspace)
        self._workspace = workspace
        self._output_grp = output_grp
        super().process_workspace(workspace, input_grps, output_grp,
                                  page_ids)

    def end_document(self, workspace, input_grps, output_grp):
        report = dict()
        for i in range(1, len(self.cedits)):
            if not self.cedits[i].steps:
                self.logger.warning('%s had no textlines whatsoever',
                                    self._name(i))
                continue
            pair = self._pair(i)
            self.logger.info(
                '%5d lines %.3f±%.3f CER %.3f±%.3f WER overall / %s',
                self.cedits[i].steps, self.cedits[i].mean,
                math.sqrt(self.cedits[i].varia), self.wedits[i].mean,
                math.sqrt(self.wedits[i].varia), pair)
            report[pair] = dict()
            self._report_pair(report, i, self.cedits, self.wedits)
            if self.parameter['confusion']:
                conf = self.caligners[i].get_confusion(
                    int(self.parameter['confusion']))
                report[pair]['confusion'] = repr(conf)
            if self.parameter['histogram']:
                report[pair]['histogram'] = repr(self.cedits[i].hist())
        self.report = report
        if output_grp:
            workspace.add_file(
                output_grp, None,
                json.dumps(report, indent=2, ensure_ascii=False),
                file_id=output_grp, mimetype='application/json',
                ext='.json')


ocrd_cor_asv_ann_evaluate = processor_cli(EvaluateLines)


if __name__ == '__main__':
    ocrd_cor_asv_ann_evaluate()
