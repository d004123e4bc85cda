"""Cells that correct OCR-D pages: ``ANNCorrection.process_page``.

One client processes a workspace page by page, as the OCR-D processor
``ocrd-cor-asv-ann-process`` does with the cell's parameters: each page
is a PAGE document (parsed in set-up from XML the benchmark drew from
the seed), corrected in place; nothing is written to disk. A unit of the
window is one page, timed from the call to its return.

Spans: ``process_page`` around each page, ``correct_lines`` around the
processor's call into the model API (its time outside the latter is the
processor's own: PAGE to confusion network, realignment, re-segmenting).

What decides ``correct`` (after the window, the program freed): a sample
of the window's pages, drawn from the seed, with the page that holds the
longest served line. For each of their lines the reference
(``reference/beam_path.py``, plain float32 with TF32 off) follows the
served path from the input it works out itself from the page spec, and
reads the line's widest gaps:

- between the log-probability the program served for a character and
  the one the search's rules give it; a character the rules could not
  admit there gets probability 0 (floored at 1e-30, so the gap reads
  about 69), and so does a line with no path or one not ended by a
  newline;
- between a served alignment row (what the processor realigns the page
  by) and the reference's.

Compared: the 99th percentile (nearest rank) of each over the sampled
lines, ``logp_gap_p99`` and ``align_gap_p99``: the beam's rules are
discontinuous (the rejection's 0.1 misalignment bar, the admission cut,
the rounded source position), so float32 rounding can part a sound line
from the reference at a bar; the widest gaps are printed beside them.
The processor's realignment of the page by those rows is not compared:
it does not keep the served text (a served "Wee  aus" can come out as
"We  aus"), and no plain reference of it exists yet (PERF.md).
"""

import sys
import time

import numpy as np
import torch

from .. import harness
from ..generators import pages as gen
from ..reference import beam_path, beam_search, weights
from ..reference import pages as refpages

# keep served alignments for this many candidate sample pages
SAMPLE_POOL = 3
# the probability of what the search's rules cannot give
NO_PROB = 1e-30
# a served line whose cost exceeds the reference search's best by more
# than this (nats) counts as worse in the run's summary
SEARCH_TIE = 1e-3


def nearest_rank(values, q):
    """The q-quantile of `values` by nearest rank."""
    ranked = sorted(values)
    return ranked[max(int(np.ceil(q * len(ranked))) - 1, 0)]


class Cell:

    def __init__(self, config, workload, traffic, seed, device):
        self.config = config
        self.workload = workload
        self.traffic = traffic
        # any whole number, negative ones too, as a generator's seed
        self.seed = int(seed) % (1 << 63)
        self.device = device
        self.spans = harness.Spans()
        self.records = []

    # -- set-up ---------------------------------------------------------
    def setup(self):
        if self.traffic['generator'] != 'pages':
            raise ValueError('process_page cells take the pages generator')
        from cor_asv_ann_tpu_torch.utils.page import parse_page
        from cor_asv_ann_tpu_torch.wrapper.transcode import ANNCorrection
        path = self.model_path()
        params = dict(self.workload['parameters'], model_file=path,
                      device=str(self.device))
        t0 = time.perf_counter()
        proc = ANNCorrection(parameter=params)
        proc.setup()
        self.phases = {'model': time.perf_counter() - t0}
        if proc.s2s.compute != self.workload['compute']:
            raise RuntimeError('the processor serves in %s, the cell states '
                               '%s' % (proc.s2s.compute,
                                       self.workload['compute']))
        self.proc = proc
        self.current = {}
        correct_lines = proc.s2s.correct_lines

        def capture(*args, **kwargs):
            out = correct_lines(*args, **kwargs)
            self.current['served'] = out
            return out
        proc.s2s.correct_lines = self.spans.timed('correct_lines', capture)
        n = self.workload['pages']
        t0 = time.perf_counter()
        self.specs = gen.page_specs(self.traffic, self.seed, n)
        self.docs = [parse_page(gen.page_xml(s)) for s in self.specs]
        self.phases['pages'] = time.perf_counter() - t0
        # the sample's candidates: a seeded draw among the pages that
        # every window reaches
        rng = np.random.default_rng(self.seed ^ 0x5A5A)
        reach = min(self.workload['min_window_units'], n)
        self.candidates = set(rng.permutation(reach)[
            :SAMPLE_POOL * self.workload['check']['sample_pages']].tolist())
        self.longest = (-1, None)
        t0 = time.perf_counter()
        for spec in gen.corner_specs(self.traffic, self.seed ^ 0xC0FFEE):
            proc.process_page([parse_page(gen.page_xml(spec))], 'warm-up')
        self.phases['warm-up'] = time.perf_counter() - t0
        self.next = 0

    def model_path(self):
        path = harness.os.path.join(harness.ROOT, self.config['weights_file'])
        got = weights.file_sha256(path)
        if got != self.config['weights_sha256']:
            raise RuntimeError('%s has sha256 %s, the configuration states %s'
                               % (path, got, self.config['weights_sha256']))
        return path

    # -- the window -----------------------------------------------------
    def run_unit(self, traced):
        i = self.next
        # the window leaves the last pages for a traced run's units
        if i >= len(self.docs) - (0 if traced
                                  else self.workload['trace_units']):
            return None
        self.next += 1
        rec = dict(index=i, traced=traced)
        self.current = rec
        with self.spans.span('process_page', index=i, traced=traced):
            self.proc.process_page([self.docs[i]], 'p%d' % i)
        t0, t1 = self.spans.items[-1]['t0'], self.spans.items[-1]['t1']
        served = rec.pop('served')
        rec.update(t0=t0, t1=t1, lines=len(self.specs[i]),
                   src_lens=[len(refpages.line_positions(w))
                             for w in self.specs[i]],
                   out_lens=[len(s) for s in served[0]])
        longest = max((len(s) for s in served[0]), default=0)
        keep = i in self.candidates
        if longest > self.longest[0]:
            if self.longest[1] is not None and \
                    self.longest[1]['index'] not in self.candidates:
                self.longest[1].pop('served', None)
                self.longest[1].pop('doc', None)
            self.longest = (longest, rec)
            keep = True
        if keep:
            # the page as the processor left it, read after the window
            rec['served'] = served
            rec['doc'] = self.docs[i]
        self.records.append(rec)
        return rec

    def free(self):
        self.proc = None
        self.docs = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # -- what decides `correct` -----------------------------------------
    def sample(self):
        n = self.workload['check']['sample_pages']
        done = {rec['index']: rec for rec in self.records}
        rng = np.random.default_rng(self.seed ^ 0x5A5A)
        reach = min(self.workload['min_window_units'], len(self.specs))
        picked = [done[i] for i in rng.permutation(reach)[
            :SAMPLE_POOL * n].tolist() if i in done][:n]
        if self.longest[1] is not None and self.longest[1] not in picked:
            picked.append(self.longest[1])
        return picked

    def reference(self):
        """The reference's parameters, charset and search parameters."""
        ref = weights.load_file(self.model_path(), self.device)
        charset = weights.charset_of_file(self.model_path())
        c2i = {c: i for i, c in enumerate(charset) if c}
        bp = self.workload['parameters']
        sp = dict(self.workload['search'],
                  rejection_threshold=bp['rejection_threshold'],
                  beam_width_in=int(bp['fixed_beam_width']),
                  beam_threshold_in=bp['relative_beam_width'])
        return ref, charset, c2i, sp

    def readings(self, recs, stand_in=None, tf32=False):
        """The numbers over the sampled pages' lines. With `stand_in`
        (another reading's ``probs``, ``rows`` and ``best``, by (page,
        line)) those stand in for the program's (the control): its
        probabilities and rows along the served paths, and its search's
        best paths for the served ones."""
        ref, charset, c2i, sp = self.reference()
        V = len(charset)
        lines, paths, clamp, keys, served = [], [], [], [], []
        missing = 0
        for rec in recs:
            spec = self.specs[rec['index']]
            out_lines, out_probs, _, out_aligns = rec['served']
            pos = [refpages.line_positions(w) for w in spec]
            tb = refpages.bucket(max(len(p) for p in pos))
            for k, positions in enumerate(pos):
                text = out_lines[k] if k < len(out_lines) else ''
                if not text.endswith('\n'):
                    missing += 1
                    continue
                lines.append(positions)
                paths.append([c2i.get(ch, -2) for ch in text])
                clamp.append(tb)
                keys.append((rec['index'], k))
                served.append((out_probs[k], out_aligns[k]))
        if not lines:
            floor = float(-np.log(NO_PROB))
            return dict(logp_gap_p99=floor, align_gap_p99=1.0,
                        search_gap_p99=floor, logp_gap_max=floor,
                        align_gap_max=1.0, search_gap_max=floor,
                        lines_worse=missing, not_admitted=missing,
                        lines=missing, tokens=0, probs={}, rows={},
                        best={})
        x, src_len = refpages.input_vectors(lines, c2i, V)
        unknown = sum(1 for p in paths for c in p if c < 0)
        dev = self.device
        x, src_len = x.to(dev), src_len.to(dev)
        clamp = torch.tensor(clamp, device=dev)
        window = self.config['window_width']
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.no_grad():
                probs, ok, rows = beam_path.read_paths(
                    ref, x, src_len, clamp, path_tensor(paths, dev), sp,
                    window)
                best, best_paths = beam_search.search(
                    ref, x, src_len, clamp, sp, window, c2i['\n'])
                if stand_in is not None:
                    # the control's own best paths, read by the rules
                    alt = [stand_in['best'][k] for k in keys]
                    alt_p, _, _ = beam_path.read_paths(
                        ref, x, src_len, clamp, path_tensor(alt, dev), sp,
                        window)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        len0 = src_len.cpu().numpy()
        if stand_in is None:
            cost = path_costs(probs, paths, len0, sp['cost0'])
        else:
            cost = path_costs(alt_p, alt, len0, sp['cost0'])
        best = best.cpu().numpy()
        best_paths = best_paths.cpu().numpy()
        probs, ok, rows = probs.cpu().numpy(), ok.cpu().numpy(), \
            rows.cpu().numpy()
        floor = -np.log(NO_PROB)
        # each line's widest gaps; a line without a finished path reads
        # the floor
        line_logp = [floor] * missing
        line_align = [1.0] * missing
        line_search = [floor] * missing
        not_admitted = missing + unknown
        for b, (key, (sp_, sa)) in enumerate(zip(keys, served)):
            n = len(paths[b])
            if stand_in is not None:
                sp_, sa = stand_in['probs'][key], stand_in['rows'][key]
            sp_ = np.asarray(sp_, np.float64)
            rp = np.where(ok[b, :n], probs[b, :n], 0.0).astype(np.float64)
            known = min(paths[b]) >= 0
            line_logp.append(float(np.max(np.abs(
                np.log(np.maximum(sp_, NO_PROB))
                - np.log(np.maximum(rp, NO_PROB))))) if known else floor)
            not_admitted += int((~ok[b, :n]).sum())
            sa = np.asarray(sa, np.float32)
            T = rows.shape[2]
            gap = np.abs(sa[:, :T] - rows[b, :n, :sa.shape[1]])
            extra = np.abs(sa[:, T:]).sum(axis=1) if sa.shape[1] > T \
                else np.zeros(n)
            line_align.append(max(float(gap.max()), float(extra.max())))
            # by how much the served line's cost exceeds the best the
            # reference's search finds (0 where it is as good or better)
            line_search.append(max(0.0, float(cost[b] - best[b]))
                               if known and np.isfinite(best[b]) else
                               (floor if not known else 0.0))
        return dict(logp_gap_p99=nearest_rank(line_logp, 0.99),
                    align_gap_p99=nearest_rank(line_align, 0.99),
                    search_gap_p99=nearest_rank(line_search, 0.99),
                    logp_gap_max=max(line_logp),
                    align_gap_max=max(line_align),
                    search_gap_max=max(line_search),
                    lines_worse=sum(1 for g in line_search
                                    if g > SEARCH_TIE),
                    not_admitted=float(not_admitted),
                    lines=len(line_logp),
                    tokens=int(sum(len(p) for p in paths)),
                    probs={k: probs[b, :len(paths[b])]
                           for b, k in enumerate(keys)},
                    rows={k: rows[b, :len(paths[b])]
                          for b, k in enumerate(keys)},
                    best={k: [int(c) for c in best_paths[b] if c >= 0]
                          for b, k in enumerate(keys)})

    def page_readings(self, recs, V):
        """The lines of the sampled pages whose written output (glyph
        texts and confidences, words, line text) differs from the
        reference's account of it (``reference/realign.py``), worked out
        from the page spec and the served lines; and the first
        difference."""
        wrong, lines, first = 0, 0, None
        for rec in recs:
            spec = self.specs[rec['index']]
            out_lines, out_probs, _, out_aligns = rec['served']
            written = refpages.written_lines(rec['doc'].to_bytes())
            for k, words in enumerate(spec):
                lid = 'l%d' % (k + 1)
                want = refpages.expected_line(
                    lid, words, out_lines[k], out_probs[k], out_aligns[k],
                    V)
                got = written.get(lid)
                lines += 1
                if got != want:
                    wrong += 1
                    if first is None:
                        first = dict(line='p%d:%s' % (rec['index'], lid),
                                     got=got, want=want)
        return wrong, lines, first

    def check(self):
        recs = self.sample()
        got = self.readings(recs)
        V = len(weights.charset_of_file(self.model_path()))
        wrong, lines, first = self.page_readings(recs, V)
        got['page_lines_wrong'] = wrong
        limits = self.workload['check']['limits']
        info = dict(sample_pages=len(recs), sample_lines=got['lines'],
                    sample_tokens=got['tokens'],
                    logp_gap_max=got['logp_gap_max'],
                    align_gap_max=got['align_gap_max'],
                    search_gap_max=got['search_gap_max'],
                    lines_worse=got['lines_worse'],
                    not_admitted=got['not_admitted'])
        if first is not None:
            print('first page line that differs: %r' % (first,),
                  file=sys.stderr)
        return [dict(name=k, value=got[k], limit=limits[k])
                for k in ('logp_gap_p99', 'align_gap_p99', 'search_gap_p99',
                          'page_lines_wrong')], info

    def control(self):
        """The reference in TF32 put in the program's place: its
        probabilities and rows along the same served paths, and its
        search's best paths, read by the float32 reference."""
        recs = self.sample()
        low = self.readings(recs, tf32=True)
        got = self.readings(recs, stand_in=low)
        return {k: got[k] for k in ('logp_gap_p99', 'align_gap_p99',
                                    'search_gap_p99', 'logp_gap_max',
                                    'align_gap_max', 'search_gap_max',
                                    'lines_worse')}


def path_tensor(paths, dev):
    """(B, L) long of lists of character indexes, -1 past each end (an
    unknown character, < 0, reads as index 0)."""
    L = max(len(p) for p in paths)
    out = torch.full((len(paths), L), -1, dtype=torch.long)
    for b, p in enumerate(paths):
        out[b, :len(p)] = torch.tensor([max(c, 0) for c in p])
    return out.to(dev)


def path_costs(probs, paths, len0, cost0):
    """The prospective cost of each path by the search's rule: its
    summed -log p (float32, step by step) and cost0 * |n + 1 - len0|."""
    probs = probs.float().cpu().numpy()
    out = []
    for b, p in enumerate(paths):
        cum = np.float32(0.0)
        for q in probs[b, :len(p)]:
            cum = np.float32(cum - np.log(np.maximum(np.float32(q),
                                                     np.float32(1e-30))))
        out.append(float(cum) + cost0 * abs(len(p) + 1 - float(len0[b])))
    return np.asarray(out)
