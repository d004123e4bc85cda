"""High-level model API mirroring the reference `Sequence2Sequence` class.

Port of the JAX package's ``models/api.py``: configure / load_config /
load_weights / load_transfer_weights / save / map_files / train /
correct_lines / correct_stream / predict / evaluate /
decode_batch_greedy, with greedy and beam decoding. ``self.params`` is
the float32 numpy parameter tree; serving and training copy it to
tensors on ``self.device``.

Decode batches are padded to power-of-two batch buckets and length
buckets (utils/data.py:LENGTH_BUCKETS). The dispatch rule of the JAX
package holds: bfloat16 greedy batches without alignments whose size
lies in the fused window (1-16 lines, or what `autotune_fused_decode`
measured on the card) go through the whole-loop CUDA kernel
(ops/decode_loop_kernel.py) in buckets up to 256, long buckets through
the windowed decoder, the rest through ``decode_greedy``; without
`greedy` a batch goes through the beam search with rejection
(models/beam.py), whose bounds adapt to a cached greedy confidence probe
(`_beam_params`). Beam alignments are recorded as
windowed soft rows and expanded on the host to dense length-T rows
(`_expand_windowed_alignment`).
"""

import logging
import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..lib.alignment import Alignment, Edits, splitwords
from ..ops.decode_loop_kernel import (decode_greedy_fused,
                                      fused_greedy_supported)
from ..utils import io_h5
from ..utils.data import (CharMapping, GAP, gen_line_batches,
                          lines_to_index_batch, scan_files,
                          vectorize_lines)
from .beam import BeamParams, decode_beam
from .config import Seq2SeqConfig, init_params
from .params import params_from_numpy
from .seq2seq import decode_greedy, decode_greedy_windowed

# bucket length from which the windowed-gather decoder is dispatched
# (the JAX package's rule, kept so both packages decode a bucket alike)
WINDOWED_DECODE_MIN_T = 128
# largest batch the whole-loop kernel is dispatched for by default (the
# JAX package's default; `autotune_fused_decode` measures a window)
FUSED_DECODE_MAX_B = 16


def _pick_fused_bound(ratios, floor=16):
    """Choose the fused-decode dispatch WINDOW (min_b, max_b) from
    measured fused/per-op throughput ratios per batch size: the longest
    contiguous run of measured wins (ratio >= 1.0; ties resolved toward
    larger batches), so the dispatched regime is >= 1.0x by construction
    on the measuring device. When the run includes the smallest measured
    batch and that batch is within `floor`, the window extends down to 1
    (smaller batches are unmeasured); a measured loss at the small end
    instead RAISES the window's lower bound, so a day where B=16 loses but
    B=32-64 win keeps the 32-64 regime fused. No measured wins at all ->
    (0, 0) (fused dispatch off); no measurements -> the static default
    window (1, floor). The JAX package's rule, unchanged."""
    bs = sorted(ratios)
    if not bs:
        return 1, floor
    runs, cur = [], []
    for b in bs:
        if ratios[b] >= 1.0:
            cur.append(b)
        else:
            if cur:
                runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    if not runs:
        # the sub-floor assumption survives only when nothing at or
        # below the floor was measured losing
        return (1, floor) if bs[0] > floor else (0, 0)
    # prefer the longest run; ties resolve first toward the run that
    # anchors the stable small-batch regime, then toward larger batches
    best = max(runs, key=lambda r: (len(r),
                                    r[0] == bs[0] and r[0] <= floor,
                                    r[-1]))
    if best[0] == bs[0] and best[0] <= floor:
        return 1, max(best[-1], floor)
    return best[0], best[-1]


def _dropped_wins(ratios, window):
    """The measured winning batch sizes (ratio >= 1.0) that `window`
    (min_b, max_b) leaves on the per-op decode."""
    lo, hi = window
    return [b for b in sorted(ratios) if ratios[b] >= 1.0
            and not lo <= b <= hi]


def _synchronize(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _pack_results(idx, prob, length, score):
    """Concatenate the greedy-decode results into one (B, 2S+2) float32
    tensor, so the host fetches once. Exact: indices < V, probabilities
    and lengths <= S are all well inside float32's integer range."""
    f32 = torch.float32
    return torch.cat([idx.to(f32), prob.to(f32), length[:, None].to(f32),
                      score[:, None].to(f32)], dim=1)


def _expand_windowed_alignment(rows, starts, T):
    """Expand per-step windowed soft-alignment rows (L, WIN) with window
    offsets (L,) to a dense (L, T) float32 matrix, the reference's full
    per-step alignments. Out-of-bounds window tails (possible for
    rejection rows whose start is src_pos near T-1) land in a scratch
    column T that is sliced off, so they can never clobber column T-1."""
    L, win = rows.shape
    align = np.zeros((L, T + 1), np.float32)
    cols = starts[:, None] + np.arange(win)
    align[np.arange(L)[:, None], np.minimum(cols, T)] = \
        rows.astype(np.float32)
    return align[:, :T]


class Sequence2Sequence:
    """Character-level seq2seq OCR post-correction on a CUDA GPU."""

    # batches dispatched ahead of the one being fetched
    PIPELINE_DEPTH = 2

    def __init__(self, logger=None, device=None):
        # resolved first: without a GPU and without device='cpu' this
        # raises instead of serving on the CPU
        self.device = resolve_device(device)
        # model parameters (reference seq2seq.py:108-179)
        self.batch_size = 256
        self.stateful = False
        self.width = 512
        self.depth = 2
        self.mapping = CharMapping()
        self.residual_connections = False
        self.deep_bidirectional_encoder = False
        self.bridge_dense = False
        # training parameters
        self.epochs = 100
        self.lm_loss = False
        self.lm_predict = False
        self.scheduled_sampling = None
        # reference-quirk parity for scheduled sampling: feed sampled
        # lines ZERO teacher input like the reference's uint32-truncated
        # feedback buffer (models/train.py:_scheduled_sample); default
        # feeds one-hot greedy outputs (the documented intent)
        self.keras_sampling = False
        self.dropout = 0.2
        self.learning_rate = 1e-3  # Keras Adam default (seq2seq.py:496)
        self.patience = 3           # early-stopping patience (seq2seq.py:619)
        # training compute dtype: None/'float32' or 'bfloat16' (mixed
        # precision: bf16 forward/backward, float32 masters)
        self.train_compute = None
        # inference compute dtype: 'float32' (reference parity) or
        # 'bfloat16' (master weights stay float32)
        self.compute = 'float32'
        # whole-loop greedy decode kernel for bf16 batches of
        # fused_decode_min_b..fused_decode_max_b lines
        self.fused_decode = True
        self.fused_decode_max_b = FUSED_DECODE_MAX_B
        self.fused_decode_min_b = 1
        # beam decoder parameters
        self.rejection_threshold = 0.3
        self.beam_width_in = 15
        self.beam_threshold_in = 0.2
        self.beam_width_out = 16
        # beam search bounds (None = auto, see _beam_params): auto bounds
        # adapt to a cheap measured confidence signal (one cached greedy
        # probe, `_model_confidence`); set them explicitly to pin speed
        # and fidelity
        self.beam_reservoir = None
        self.beam_expand = None
        self.logger = logger or logging.getLogger(__name__)
        self.aligner = Alignment(0, logger=self.logger)
        self.config = None
        self.params = None
        self.status = 0

    @property
    def voc_size(self):
        return self.mapping.voc_size

    def __repr__(self):
        return (__name__
                + " (width: %d)" % self.width
                + " (depth: %d)" % self.depth
                + " (chars: %d)" % self.voc_size
                + " (attention)"
                + (" (stateful)" if self.stateful else " (stateless)")
                + " status: %s" % ("empty" if self.status < 1 else
                                   "configured" if self.status < 2 else
                                   "trained"))

    # ------------------------------------------------------------------
    # configuration & persistence

    def configure(self, batch_size=None):
        if batch_size:
            self.batch_size = batch_size
        if self.stateful:
            self.logger.warning('stateful mode is not implemented; '
                                'proceeding stateless')
        self.config = Seq2SeqConfig(
            width=int(self.width), depth=int(self.depth),
            voc_size=self.voc_size,
            residual_connections=bool(self.residual_connections),
            deep_bidirectional_encoder=bool(self.deep_bidirectional_encoder),
            bridge_dense=bool(self.bridge_dense),
            dropout=float(self.dropout), stateful=bool(self.stateful),
            window_width=int(getattr(self, 'window_width', 5)),
            # length-masked recurrence/attention (see Seq2SeqConfig);
            # s2s.keras_padding = True before configure() restores the
            # reference's run-through padding
            mask_padding=not getattr(self, 'keras_padding', False))
        if self.params is None or self.status < 2:
            self.params = init_params(self.config)
        self.logger.info(
            'model of depth %d width %d size %d with attention on %s',
            self.depth, self.width, self.voc_size, self.device)
        self.status = max(self.status, 1)

    def _reconfigure_for_mapping(self, old_voc_size):
        """Rebuild after vocabulary growth, transferring embedding rows
        (reference seq2seq.py:499-525)."""
        old_params = self.params if self.status >= 2 else None
        status = self.status
        self.status = min(self.status, 1)
        self.params = None
        self.configure()
        if old_params is not None:
            new_params = self.params
            for key in ('char_embedding',):
                new_kernel = np.array(new_params[key]['kernel'])
                old_kernel = np.asarray(old_params[key]['kernel'])
                new_kernel[:old_voc_size] = old_kernel[:old_voc_size]
                new_params[key]['kernel'] = new_kernel
            # all other weights are shape-independent of voc_size
            for key in ('attention_dense', 'encoder', 'decoder', 'bridge'):
                if key in old_params:
                    new_params[key] = old_params[key]
            self.params = new_params
            self.status = status

    def map_files(self, filenames, charmap=None):
        chars, num_lines = scan_files(filenames, charmap=charmap)
        new_mapping, grew = self.mapping.grow([''.join(chars)])
        if grew:
            old_voc = self.voc_size
            # remap embedding rows from old indices to new
            old_mapping = self.mapping
            self.mapping = new_mapping
            if self.status >= 1:
                if self.status >= 2 and self.params is not None:
                    old_kernel = np.asarray(
                        self.params['char_embedding']['kernel'])
                    self._reconfigure_for_mapping(0)
                    kernel = np.array(self.params['char_embedding']['kernel'])
                    for char, old_idx in old_mapping.c2i.items():
                        new_idx = self.mapping.get(char)
                        kernel[new_idx] = old_kernel[old_idx]
                    self.params['char_embedding']['kernel'] = kernel
                else:
                    self._reconfigure_for_mapping(old_voc)
        return num_lines

    def save(self, filename):
        if self.status < 2:
            raise RuntimeError('train or load a model before save')
        self.logger.info('Saving model under "%s"', filename)
        io_h5.save_model(filename, self.params, self.config, self.mapping)

    def load_config(self, filename):
        config, mapping = io_h5.load_config(filename)
        self.width = config.width
        self.depth = config.depth
        self.stateful = config.stateful
        self.residual_connections = config.residual_connections
        self.deep_bidirectional_encoder = config.deep_bidirectional_encoder
        self.bridge_dense = config.bridge_dense
        self.mapping = mapping

    def load_weights(self, filename):
        if self.status < 1:
            raise RuntimeError('configure() the model before load_weights')
        self.logger.info('Loading model from "%s"', filename)
        self.params = io_h5.load_weights(filename, self.config,
                                         logger=self.logger)
        self.status = 2

    def load_transfer_weights(self, filename):
        if self.status < 1:
            raise RuntimeError('configure() the model before '
                               'load_transfer_weights')
        if self.depth < 2:
            raise ValueError('transfer needs a model of depth 2 or more')
        self.logger.info('Transferring model from "%s"', filename)
        params, mapping, frozen = io_h5.load_transfer_weights(
            filename, self.params, self.config, logger=self.logger)
        if mapping is not None and mapping.c2i != self.mapping.c2i:
            self.mapping = mapping
            self.configure()
            params, _, frozen = io_h5.load_transfer_weights(
                filename, self.params, self.config, logger=self.logger)
        self.params = params
        self.frozen_layers = frozen
        self.status = 1

    # ------------------------------------------------------------------
    # inference

    def _beam_params(self, confidence=None):
        """The beam's bounds. Auto reservoir 2*width_in (>= 32) and
        expand width 48 at rejection <= 0.3 (every golden-corpus decode
        byte-exact); higher rejection thresholds spawn longer rejection
        chains and keep 4*width_in (>= 64). A weakly trained model rides
        near-ties constantly, so the fixed-shape reservoir prunes races
        the reference's unbounded queue explores: agreement converges
        with R. `confidence` is the geometric-mean greedy top-1
        probability of the model on the actual inputs
        (`_model_confidence`; the JAX package measured 0.997 on the
        flagship, 0.809 on the reference-trained artifact): >= 0.95
        keeps the fast bounds, the mid tier doubles the reservoir, below
        0.85 the deep bounds R=256, K=96 apply."""
        deep = self.rejection_threshold > 0.3
        if confidence is None or confidence >= 0.95:
            auto_r = max((4 if deep else 2) * self.beam_width_in,
                         64 if deep else 32)
            auto_k = 48
        elif confidence >= 0.85:
            auto_r = max(4 * self.beam_width_in, 128 if deep else 64)
            auto_k = 48
        else:
            auto_r, auto_k = 256, 96
        return BeamParams(
            reservoir=int(self.beam_reservoir
                          if self.beam_reservoir is not None else auto_r),
            expand=int(self.beam_expand
                       if self.beam_expand is not None else auto_k),
            beam_width_in=int(self.beam_width_in),
            beam_threshold_in=float(self.beam_threshold_in),
            beam_width_out=int(self.beam_width_out),
            rejection_threshold=float(self.rejection_threshold),
            lm_predict=bool(self.lm_predict))

    # probe at most this many lines for the confidence signal
    _CONF_PROBE_B = 32

    def _model_confidence(self, params, enc, newline):
        """Geometric-mean greedy top-1 probability of this model on (a
        probe slice of) the actual encoder batch: the confidence signal
        behind the adaptive auto beam bounds. Cached per parameter set
        (dropped whenever self.params is rebound: load_weights, train)."""
        cached = getattr(self, '_conf_cache', None)
        if cached is not None and cached[0] is self.params:
            return cached[1]
        _, _, length, score, _ = decode_greedy(
            params, self.config, enc[:self._CONF_PROBE_B], newline,
            return_alignments=False)
        score = score[length > 0]
        conf = (float(torch.exp(-score.float().mean())) if score.numel()
                else 1.0)
        self._conf_cache = (self.params, conf)
        self.logger.debug('model confidence probe: %.4f', conf)
        return conf

    def _infer_params(self):
        """Parameters on self.device: float32 masters, or a cached
        bfloat16 copy when self.compute == 'bfloat16'."""
        key = (self.params, self.compute)
        cached = getattr(self, '_infer_cache', None)
        if cached is not None and cached[0][0] is key[0] \
                and cached[0][1] == key[1]:
            return cached[1]
        dtype = torch.bfloat16 if self.compute == 'bfloat16' else None
        params = params_from_numpy(self.params, self.device, dtype)
        self._infer_cache = (key, params)
        return params

    def autotune_fused_decode(self, batches=(16, 32, 64), repeats=8,
                              t=64):
        """Measure the whole-loop decode kernel against the per-op greedy
        decode on this device and set the dispatch window
        ``fused_decode_min_b``..``fused_decode_max_b`` (`_pick_fused_bound`),
        so the dispatched fused regime is >= 1.0x by construction on this
        card rather than a bound carried over from the TPU.

        For each batch size it draws a random (B, t) index batch, calls
        each route once untimed (the first call of the kernel builds its
        library), then times `repeats` calls from one synchronize to the
        next: what a caller of `correct_lines` waits for, host reads
        included. Costs a few seconds; intended for serving set-up
        (``scripts/proc.py --autotune-fused``) and benches.

        Returns {'ratios': {B: per-op time / fused time}, 'chosen': (min_b,
        max_b)}, or None where the fused route does not serve this model
        (float32 compute, a CPU device, widths or depth it does not take).
        """
        if self.compute != 'bfloat16':
            return None
        params = self._infer_params()
        if not fused_greedy_supported(params, self.config, t):
            return None
        newline = self.mapping.get('\n')
        V = self.voc_size
        rng = np.random.default_rng(11)

        def timed(fn, enc):
            fn(enc)
            _synchronize(enc.device)
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn(enc)
            _synchronize(enc.device)
            return time.perf_counter() - t0

        ratios = {}
        for b in batches:
            idx = rng.integers(1, V, size=(b, t)).astype(np.int32)
            enc = torch.from_numpy(idx).to(self.device)
            dt_plain = timed(
                lambda e: decode_greedy(params, self.config, e, newline,
                                        return_alignments=False), enc)
            dt_fused = timed(
                lambda e: decode_greedy_fused(params, self.config, e,
                                              newline), enc)
            ratios[int(b)] = round(dt_plain / dt_fused, 3)
        window = _pick_fused_bound(ratios)
        self.fused_decode_min_b, self.fused_decode_max_b = window
        dropped = _dropped_wins(ratios, window)
        if dropped:
            self.logger.info('fused-decode autotune: the measured wins at '
                             'B = %s lie outside the chosen window %s and '
                             'stay on the per-op decode', dropped, window)
        result = {'ratios': ratios, 'chosen': window}
        self.logger.info('fused-decode autotune: %s', result)
        return result

    def correct_lines(self, lines, conf=None, fast=True, greedy=True,
                      return_alignments=True):
        """Correct text strings (reference seq2seq.py:782-842).

        Returns (output_lines, probability lists, perplexity scores,
        alignments). With `return_alignments=False` the (B, S, T)
        alignments are not materialized; the alignments slot is then a
        list of empty lists. `fast` and `greedy` both mean greedy
        decoding, otherwise the beam search runs.
        """
        assert not fast or greedy, \
            'cannot decode in fast mode with beam search enabled'
        if not lines:
            return [], [], [], []
        B = self.batch_size
        # sort large inputs by source length so each chunk pads to a
        # tight bucket; results are scattered back to input order
        if len(lines) > B:
            order = sorted(range(len(lines)),
                           key=lambda j: self._source_length(
                               lines[j], conf[j] if conf else None))
            inv = [0] * len(lines)
            for pos, j in enumerate(order):
                inv[j] = pos
            sorted_lines = [lines[j] for j in order]
            sorted_conf = [conf[j] for j in order] if conf else None
            res = self._correct_chunks(sorted_lines, sorted_conf, greedy,
                                       return_alignments)
            return tuple([r[inv[j]] for j in range(len(lines))]
                         for r in res)
        return self._correct_chunks(lines, conf, greedy, return_alignments)

    def correct_stream(self, batches, greedy=True,
                       return_alignments=False):
        """Pipeline decoding over an iterator of ``(lines, conf, meta)``
        batches (each at most ``batch_size`` lines; ``meta`` is passed
        through untouched), yielding ``(meta, lines, probs, scores,
        alignments)`` per batch in input order. Up to PIPELINE_DEPTH
        batches are dispatched ahead of the one being fetched."""
        handles = []

        def finish_oldest():
            meta, n, handle = handles.pop(0)
            res = self._finish_batch(handle)
            return (meta, res[0][:n], res[1][:n], res[2][:n], res[3][:n])

        for lines, conf, meta in batches:
            handles.append(
                (meta, *self._dispatch_bucketed(lines, conf, greedy,
                                                return_alignments)))
            if len(handles) > self.PIPELINE_DEPTH:
                yield finish_oldest()
        while handles:
            yield finish_oldest()

    def _dispatch_bucketed(self, lines, conf, greedy, return_alignments):
        """Pad one batch (at most ``batch_size`` lines) to its
        power-of-two bucket and queue its decode; returns ``(n, handle)``."""
        B = self.batch_size
        n = len(lines)
        if n > B:
            raise ValueError('batch larger than batch_size')
        bucket = 8
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, B)
        if n < bucket:
            lines = list(lines) + [''] * (bucket - n)
            if conf:
                conf = list(conf) + [[]] * (bucket - n)
        return n, self._dispatch_batch(lines, conf, greedy,
                                       return_alignments)

    def _correct_chunks(self, lines, conf, greedy, return_alignments=True):
        B = self.batch_size
        chunks = ((lines[i:i + B], conf[i:i + B] if conf else None, None)
                  for i in range(0, len(lines), B))
        out = ([], [], [], [])
        for _, ls, ps, ss, als in self.correct_stream(
                chunks, greedy, return_alignments):
            out[0].extend(ls)
            out[1].extend(ps)
            out[2].extend(ss)
            out[3].extend(als)
        return out

    def _dispatch_batch(self, lines, conf, greedy, return_alignments=True):
        """Run one batch's decode on the device and return a handle
        (device tensors + metadata) without fetching; `_finish_batch`
        fetches and rebuilds host results."""
        if conf and any(conf):
            # per-char confidences / confmats need the dense prob array
            enc, _, _, _ = vectorize_lines(
                self.mapping, lines, ['' for _ in lines], confs=conf,
                logger=self.logger)
        else:
            # plain text ships as a compact (B, T) index batch; the
            # one-hot expansion happens on the device
            enc = lines_to_index_batch(self.mapping, lines,
                                       logger=self.logger)
        T = enc.shape[1]
        enc = torch.from_numpy(enc).to(self.device)
        newline = self.mapping.get('\n')
        params = self._infer_params()
        if not greedy:
            return self._dispatch_beam(lines, conf, enc, T, newline, params,
                                       return_alignments)
        if (self.fused_decode and not return_alignments
                and self.fused_decode_min_b <= enc.shape[0]
                <= self.fused_decode_max_b
                and fused_greedy_supported(params, self.config, T)):
            # small-batch bf16 serving: the whole decode loop in one
            # CUDA kernel launch
            idx, prob, length, score, aligns = decode_greedy_fused(
                params, self.config, enc, newline)
        else:
            # windowed-gather decoding is inherently window-based; a
            # global-attention model (window_width 0) stays on the dense
            # decoder at every length
            decode = (decode_greedy_windowed
                      if T >= WINDOWED_DECODE_MIN_T
                      and self.config.window_width > 0
                      else decode_greedy)
            idx, prob, length, score, aligns = decode(
                params, self.config, enc, newline,
                return_alignments=return_alignments)
        return ('greedy', lines, _pack_results(idx, prob, length, score),
                aligns if return_alignments else None, idx.shape[1])

    def _dispatch_beam(self, lines, conf, enc, T, newline, params,
                       return_alignments):
        """The beam branch of `_dispatch_batch`."""
        src_len = np.array(
            [self._source_length(line, c)
             for line, c in zip(lines, conf or [None] * len(lines))],
            np.int32)
        # adaptive auto bounds: only probe when an auto bound is in play
        confidence = (self._model_confidence(params, enc, newline)
                      if self.beam_reservoir is None
                      or self.beam_expand is None else None)
        out = decode_beam(params, self.config, self._beam_params(confidence),
                          enc, newline, src_len,
                          return_alignments=return_alignments)
        # the best solution of each line, packed into one tensor so the
        # host fetches once; the alignment rows only travel when the
        # caller wants alignments
        f32 = torch.float32
        parts = [out[k][:, 0].to(f32) for k in ('idx', 'prob')]
        if return_alignments:
            parts.append(out['align_start'][:, 0].to(f32))
            parts.append(out['align_row'][:, 0].to(f32).flatten(1))
        parts += [out[k][:, :1].to(f32) for k in ('length', 'cum')]
        parts.append(out['count'][:, None].to(f32))
        return ('beam', lines, torch.cat(parts, dim=1), out['idx'].shape[2],
                T, return_alignments)

    def _finish_batch(self, handle):
        """Fetch a `_dispatch_batch` handle and rebuild host results."""
        if handle[0] == 'beam':
            return self._finish_beam(handle)
        _, lines, packed_dev, aligns_dev, S = handle
        packed = packed_dev.cpu().numpy()
        idx = packed[:, :S].astype(np.int32)
        prob = packed[:, S:2 * S]
        length = packed[:, 2 * S].astype(np.int32)
        score = packed[:, 2 * S + 1]
        return_alignments = aligns_dev is not None
        if return_alignments:
            aligns = aligns_dev.float().cpu().numpy()
        out_lines, out_probs, out_scores, out_aligns = [], [], [], []
        for j in range(len(lines)):
            L = int(length[j])
            text = self._indexes2text(idx[j, :L])
            out_lines.append(text.replace(GAP, ''))
            out_probs.append(prob[j, :L].tolist())
            out_scores.append(float(score[j]))
            out_aligns.append(aligns[j, :L].tolist()
                              if return_alignments else [])
        return out_lines, out_probs, out_scores, out_aligns

    def _finish_beam(self, handle):
        """The beam branch of `_finish_batch`: the best solution of each
        line; an input the beam found no solution for is echoed."""
        _, lines, packed_dev, S, T, return_alignments = handle
        packed = packed_dev.cpu().numpy()
        idx = packed[:, :S].astype(np.int32)
        prob = packed[:, S:2 * S]
        if return_alignments:
            align_start = packed[:, 2 * S:3 * S].astype(np.int32)
            align_row = packed[:, 3 * S:-3].reshape(packed.shape[0], S, -1)
        length = packed[:, -3].astype(np.int32)
        cum = packed[:, -2]
        count = packed[:, -1].astype(np.int32)
        out_lines, out_probs, out_scores, out_aligns = [], [], [], []
        for j, input_line in enumerate(lines):
            if not input_line:
                out_lines.append('')
                out_probs.append([])
                out_scores.append(0)
                out_aligns.append([])
                continue
            if count[j] == 0:
                self.logger.error('cannot beam-decode input line %d: "%s"',
                                  j, input_line)
                text = self._echo_line(input_line)
                out_lines.append(text.replace(GAP, ''))
                out_probs.append([1.0] * len(text))
                out_scores.append(0)
                out_aligns.append(np.eye(len(text)).tolist())
                continue
            L = int(length[j])
            text = self._indexes2text(idx[j, :L])
            out_lines.append(text.replace(GAP, ''))
            out_probs.append(prob[j, :L].tolist())
            out_scores.append(float(cum[j] / max(L, 1)))
            if return_alignments:
                # the windowed soft rows as full (L, T) soft alignment
                # matrices (one-hot rows for rejection steps, raw
                # attention rows otherwise)
                out_aligns.append(_expand_windowed_alignment(
                    align_row[j, :L], align_start[j, :L], T).tolist())
            else:
                out_aligns.append([])
        return out_lines, out_probs, out_scores, out_aligns

    def _indexes2text(self, indexes):
        # bulk index->text via a codepoint LUT + UTF-32 decode; index 0
        # maps to codepoint 0, dropped like the reference's '' entry
        cps = self.mapping.inverse_lut()[np.asarray(indexes,
                                                    dtype=np.int64)]
        return cps.tobytes().decode('utf-32-le').replace('\x00', '')

    @staticmethod
    def _source_length(line, conf=None):
        if conf and isinstance(conf[0], list):  # confmat
            return sum(max((len(alt[0]) for alt in chunk), default=0)
                       for chunk in conf)
        return len(line)

    @staticmethod
    def _echo_line(input_line):
        """Echo an input line as text (the fallback when the beam finds
        no solution, reference seq2seq.py:826-836). Handles plain
        strings, per-char (char, prob) tuple lists and confmat chunk
        lists."""
        if isinstance(input_line, (list, tuple)) and input_line:
            if isinstance(input_line[0], tuple):      # prob line
                return ''.join(chunk[0] for chunk in input_line)
            if isinstance(input_line[0], list):       # confmat
                return ''.join(chunk[0][0] if chunk else ''
                               for chunk in input_line)
        return input_line

    def predict(self, filenames, fast=False, greedy=False, charmap=None):
        """Apply the model to text files, yielding per batch
        (filenames, corrected lines, scores) — reference seq2seq.py:756-780.
        Batches are pipelined through `correct_stream`. The final batch
        is padded with empty lines of no file, as in the reference; only
        its real lines are decoded (so a short file decodes as a batch of
        its own size: the whole-loop kernel's regime), and the padding
        comes back as empty lines of score 0."""
        if self.status != 2:
            raise RuntimeError('load weights before predict')
        assert not fast or greedy, \
            'cannot decode in fast mode with beam search enabled'

        def batches():
            for batch in gen_line_batches(filenames, self.batch_size,
                                          repeat=False, unsupervised=True,
                                          charmap=charmap):
                lines_source, lines_conf, _, lines_filename = batch
                n = lines_filename.index(None) if None in lines_filename \
                    else len(lines_filename)
                yield (lines_source[:n], lines_conf[:n] if lines_conf
                       else None, lines_filename)

        for fnames, lines_result, _, scores_result, _ in \
                self.correct_stream(batches(), greedy=greedy,
                                    return_alignments=False):
            pad = len(fnames) - len(lines_result)
            yield (fnames, lines_result + [''] * pad,
                   scores_result + [0] * pad)

    def evaluate(self, filenames, fast=False, normalization='historic_latin',
                 charmap=None, gt_level=1, confusion=10, histogram=True):
        """Evaluate greedy+beamed CER/WER/perplexity on text files
        (reference seq2seq.py:651-754). Returns a result dict."""
        if self.status != 2:
            raise RuntimeError('load weights before evaluate')
        counts = {k: Edits(self.logger, histogram=histogram and k[0] == 'c')
                  for k in (('c', 'OCR'), ('w', 'OCR'), ('c', 'greedy'),
                            ('w', 'greedy'), ('c', 'beamed'), ('w', 'beamed'))}
        aligners = {k: Alignment(0, logger=self.logger,
                                 confusion=confusion > 0 and k[0] == 'c')
                    for k in counts}
        # pipelined like correct_stream: both decodes of batch k are
        # queued on the device before the host computes the (expensive)
        # alignment metrics of batch k-1, and up to PIPELINE_DEPTH
        # batches run ahead
        pending = []

        def consume_oldest():
            sources, targets, n, handle_g, handle_b = pending.pop(0)
            res = self._finish_batch(handle_g)
            greedy_lines, greedy_scores = res[0][:n], res[2][:n]
            if handle_b is None:
                beamed_lines, beamed_scores = greedy_lines, greedy_scores
            else:
                res = self._finish_batch(handle_b)
                beamed_lines, beamed_scores = res[0][:n], res[2][:n]
            self._evaluate_batch(
                sources, targets, greedy_lines, greedy_scores,
                beamed_lines, beamed_scores, counts, aligners,
                normalization, gt_level)

        for batch in gen_line_batches(filenames, self.batch_size,
                                      repeat=False, charmap=charmap):
            sources, confs, targets, _ = batch
            n, handle_g = self._dispatch_bucketed(sources, confs, True,
                                                  False)
            handle_b = (None if fast else
                        self._dispatch_bucketed(sources, confs, False,
                                                False)[1])
            pending.append((sources, targets, n, handle_g, handle_b))
            if len(pending) > self.PIPELINE_DEPTH:
                consume_oldest()
        while pending:
            consume_oldest()

        result = {}
        self.logger.info('finished %d lines', counts[('c', 'OCR')].steps)
        for kind in ('OCR', 'greedy', 'beamed'):
            c, w = counts[('c', kind)], counts[('w', kind)]
            result[kind] = {
                'cer': c.mean, 'cer_stddev': math.sqrt(c.varia),
                'wer': w.mean, 'wer_stddev': math.sqrt(w.varia),
            }
            if confusion > 0:
                table, _ = aligners[('c', kind)].get_confusion(confusion)
                result[kind]['confusion'] = [
                    (conf.count, conf.pair) for conf in table]
            if histogram:
                result[kind]['histogram'] = c.hist()
            if kind != 'OCR' and c.length:
                result[kind]['perplexity'] = math.exp(c.score / c.length)
            self.logger.info('CER %s: %.3f±%.3f  WER %s: %.3f±%.3f',
                             kind, c.mean, math.sqrt(c.varia),
                             kind, w.mean, math.sqrt(w.varia))
        return result

    def _evaluate_batch(self, sources, targets, greedy_lines,
                        greedy_scores, beamed_lines, beamed_scores,
                        counts, aligners, normalization, gt_level):
        """Accumulate one batch's alignment metrics (the host-side half
        of `evaluate`, reference seq2seq.py:703-736)."""
        for j, (src, tgt) in enumerate(zip(sources, targets)):
            if not src or not tgt:
                continue
            self.logger.info('Source input              : %s',
                             src.rstrip('\n'))
            self.logger.info('Target output             : %s',
                             tgt.rstrip('\n'))
            self.logger.info('Target prediction (greedy): %s [%.2f]',
                             greedy_lines[j].rstrip('\n'),
                             greedy_scores[j])
            self.logger.info('Target prediction (beamed): %s [%.2f]',
                             beamed_lines[j].rstrip('\n'),
                             beamed_scores[j])
            for kind, line in (('OCR', src), ('greedy', greedy_lines[j]),
                               ('beamed', beamed_lines[j])):
                dist, length = aligners[('c', kind)].get_adjusted_distance(
                    line, tgt, normalization=normalization,
                    gtlevel=gt_level)
                counts[('c', kind)].add(dist, length, line, tgt)
                wsrc, wtgt = splitwords(line), splitwords(tgt)
                dist, length = aligners[('w', kind)].get_adjusted_distance(
                    wsrc, wtgt, normalization=normalization,
                    gtlevel=gt_level)
                counts[('w', kind)].add(dist, length, wsrc, wtgt)
        counts[('c', 'greedy')].score += sum(greedy_scores)
        counts[('c', 'beamed')].score += sum(beamed_scores)

    # ------------------------------------------------------------------
    # reference-surface convenience wrappers (lib/seq2seq.py names)

    def vectorize_lines(self, source_lines, target_lines, conf=None):
        """Reference-compatible vectorization (seq2seq.py:1020-1119)."""
        return vectorize_lines(self.mapping, source_lines, target_lines,
                               confs=conf, logger=self.logger)

    def gen_lines(self, filenames, repeat=False, split=None, train=False,
                  unsupervised=False, charmap=None):
        """Reference-compatible line batch generator (seq2seq.py:919)."""
        def is_bad(src, tgt):
            self.aligner.set_seqs(src, tgt)
            return self.aligner.is_bad()
        return gen_line_batches(
            filenames, self.batch_size, repeat=repeat, split=split,
            train=train, unsupervised=unsupervised, charmap=charmap,
            is_bad=is_bad if train else None)

    def decode_batch_greedy(self, encoder_input_data):
        """Reference-compatible greedy batch decode over raw (B, T, V)
        input arrays (seq2seq.py:1215-1286). Returns (texts, probs,
        scores, alignments)."""
        newline = self.mapping.get('\n')
        params = self._infer_params()
        enc = torch.from_numpy(
            np.asarray(encoder_input_data, np.float32)).to(self.device)
        idx, prob, length, score, aligns = decode_greedy(
            params, self.config, enc, newline,
            return_alignments=True)
        idx = idx.cpu().numpy()
        length = length.cpu().numpy()
        prob = prob.float().cpu().numpy()
        aligns = aligns.float().cpu().numpy()
        texts = [self._indexes2text(idx[j, :length[j]])
                 for j in range(idx.shape[0])]
        probs = [prob[j, :length[j]].tolist() for j in range(idx.shape[0])]
        aligns = [aligns[j, :length[j]] for j in range(idx.shape[0])]
        return texts, probs, score.cpu().numpy().tolist(), aligns

    # training is provided by models/train.py (train_model), bound here
    # lazily like in the JAX package
    def train(self, filenames, val_filenames=None, checkpoint_dir='.',
              resume=False):
        """Train on `filenames` on ``self.device`` (reference
        seq2seq.py:590-649); returns the loss history."""
        from .train import train_model
        return train_model(self, filenames, val_filenames,
                           checkpoint_dir=checkpoint_dir, resume=resume)
