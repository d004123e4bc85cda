"""High-level model API mirroring the reference `Sequence2Sequence` class.

Port of the JAX package's ``models/api.py``: configure / load_config /
load_weights / load_transfer_weights / save / map_files / train /
correct_lines / correct_stream / predict / decode_batch_greedy, greedy
decoding only. Beam search and evaluation are not ported yet
(ROADMAP.md Queue A). ``self.params`` is the float32 numpy parameter
tree; serving and training copy it to tensors on ``self.device``.

Decode batches are padded to power-of-two batch buckets and length
buckets (utils/data.py:LENGTH_BUCKETS). The dispatch rule of the JAX
package holds: small bfloat16 batches without alignments go through the
whole-loop CUDA kernel (ops/decode_loop_kernel.py), long buckets through
the windowed decoder, the rest through ``decode_greedy``.
"""

import logging

import numpy as np
import torch

from .. import resolve_device
from ..lib.alignment import Alignment
from ..ops.decode_loop_kernel import (decode_greedy_fused,
                                      fused_greedy_supported)
from ..utils import io_h5
from ..utils.data import (CharMapping, GAP, gen_line_batches,
                          lines_to_index_batch, scan_files,
                          vectorize_lines)
from .config import Seq2SeqConfig, init_params
from .params import params_from_numpy
from .seq2seq import decode_greedy, decode_greedy_windowed

# bucket length from which the windowed-gather decoder is dispatched
# (the JAX package's rule, kept so both packages decode a bucket alike)
WINDOWED_DECODE_MIN_T = 128
# largest batch the whole-loop kernel is dispatched for by default
FUSED_DECODE_MAX_B = 16


def _pack_results(idx, prob, length, score):
    """Concatenate the greedy-decode results into one (B, 2S+2) float32
    tensor, so the host fetches once. Exact: indices < V, probabilities
    and lengths <= S are all well inside float32's integer range."""
    f32 = torch.float32
    return torch.cat([idx.to(f32), prob.to(f32), length[:, None].to(f32),
                      score[:, None].to(f32)], dim=1)


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
        self.rejection_threshold = 0.3
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

    def correct_lines(self, lines, conf=None, fast=True, greedy=True,
                      return_alignments=True):
        """Correct text strings (reference seq2seq.py:782-842).

        Returns (output_lines, probability lists, perplexity scores,
        alignments). With `return_alignments=False` the (B, S, T)
        alignments are not materialized; the alignments slot is then a
        list of empty lists.
        """
        if not greedy:
            raise NotImplementedError(
                'beam search is not ported yet (ROADMAP.md Queue A item 7)')
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
        if not greedy:
            raise NotImplementedError(
                'beam search is not ported yet (ROADMAP.md Queue A item 7)')
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

    def _finish_batch(self, handle):
        """Fetch a `_dispatch_batch` handle and rebuild host results."""
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

    def predict(self, filenames, fast=False, greedy=False, charmap=None):
        """Apply the model to text files, yielding per batch
        (filenames, corrected lines, scores) — reference seq2seq.py:756-780.
        Batches are pipelined through `correct_stream`."""
        if self.status != 2:
            raise RuntimeError('load weights before predict')
        if not greedy:
            raise NotImplementedError(
                'beam search is not ported yet (ROADMAP.md Queue A item 7)')

        def batches():
            for batch in gen_line_batches(filenames, self.batch_size,
                                          repeat=False, unsupervised=True,
                                          charmap=charmap):
                lines_source, lines_conf, _, lines_filename = batch
                yield lines_source, lines_conf, lines_filename

        for fnames, lines_result, _, scores_result, _ in \
                self.correct_stream(batches(), greedy=greedy,
                                    return_alignments=False):
            yield (fnames, lines_result, scores_result)

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
