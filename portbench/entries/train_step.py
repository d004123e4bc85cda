"""Cells that train: ``models/train.py:train_step``.

The step is driven as ``Sequence2Sequence.train`` → ``train_model``
drives it: the API configures the model (padding masks on, dropout as
the configuration states), the batches go through the API's own
vectorisation and onto the device, and each step is
``train_step(params, optimizer, config, *batch, rng, ...)`` followed by
``float(loss)``. The weights are the benchmark's, made from the seed
(``reference/weights.py:init_weights``). A unit of the window is one
step; the batches cycle through a pool drawn from the seed.

Set-up builds the one training object (parameters, Adam, the dropout
generator) and drives it through its first three steps on three
different batches before warming the remaining length buckets; the
window continues with the same object.

What decides ``correct``: the plain reference (``reference/train.py``,
float32, TF32 off) repeats those three steps from the same weights,
batches (vectorised again from the texts) and dropout masks (drawn again
from the seed in the program's order), and compares, worst leaf first:

- ``loss_gap``: the relative gap of each step's loss;
- ``grad_gap``: the gap between the norms of the first clipped gradient
  (as Adam holds it after step 1), over the larger of the reference
  leaf's norm and the median leaf's;
- ``change_gap``: the same of each parameter's change over the three
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""

import time

import torch

from .. import harness
from ..generators import line_pairs
from ..reference import train as reftrain
from ..reference import weights

CHECK_STEPS = 3


def program_tree(flat):
    """The program's parameter tree (models/config.py) of flat weights."""
    def lstm(prefix):
        return {'kernel': flat[prefix + '_K'],
                'recurrent_kernel': flat[prefix + '_R'],
                'bias': flat[prefix + '_b']}
    return {
        'char_embedding': {'kernel': flat['E']},
        'attention_dense': {'kernel': flat['A']},
        'encoder': [{'fw': lstm('enc1_fw'), 'bw': lstm('enc1_bw')},
                    lstm('enc2')],
        'decoder': [lstm('dec1'),
                    {'cell': lstm('top'), 'W_a': flat['W_a'],
                     'v_a': flat['v_a'], 'b_UW': flat['b_UW'],
                     'b_v': flat['b_v']}],
    }


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

    def setup(self):
        from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
        from cor_asv_ann_tpu_torch.models.train import (
            _batch_to, _vectorize, make_optimizer, train_step)
        from cor_asv_ann_tpu_torch.utils.data import CharMapping
        cfg = self.config
        if self.traffic['generator'] != 'line_pairs':
            raise ValueError('train_step cells take the line_pairs generator')
        if self.workload['compute'] != 'float32':
            raise RuntimeError('this entry trains in float32 only')
        t0 = time.perf_counter()
        s2s = Sequence2Sequence(device=str(self.device))
        s2s.mapping = CharMapping(cfg['charset'])
        s2s.width, s2s.depth = cfg['width'], cfg['depth']
        s2s.dropout = cfg['dropout']
        s2s.batch_size = self.traffic['batch_size']
        s2s.configure()
        if s2s.voc_size != cfg['voc_size']:
            raise RuntimeError('charset gives %d characters, the '
                               'configuration states %d'
                               % (s2s.voc_size, cfg['voc_size']))
        self.model_config = s2s.config
        self.init = weights.init_weights(cfg['voc_size'], cfg['width'],
                                         self.seed, self.device)
        flat = {k: v.clone().requires_grad_() for k, v in self.init.items()}
        self.flat = flat
        self.params = program_tree(flat)
        self.optimizer = make_optimizer(self.params, cfg['learning_rate'])
        self.dropout_seed = self.seed % (2 ** 63 - 1)
        self.rng = torch.Generator().manual_seed(self.dropout_seed)
        self.phases = {'model': time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.texts = line_pairs.batches(self.traffic, self.seed,
                                        self.workload['batches'])
        self.batches = []
        for pairs in self.texts:
            src, tgt = zip(*pairs)
            enc, dec_in, dec_out, w = _vectorize(s2s.mapping, list(src),
                                                 list(tgt), None, s2s.logger)
            self.batches.append(_batch_to(self.device, enc, dec_in,
                                          dec_out, w))
        self.train_step = train_step
        self.phases['batches'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the check's three steps, then one step in each length bucket
        # not seen yet
        self.check_losses = []
        for k in range(CHECK_STEPS):
            self.check_losses.append(float(self._step(k)))
            if k == 0:
                # Adam's first moment after one step is 0.1 g (none: the
                # optimizer got no gradient)
                self.first_grads = {
                    n: (self.optimizer.state[v].get(
                        'exp_avg', torch.zeros_like(v)) / 0.1).detach()
                    .clone() for n, v in flat.items()}
        self.after = {n: v.detach().clone() for n, v in flat.items()}
        seen = {self._shape(k) for k in range(CHECK_STEPS)}
        for k in range(CHECK_STEPS, len(self.batches)):
            if self._shape(k) not in seen:
                seen.add(self._shape(k))
                float(self._step(k))
        self.phases['steps'] = time.perf_counter() - t0
        self.next = 0

    def _shape(self, k):
        return tuple(self.batches[k][0].shape) + tuple(
            self.batches[k][1].shape)

    def _step(self, k):
        return self.train_step(self.params, self.optimizer,
                               self.model_config, *self.batches[k], self.rng,
                               frozen_mask=None, lm_loss=False,
                               compute_dtype=None, mesh=None)

    def run_unit(self, traced):
        k = (CHECK_STEPS + self.next) % len(self.batches)
        self.next += 1
        with self.spans.span('train_step', traced=traced):
            loss = float(self._step(k))
        t0, t1 = self.spans.items[-1]['t0'], self.spans.items[-1]['t1']
        texts = self.texts[k]
        rec = dict(index=k, traced=traced, t0=t0, t1=t1, loss=loss,
                   src_lens=[len(s) for s, _ in texts],
                   tgt_lens=[len(t) for _, t in texts])
        self.records.append(rec)
        return rec

    def free(self):
        self.params = self.optimizer = self.flat = self.batches = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, tf32=False):
        return reftrain.run_steps(
            self.init, self.config, self.texts[:CHECK_STEPS],
            self.dropout_seed, self.device, tf32=tf32)

    def readings(self, losses, first_grads, after):
        ref = self.reference()
        return reftrain.compare(ref, self.init, losses, first_grads, after)

    def check(self):
        got = self.readings(self.check_losses, self.first_grads, self.after)
        limits = self.workload['check']['limits']
        return [dict(name=k, value=got[k], limit=limits[k])
                for k in ('loss_gap', 'grad_gap', 'change_gap')], \
            dict(leaves_compared=got['leaves_compared'],
                 check_losses=self.check_losses)

    def control(self):
        """The reference in TF32 put in the program's place."""
        low = self.reference(tf32=True)
        ref = self.reference()
        return reftrain.compare(ref, self.init, low['losses'],
                                low['first_grads'], low['after'])
