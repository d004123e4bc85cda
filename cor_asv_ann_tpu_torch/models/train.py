"""Training: train step + autosized-epoch loop.

Port of the JAX package's ``models/train.py``. Reproduces the reference
training regime (lib/seq2seq.py:590-649, lib/keras_train.py:27-296):

- categorical crossentropy with temporal sample weights (Keras semantics:
  sum(loss*w)/count(w != 0); seq2seq.py:491-497),
- Adam with *per-tensor* gradient norm clipping at 5 (Keras `clipnorm`),
  lr 1e-3, eps 1e-7 (added outside the root, which is what both
  ``torch.optim.Adam`` and the JAX package's ``optax.scale_by_adam`` do),
- the underspecification regularizer on the character embedding: pull
  vector 0 to the (gradient-stopped) mean of the others, plus 0.01-weight
  unit-norm penalty on all rows; active in training only
  (seq2seq.py:530-553),
- random encoder degradation: ~1% of lines get one position zeroed to
  index 0 per batch (seq2seq.py:909-915),
- scheduled sampling with linear/sigmoid/exponential ratio curves and
  attenuation 3 (seq2seq.py:859-878); sampled lines get their teacher
  input replaced by the greedy-decoded output (`s2s.keras_sampling = True`
  reproduces the reference's zero-input quirk instead, see
  `_scheduled_sample`),
- epochs are *discovered, not declared*: the generator yields an epoch
  marker, the first epoch measures the step count (keras_train.py:27-296),
- early stopping (patience 3, restore best weights), NaN termination,
  per-epoch weight checkpoints, graceful SIGINT stop
  (seq2seq.py:619-624, lib/callbacks.py:5-33),
- optional LM multi-task loss: a second unconditioned decoder pass with
  tied weights, summed loss (seq2seq.py:321-322, 383-385).

Where the JAX package returns new parameter and optimizer trees from a
step, this one updates them in place: the parameters are a tree of
float32 leaf tensors with ``requires_grad``, the optimizer a
``torch.optim.Adam`` over those leaves. Dropout masks come from a
``torch.Generator``; the host-side draws (validation split, encoder
degradation, scheduled sampling) stay with numpy's global generator.

Over a device mesh (``Sequence2Sequence.use_mesh``, parallel/mesh.py) a
process runs per device and each holds its part: its 'model' slices of
the parameters and of the Adam moments, its 'data' rows of each batch.
What GSPMD makes right for the JAX package is done by hand here: the
loss divides by the global batch's count of weighted positions and
counts the embedding regularizer once, every gradient is summed over
'data' once a step before the per-tensor clipnorm (whose norm is the
full tensor's), dropout masks are the global batch's rows, and every
rank starts from rank 0's numpy generator, so that the host's draws and
early stopping come out alike on every rank.
"""

import functools
import math
import os
import pickle
import signal

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import (gather_params, shard_batch, shard_params,
                             sum_over_data, sync_host_rng)
from ..utils import profiling
from ..utils.data import (gen_line_batches, vectorize_lines,
                          vectorize_lines_indices)
from . import seq2seq
from .config import init_params
from .params import (params_from_numpy, params_to_numpy, tree_leaves,
                     tree_map)
from .seq2seq import decode_greedy, forward_teacher


def clip_per_tensor_norm(grad, max_norm=5.0, sq_norm=None):
    """Keras-style `clipnorm`: clip one gradient tensor to max_norm.
    `sq_norm` is its squared norm where the caller has it (under a mesh,
    the full tensor's rather than this rank's slice's)."""
    if sq_norm is None:
        sq_norm = torch.sum(torch.square(grad))
    norm = torch.sqrt(sq_norm)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return grad * scale


@functools.lru_cache(maxsize=8)
def _full_shapes(config):
    """The parameter tree of `config` as tensors on the 'meta' device:
    the full shapes that `gather_params` compares a rank's slices with."""
    return tree_map(lambda a: torch.empty(a.shape, device='meta'),
                    init_params(config))


def make_optimizer(params, learning_rate=1e-3):
    """Adam over the leaves of `params` (gradients are clipped per
    tensor in `train_step`)."""
    return torch.optim.Adam(tree_leaves(params), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-7)


def optimizer_state(optimizer, params):
    """The Adam state as numpy trees in the layout of `params`:
    ``{'count', 'mu', 'nu'}`` (zeros before the first step)."""
    def moment(key):
        return tree_map(
            lambda p: (optimizer.state[p][key].detach().cpu().numpy().copy()
                       if key in optimizer.state.get(p, {})
                       else np.zeros(tuple(p.shape), np.float32)), params)
    steps = [int(optimizer.state[p]['step']) for p in tree_leaves(params)
             if 'step' in optimizer.state.get(p, {})]
    return dict(count=max(steps, default=0), mu=moment('exp_avg'),
                nu=moment('exp_avg_sq'))


def load_optimizer_state(optimizer, params, state):
    """Restore what `optimizer_state` returned."""
    def put(p, mu, nu):
        optimizer.state[p] = dict(
            step=torch.tensor(float(state['count'])),
            exp_avg=torch.as_tensor(mu).to(p.device, p.dtype).clone(),
            exp_avg_sq=torch.as_tensor(nu).to(p.device, p.dtype).clone())
    tree_map(put, params, state['mu'], state['nu'])


def embedding_regularizer(kernel):
    """Underspecification + unit-norm regularizer (seq2seq.py:530-553)."""
    vec0 = kernel[0]
    vecs = torch.mean(kernel[1:], dim=0).detach()
    underspec = torch.sum(torch.square(vec0 - vecs))
    norms = torch.sum(torch.square(kernel), dim=1)
    lowrank = 0.01 * torch.sum(torch.square(1.0 - norms))
    return underspec + lowrank


def weighted_xent(probs, targets, weights, denom=None):
    """Keras categorical crossentropy with temporal sample weights.

    `targets` may be dense one-hot (B, T, V) or compact indices (B, T)
    with -1 at padding (zero weight there anyway); the index form
    computes the identical -log p of the target character. `denom`
    replaces the batch's count of weighted positions (under a mesh: the
    global batch's, `_global_count`)."""
    eps = 1e-7
    logp = torch.log(torch.clamp(probs, eps, 1.0))
    if targets.dim() == 2:
        idx = torch.clamp(targets, min=0).long()
        ll = -torch.gather(logp, -1, idx[..., None])[..., 0]
        ll = ll * (targets >= 0)
    else:
        ll = -torch.sum(targets * logp, dim=-1)
    if denom is None:
        denom = torch.clamp(torch.sum(weights != 0), min=1)
    return torch.sum(ll * weights) / denom


def _data_loss(out, dec_out, weights, lm_loss, denom=None):
    """Crossentropy over a forward_teacher result; with lm_loss, the sum
    of the conditioned and unconditioned passes (seq2seq.py:383-385)."""
    if lm_loss:
        probs, lm_probs = out
        return (weighted_xent(probs, dec_out, weights, denom)
                + weighted_xent(lm_probs, dec_out, weights, denom))
    return weighted_xent(out, dec_out, weights, denom)


def _global_count(weights, mesh):
    """The count of weighted positions of the whole batch whose rows
    are sharded over the mesh's 'data' axis (one all_reduce), an integer
    like `weighted_xent`'s own."""
    count = torch.sum(weights != 0).reshape(1)
    return torch.clamp(mesh.sum_over(count, 'data')[0], min=1)


def _batch_to(device, *arrays):
    return tuple(torch.as_tensor(a).to(device) for a in arrays)


def loss_fn(params, config, enc, dec_in, dec_out, weights, rng,
            lm_loss=False, mesh=None):
    """Training loss of one batch (tensors on the parameters' device);
    `rng` is the ``torch.Generator`` of the dropout masks, or None.

    With `mesh`, the batch is this rank's rows of a batch sharded over
    its 'data' axis, and the result is this rank's part of the global
    loss: the data loss of its rows over the global batch's count of
    weighted positions, plus the embedding regularizer on the first data
    row only. The parts sum to the global loss, and their gradients to
    its gradient."""
    out = forward_teacher(params, config, enc, dec_in, dropout_rng=rng,
                          train=True, lm=lm_loss)
    if mesh is None:
        loss = _data_loss(out, dec_out, weights, lm_loss)
    else:
        loss = _data_loss(out, dec_out, weights, lm_loss,
                          _global_count(weights, mesh))
        if mesh.data_index:
            return loss
    return loss + embedding_regularizer(params['char_embedding']['kernel'])


def _shard_step_batch(mesh, arrays):
    """This rank's part of a step's batch (`shard_batch`) and the mesh
    over whose 'data' axis it is sharded, or None where every rank holds
    the whole batch."""
    local = shard_batch(arrays, mesh)
    sharded = mesh.local_rows(len(arrays[0])) is not None
    return local, (mesh if sharded else None)


@profiling.traced('training.step')
def train_step(params, optimizer, config, enc, dec_in, dec_out, weights,
               rng, frozen_mask=None, lm_loss=False, compute_dtype=None,
               mesh=None):
    """One optimizer step, IN PLACE on the float32 leaf tensors of
    `params` and on `optimizer`; returns the loss. With
    compute_dtype='bfloat16' the forward and backward run on bfloat16
    copies of the parameters (float32 masters, gradients cast back to
    float32 — standard mixed precision). The batch may be numpy arrays
    or tensors, dense or in index form.

    With `mesh`, `params` and `optimizer` are this rank's
    (`parallel.mesh.shard_params`), and the batch is the whole batch,
    the same on every rank: the step takes the rank's rows
    (`shard_batch`), gathers the full weights over 'model', sums the
    gradients over 'data' (for a sharded batch), clips each by the full
    tensor's norm and updates the rank's slices. The loss returned is
    the global batch's, on every rank."""
    leaves = tree_leaves(params)
    data_mesh = None
    if mesh is None:
        enc, dec_in, dec_out, weights = _batch_to(
            leaves[0].device, enc, dec_in, dec_out, weights)
        used = params
    else:
        (enc, dec_in, dec_out, weights), data_mesh = _shard_step_batch(
            mesh, (enc, dec_in, dec_out, weights))
        used = params if data_mesh is None else sum_over_data(params, mesh)
        used = gather_params(used, _full_shapes(config), mesh)
    if compute_dtype == 'bfloat16':
        used = tree_map(lambda a: a.to(torch.bfloat16)
                        if a.dtype == torch.float32 else a, used)
    old_mesh = seq2seq._TRAIN_MESH
    if mesh is not None:
        seq2seq._TRAIN_MESH = data_mesh
    try:
        with profiling.span('training.forward'):
            loss = loss_fn(used, config, enc, dec_in, dec_out, weights, rng,
                           lm_loss, data_mesh)
        with profiling.span('training.backward'):
            grads = torch.autograd.grad(loss, leaves)
    finally:
        seq2seq._TRAIN_MESH = old_mesh
    with profiling.span('training.update'):
        masks = (tree_leaves(frozen_mask) if frozen_mask is not None
                 else [None] * len(leaves))
        with torch.no_grad():
            grads = [g.float() if m is None else g.float() * m
                     for g, m in zip(grads, masks)]
            sq = ([None] * len(grads) if mesh is None
                  else _full_sq_norms(grads, config, mesh))
            for leaf, grad, s in zip(leaves, grads, sq):
                leaf.grad = clip_per_tensor_norm(grad, sq_norm=s)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
    if data_mesh is None:
        return loss.detach()
    return data_mesh.sum_over(loss.detach().float().reshape(1), 'data')[0]


def _full_sq_norms(grads, config, mesh):
    """The squared norm of each full gradient tensor from this rank's
    slices: summed over 'model' (one all_reduce) for the sharded
    leaves."""
    sq = torch.stack([torch.sum(torch.square(g)) for g in grads])
    full = [tuple(s.shape) for s in tree_leaves(_full_shapes(config))]
    sharded = torch.tensor([tuple(g.shape) != f for g, f in
                            zip(grads, full)], device=sq.device)
    parts = mesh.sum_over(torch.where(sharded, sq, torch.zeros_like(sq)),
                          'model')
    return list(torch.where(sharded, parts, sq))


@torch.no_grad()
def eval_step(params, config, enc, dec_in, dec_out, weights, lm_loss=False,
              mesh=None):
    """The evaluation loss of a batch (no dropout, no regularizer).
    With `mesh`, as in `train_step`: the rank's parameters and the whole
    batch in, the global batch's loss out, on every rank."""
    if mesh is None:
        enc, dec_in, dec_out, weights = _batch_to(
            tree_leaves(params)[0].device, enc, dec_in, dec_out, weights)
        return _data_loss(forward_teacher(params, config, enc, dec_in,
                                          train=False, lm=lm_loss),
                          dec_out, weights, lm_loss)
    (enc, dec_in, dec_out, weights), data_mesh = _shard_step_batch(
        mesh, (enc, dec_in, dec_out, weights))
    params = gather_params(params, _full_shapes(config), mesh)
    out = forward_teacher(params, config, enc, dec_in, train=False,
                          lm=lm_loss)
    if data_mesh is None:
        return _data_loss(out, dec_out, weights, lm_loss)
    loss = _data_loss(out, dec_out, weights, lm_loss,
                      _global_count(weights, data_mesh))
    return data_mesh.sum_over(loss.float().reshape(1), 'data')[0]


def sample_ratio(schedule, epoch, epochs):
    """Scheduled-sampling ratio curves (seq2seq.py:859-878)."""
    attenuation = 3
    if schedule == 'linear':
        # max() guards single-epoch runs (the reference's bare
        # epochs - 1 divides by zero there); ratio is 0 either way
        return attenuation * (epoch - 1) / max(1, epochs - 1)
    if schedule == 'sigmoid':
        return 1 / (1 + math.exp(5 - 10 * attenuation * epoch / epochs))
    if schedule == 'exponential':
        return 1 - 0.9 ** (50 * attenuation * epoch / epochs)
    raise ValueError('unknown scheduled sampling curve %r' % schedule)


def frozen_gradient_mask(params, frozen_layers, depth):
    """1/0 multiplier tree for transfer-frozen layers (reference freezes
    encoder/decoder_lstm_1..depth-1; seq2seq.py:1206-1211)."""
    mask = tree_map(lambda x: 1.0, params)
    for name in frozen_layers:
        kind, _, num = name.rpartition('_')
        n = int(num) - 1
        if kind == 'encoder_lstm':
            mask['encoder'][n] = tree_map(lambda x: 0.0, mask['encoder'][n])
        elif kind == 'decoder_lstm':
            mask['decoder'][n] = tree_map(lambda x: 0.0, mask['decoder'][n])
    return mask


class StopSignal:
    """First SIGINT: stop after the current epoch; second: re-raise
    (reference StopSignalCallback, lib/callbacks.py:5-33)."""

    def __init__(self, logger):
        self.logger = logger
        self.stopping = False
        self._prev = None

    def __enter__(self):
        def handler(sig, frame):
            if self.stopping:
                raise KeyboardInterrupt
            self.logger.info('stopping training at end of epoch '
                             '(interrupt again to abort)')
            self.stopping = True
        try:
            self._prev = signal.signal(signal.SIGINT, handler)
        except ValueError:  # not in main thread
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)
        return False


def _state_path(checkpoint_dir):
    return os.path.join(checkpoint_dir or '.', 'train_state.pkl')


def save_train_state(checkpoint_dir, params, opt_state, epoch, best_loss,
                     best_params, split):
    """Persist the full training state (incl. optimizer moments) for
    resume — a capability the reference lacks. Everything is stored as
    numpy trees (`opt_state` is what `optimizer_state` returns), so the
    file does not depend on a device."""
    state = dict(params=params_to_numpy(params), opt_state=opt_state,
                 epoch=epoch, best_loss=best_loss,
                 best_params=params_to_numpy(best_params), split=split)
    path = _state_path(checkpoint_dir)
    with open(path + '.tmp', 'wb') as f:
        pickle.dump(state, f)
    os.replace(path + '.tmp', path)


def load_train_state(checkpoint_dir):
    """The state `save_train_state` wrote, or None. A pickle: load only
    files this program wrote."""
    path = _state_path(checkpoint_dir)
    if not os.path.exists(path):
        return None
    with open(path, 'rb') as f:
        return pickle.load(f)


def train_model(s2s, filenames, val_filenames=None, checkpoint_dir='.',
                resume=False):
    """Full training orchestration for a Sequence2Sequence instance
    (reference seq2seq.py:590-649) on `s2s.device`. With `resume=True`,
    continue from the train_state.pkl in `checkpoint_dir` (params,
    optimizer moments, epoch counter and validation split are all
    restored).

    When `s2s.mesh` is set (`use_mesh()`), every rank of the mesh runs
    this with the same files: batches sharded over 'data', the wide
    parameter matrices and their Adam moments over 'model' (the
    optimizer state inherits the parameter shardings). Checkpoints and
    train_state.pkl are written by rank 0."""
    logger = s2s.logger
    device = resolve_device(s2s.device)
    mesh = getattr(s2s, 'mesh', None)
    if mesh is not None:
        # every rank draws what rank 0 draws (module docstring)
        sync_host_rng(mesh)
        logger.info('training over mesh %s', mesh.shape)
    num_lines = s2s.map_files(filenames)
    logger.info('Training on %d files with %d lines', len(filenames),
                num_lines)
    if val_filenames:
        s2s.map_files(val_filenames)
        split = None
    else:
        logger.info('Validating on random 20%% of lines')
        split = np.random.uniform(0, 1, (num_lines,))

    config = s2s.config
    train_compute = getattr(s2s, 'train_compute', None)
    if train_compute in ('bf16', 'bfloat16'):
        train_compute = 'bfloat16'
    elif train_compute in (None, 'float32', 'f32'):
        train_compute = None
    else:
        raise ValueError('unknown train_compute %r (use float32 or '
                         'bfloat16)' % (train_compute,))

    def to_leaves(tree):
        placed = (params_from_numpy(tree, device) if mesh is None
                  else shard_params(tree, mesh))
        return tree_map(lambda t: t.requires_grad_(), placed)

    def to_host(tree):
        """The full tree as numpy (gathered over 'model' under a mesh,
        a collective: every rank calls it alike)."""
        if mesh is not None:
            with torch.no_grad():
                tree = gather_params(
                    tree_map(lambda a: torch.as_tensor(a).to(mesh.device),
                             tree), _full_shapes(config), mesh)
        return params_to_numpy(tree)

    def full_params():
        """The parameters to decode with on the host thread."""
        if mesh is None:
            return params
        with torch.no_grad():
            return gather_params(params, _full_shapes(config), mesh)

    writer = mesh is None or mesh.rank == 0
    # float32 masters as leaf tensors; train_step updates them in place
    params = to_leaves(s2s.params)
    learning_rate = getattr(s2s, 'learning_rate', 1e-3)
    optimizer = make_optimizer(params, learning_rate)
    frozen = getattr(s2s, 'frozen_layers', None)
    fmask = (frozen_gradient_mask(params, frozen, config.depth)
             if frozen else None)
    rng = torch.Generator().manual_seed(
        int(np.random.randint(0, 2**31 - 1)))
    newline = s2s.mapping.get('\n')

    def is_bad(src, tgt):
        s2s.aligner.set_seqs(src, tgt)
        return s2s.aligner.is_bad()

    best_loss = np.inf
    # a snapshot on the host: the device tensors change under it
    best_params = to_host(params)
    patience = getattr(s2s, 'patience', 3)  # reference: EarlyStopping(3)
    bad_epochs = 0
    start_epoch = 1
    if resume and checkpoint_dir is not None:
        state = load_train_state(checkpoint_dir)
        if state is not None and not _tree_shapes_match(state['params'],
                                                        s2s.params):
            # a stale train_state.pkl from an unrelated run (different
            # topology/charset) must not be restored — start fresh
            logger.warning('train_state.pkl in %s does not match the '
                           'current model topology; ignoring it',
                           checkpoint_dir)
            state = None
        if state is not None:
            # re-placed on the mesh: each rank takes its slices of the
            # parameters and of the moments
            params = to_leaves(state['params'])
            optimizer = make_optimizer(params, learning_rate)
            opt_state = state['opt_state']
            if mesh is not None:
                opt_state = dict(opt_state,
                                 mu=shard_params(opt_state['mu'], mesh),
                                 nu=shard_params(opt_state['nu'], mesh))
            load_optimizer_state(optimizer, params, opt_state)
            best_loss = state['best_loss']
            best_params = state['best_params']
            start_epoch = state['epoch'] + 1
            if state.get('split') is not None:
                if val_filenames:
                    # explicit validation files: a checkpointed random
                    # split must not be restored (it would misalign
                    # gen_line_batches against this dataset)
                    pass
                elif len(state['split']) != num_lines:
                    logger.warning(
                        'restored validation split covers %d lines but '
                        'the dataset has %d; regenerating the split',
                        len(state['split']), num_lines)
                else:
                    split = state['split']
            logger.info('resuming training from epoch %d '
                        '(best val_loss %.4f)', start_epoch, best_loss)
        else:
            logger.warning('resume requested but no usable '
                           'train_state.pkl in %s', checkpoint_dir)
    history = {'loss': [], 'val_loss': []}
    with StopSignal(logger) as stop:
        for epoch in range(start_epoch, s2s.epochs + 1):
            ratio = (sample_ratio(s2s.scheduled_sampling, epoch, s2s.epochs)
                     if s2s.scheduled_sampling else 0.0)
            losses = []

            def batch_iter():
                """Vectorize batches (on a host thread without a mesh:
                the reference's generator worker processes,
                keras_train.py:133-150). Scheduled sampling decodes with
                the parameters as they stand when the batch is
                prepared."""
                gen = gen_line_batches(filenames, s2s.batch_size,
                                       repeat=False, split=split,
                                       train=True, is_bad=is_bad)
                for batch in gen:
                    if batch is None:
                        return
                    sources, confs, targets, _ = batch
                    enc, dec_in, dec_out, w = _vectorize(
                        s2s.mapping, sources, targets, confs, logger)
                    if ratio > 0:
                        dec_in = _scheduled_sample(
                            full_params(), config, s2s.mapping, enc, dec_in,
                            ratio, newline,
                            keras_quirk=getattr(s2s, 'keras_sampling',
                                                False))
                    batch = (_degrade_encoder(enc), dec_in, dec_out, w)
                    # device placement on the prefetch thread overlaps
                    # the host->device copy with the train step; under a
                    # mesh train_step takes each rank's rows itself
                    yield batch if mesh is not None else _batch_to(device,
                                                                   *batch)

            def step(batch):
                loss = train_step(
                    params, optimizer, config, *batch, rng,
                    frozen_mask=fmask, lm_loss=s2s.lm_loss,
                    compute_dtype=train_compute, mesh=mesh)
                losses.append(float(loss))
                return stop.stopping

            if mesh is None:
                from ..utils.prefetch import prefetch
                with prefetch(batch_iter()) as feed:
                    for batch in feed:
                        if step(batch):
                            break
            else:
                # collectives run in one order on every rank, so none
                # may run on a second host thread (scheduled sampling
                # gathers the parameters): the batches are made here
                for batch in batch_iter():
                    if step(batch):
                        break
            if not losses:
                logger.critical('training failed: no data')
                s2s.status = 1
                return history
            train_loss = float(np.mean(losses))

            val_losses = []
            vgen = gen_line_batches(val_filenames or filenames,
                                    s2s.batch_size, repeat=False,
                                    split=split, train=False)
            for batch in vgen:
                if batch is None:
                    break
                sources, confs, targets, _ = batch
                enc, dec_in, dec_out, w = _vectorize(
                    s2s.mapping, sources, targets, confs, logger)
                val_losses.append(float(eval_step(
                    params, config, enc, dec_in, dec_out, w,
                    lm_loss=s2s.lm_loss, mesh=mesh)))
            val_loss = float(np.mean(val_losses)) if val_losses else train_loss
            history['loss'].append(train_loss)
            history['val_loss'].append(val_loss)
            logger.info('epoch %d loss %.4f val_loss %.4f', epoch,
                        train_loss, val_loss)

            nan_stop = np.isnan(train_loss) or np.isnan(val_loss)
            if not nan_stop and val_loss < best_loss:
                best_loss = val_loss
                best_params = to_host(params)
                bad_epochs = 0
            elif not nan_stop:
                bad_epochs += 1

            if checkpoint_dir is not None:
                host_params = to_host(params)
                opt_state = optimizer_state(optimizer, params)
                opt_state.update(mu=to_host(opt_state['mu']),
                                 nu=to_host(opt_state['nu']))
                if writer:
                    try:
                        from ..utils import io_h5
                        io_h5.save_model(
                            '%s/model.ckpt.weights-%02d-%.2f.h5'
                            % (checkpoint_dir, epoch, val_loss),
                            host_params, config, s2s.mapping)
                        save_train_state(
                            checkpoint_dir, host_params, opt_state, epoch,
                            best_loss, best_params, split)
                    except OSError as err:  # pragma: no cover
                        logger.warning('cannot checkpoint: %s', err)

            if nan_stop:
                logger.warning('NaN loss, terminating')
                break
            if bad_epochs >= patience:
                logger.info('early stopping (patience %d)', patience)
                break
            if stop.stopping:
                break

    s2s.params = best_params
    s2s.status = 2
    logger.info('training finished with val_loss %f', best_loss)
    return history


def _tree_shapes_match(a, b):
    """True when two parameter trees have identical structure and leaf
    shapes (resume-state sanity check)."""
    def shapes(tree):
        return tree_map(lambda x: tuple(x.shape), tree)
    return shapes(a) == shapes(b)


def _vectorize(mapping, sources, targets, confs, logger):
    """Compact index batches for plain text (V times less host->device
    traffic, utils/data.py:vectorize_lines_indices); dense probability
    arrays when per-character confidences are present."""
    if confs is not None and any(confs):
        return vectorize_lines(mapping, sources, targets, confs=confs,
                               logger=logger)
    return vectorize_lines_indices(mapping, sources, targets,
                                   logger=logger)


def _degrade_encoder(enc):
    """Underspecify ~1% of lines' one random position to index 0
    (seq2seq.py:909-915); works on dense (B, T, V) or index (B, T)
    batches.

    Reference-faithful quirks (both forms match the reference's dense
    `eye[0]` assignment exactly): the position is drawn over the PADDED
    batch length, so for short lines most hits land in padding — and a
    padding hit writes a non-zero index-0 row there, un-masking a
    phantom post-EOS step for the encoder of that line."""
    B, T = enc.shape[:2]
    u = np.random.uniform(0, 1, B)
    pos = (T * u / 0.01).astype(int)
    hit = pos < T
    enc = np.array(enc)
    if enc.ndim == 2:
        enc[np.arange(B)[hit], pos[hit]] = 0
        return enc
    V = enc.shape[2]
    enc[np.arange(B)[hit], pos[hit], :] = np.eye(V, dtype=enc.dtype)[0]
    return enc


def _scheduled_sample(params, config, mapping, enc, dec_in, ratio, newline,
                      keras_quirk=False):
    """Replace a random subset of lines' teacher input with the greedy
    decoder's own output, one-hot encoded and shifted right; works on
    dense (B, Td, V) or index (B, Td) teacher batches (numpy arrays;
    `params` is the tensor tree, on whose device the decode runs).

    With `keras_quirk`, sampled lines instead get ZERO teacher input:
    the reference records the greedy feedback through a uint32 buffer
    (seq2seq.py:1236-1252), truncating every softmax score below 1.0 to
    0 — so its sampled lines train against (effectively) empty decoder
    input. The default feeds the one-hot greedy outputs, matching the
    comment-documented intent (seq2seq.py:1251); the flag reproduces
    reference training trajectories bit-for-bit minus the rare exact-1.0
    saturated score."""
    B, Td = dec_in.shape[:2]
    pick = np.random.uniform(0, 1, B) < ratio
    if not pick.any():
        return dec_in
    if keras_quirk:
        if dec_in.ndim == 2:
            return np.where(pick[:, None], -1, dec_in)
        return np.where(pick[:, None, None], 0.0, dec_in)
    device = tree_leaves(params)[0].device
    # runs on the prefetch thread: gradient mode is per thread
    with torch.no_grad():
        idx, _, _, _, _ = decode_greedy(
            params, config, torch.as_tensor(enc).to(device), newline,
            max_steps=Td - 1)
    idx = idx.cpu().numpy()[:, :Td - 1]
    if dec_in.ndim == 2:
        sampled = np.full_like(dec_in, -1)
        sampled[:, 1:] = np.where(idx == 0, -1, idx)
        return np.where(pick[:, None], sampled, dec_in)
    sampled = np.zeros_like(dec_in)
    rows = np.repeat(np.arange(B), Td - 1)
    cols = np.tile(np.arange(1, Td), B)
    sampled[rows, cols, idx.reshape(-1)] = 1.0
    sampled[:, :, 0] = 0  # never feed underspecification
    return np.where(pick[:, None, None], sampled, dec_in)
