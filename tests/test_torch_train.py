"""PyTorch port: teacher forcing, loss, gradients and optimizer steps
against the JAX package.

A tiny d2/w16 model in float32, parameters from the JAX package's
``init_params`` through ``params_from_numpy``; the same numpy batches go
through both packages. Dropout is 0 wherever the two are compared (their
random streams cannot agree). With the JAX package's
``_FUSED_TRAIN_SCAN`` and the port's ``_FUSED_SCAN`` 'on' the JAX side
runs its Pallas scan kernels in interpret mode for training and the port
runs the plain versions of its CUDA kernels through ``LstmScan``.

Tolerances: forward 1e-5 (float32 sums in another order); loss and
gradients rtol 1e-4 / atol 1e-5 (the bar of tests/test_fused_scan.py::
test_train_step_with_fused_scan); parameters and Adam moments after
three steps 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cor_asv_ann_tpu.models import seq2seq as JS
from cor_asv_ann_tpu.models import train as JT
from cor_asv_ann_tpu.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu.ops import lstm as JL
from cor_asv_ann_tpu.utils import data as jdata
from cor_asv_ann_tpu_torch.models import seq2seq as PS
from cor_asv_ann_tpu_torch.models import train as PT
from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                 params_to_numpy,
                                                 tree_leaves, tree_map)
from cor_asv_ann_tpu_torch.ops import lstm as PL
from cor_asv_ann_tpu_torch.utils import data as tdata
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

MAPPING = jdata.CharMapping.from_texts(["abcdefgh .,\n"])
SOURCES = ["abba dig.\n", "hi.\n", "deaf bad cab.\n", "gag.\n",
           "fed a cab, bed\n"]
TARGETS = ["abba dig.\n", "hi,\n", "deaf bad cab.\n",
           "gag,\n", "fed a cab bed\n"]


def _config(**kw):
    kw.setdefault('dropout', 0.0)
    return Seq2SeqConfig(width=16, depth=kw.pop('depth', 2),
                         voc_size=MAPPING.voc_size, **kw)


def _batch(dense=False):
    if dense:
        return jdata.vectorize_lines(MAPPING, SOURCES, TARGETS)
    return jdata.vectorize_lines_indices(MAPPING, SOURCES, TARGETS)


def _leaves(tree):
    """Float32 leaf tensors with requires_grad, on the CPU."""
    return tree_map(lambda t: t.requires_grad_(),
                    params_from_numpy(tree, 'cpu'))


@pytest.fixture
def fused_scan(monkeypatch):
    """Switch the whole-sequence scan on or off in both packages (the JAX
    flag is read when a function is traced)."""
    def set_mode(mode):
        monkeypatch.setattr(JS, '_FUSED_TRAIN_SCAN', mode)
        monkeypatch.setattr(PS, '_FUSED_SCAN', mode)
        jax.clear_caches()
    yield set_mode
    jax.clear_caches()


def _assert_trees_close(got, want, **tol):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_index_vectorizer_matches_jax_package():
    for a, b in zip(_batch(),
                    tdata.vectorize_lines_indices(MAPPING, SOURCES, TARGETS)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('mask_padding', [False, True],
                         ids=['keras_padding', 'mask_padding'])
@pytest.mark.parametrize('lm', [False, True], ids=['plain', 'lm'])
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_forward_teacher_matches(fused_scan, mask_padding, lm, train):
    fused_scan('on')
    config = _config(mask_padding=mask_padding)
    params = init_params(config, seed=5)
    enc, dec_in, _, _ = _batch()
    want = JS.forward_teacher(params, config, enc, dec_in, train=train,
                              lm=lm)
    with torch.no_grad():
        got = PS.forward_teacher(params_from_numpy(params, 'cpu'), config,
                                 torch.from_numpy(enc),
                                 torch.from_numpy(dec_in), train=train,
                                 lm=lm)
    if not lm:
        got, want = (got,), (want,)
    assert len(got) == len(want) == (2 if lm else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_forward_teacher_dense_input_and_deep_topology(fused_scan):
    """Dense (B, T, V) batches, three layers with residual connections,
    bridges and the deep bidirectional encoder."""
    fused_scan('on')
    config = _config(depth=3, residual_connections=True, bridge_dense=True,
                     deep_bidirectional_encoder=True, mask_padding=False)
    params = init_params(config, seed=6)
    enc, dec_in, _, _ = _batch(dense=True)
    want = JS.forward_teacher(params, config, enc, dec_in, train=True)
    with torch.no_grad():
        got = PS.forward_teacher(params_from_numpy(params, 'cpu'), config,
                                 torch.from_numpy(enc),
                                 torch.from_numpy(dec_in), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_cell_preact_with_masks(dtype):
    """The same numpy-made dropout masks through both packages: one
    rounding of the float32 sum of all five products."""
    rng = np.random.default_rng(0)
    B, D, W = 5, 24, 8
    cell = {'kernel': rng.standard_normal((D, 4 * W)).astype(np.float32) * .3,
            'recurrent_kernel':
                rng.standard_normal((W, 4 * W)).astype(np.float32) * .3,
            'bias': rng.standard_normal(4 * W).astype(np.float32) * .1}
    cell_in = rng.standard_normal((B, D)).astype(np.float32)
    h = rng.standard_normal((B, W)).astype(np.float32) * .5
    masks = ((rng.uniform(size=(4, B, D)) < 0.8) / 0.8).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    for m in (masks, None):
        want = JL.attention_cell_preact(
            {k: jnp.asarray(v).astype(jdt) for k, v in cell.items()},
            jnp.asarray(cell_in), jnp.asarray(h).astype(jdt),
            None if m is None else jnp.asarray(m))
        got = PL.attention_cell_preact(
            {k: torch.from_numpy(v).to(tdt) for k, v in cell.items()},
            torch.from_numpy(cell_in), torch.from_numpy(h).to(tdt),
            None if m is None else torch.from_numpy(m))
        assert got.dtype == tdt
        tol = (dict(rtol=1e-5, atol=1e-6) if dtype == 'float32'
               else dict(rtol=2e-2, atol=2e-2))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize('dense', [False, True], ids=['index', 'onehot'])
def test_weighted_xent_matches(dense):
    rng = np.random.default_rng(1)
    _, _, dec_out, w = _batch(dense)
    B, Td = dec_out.shape[:2]
    probs = rng.dirichlet(np.ones(MAPPING.voc_size), (B, Td)).astype(
        np.float32)
    probs[0, 0] = 0.0           # clipped at 1e-7 on both sides
    want = float(JT.weighted_xent(jnp.asarray(probs), jnp.asarray(dec_out),
                                  jnp.asarray(w)))
    got = float(PT.weighted_xent(torch.from_numpy(probs),
                                 torch.from_numpy(dec_out),
                                 torch.from_numpy(w)))
    assert got == pytest.approx(want, rel=1e-6)
    # an all-padding batch divides by 1, not by 0
    zero = PT.weighted_xent(torch.from_numpy(probs),
                            torch.from_numpy(dec_out),
                            torch.zeros(B, Td))
    assert float(zero) == 0.0


def test_embedding_regularizer_value_and_detached_mean():
    rng = np.random.default_rng(2)
    k = rng.standard_normal((7, 5)).astype(np.float32)
    want, jgrad = jax.value_and_grad(JT.embedding_regularizer)(
        jnp.asarray(k))
    kt = torch.from_numpy(k).requires_grad_()
    got = PT.embedding_regularizer(kt)
    (tgrad,) = torch.autograd.grad(got, kt)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    # equal gradients show that the mean of the other rows is detached
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('schedule', ['linear', 'sigmoid', 'exponential'])
def test_sample_ratio_matches(schedule):
    for epoch, epochs in ((1, 1), (1, 10), (4, 10), (10, 10)):
        assert PT.sample_ratio(schedule, epoch, epochs) == \
            JT.sample_ratio(schedule, epoch, epochs)
    with pytest.raises(ValueError):
        PT.sample_ratio('cubic', 1, 2)


@pytest.mark.parametrize('mask_padding', [False, True],
                         ids=['keras_padding', 'mask_padding'])
@pytest.mark.parametrize('lm_loss', [False, True], ids=['plain', 'lm'])
def test_loss_and_gradients_match(fused_scan, mask_padding, lm_loss):
    """Every gradient leaf against jax.value_and_grad(loss_fn), the scans
    of both sides through their whole-sequence kernels' CPU forms."""
    fused_scan('on')
    config = _config(mask_padding=mask_padding)
    params = init_params(config, seed=7)
    batch = _batch()
    want_loss, want_grads = jax.value_and_grad(JT.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), config, *batch,
        jax.random.PRNGKey(0), lm_loss)
    pt = _leaves(params)
    loss = PT.loss_fn(pt, config, *(torch.from_numpy(a) for a in batch),
                      None, lm_loss)
    grads = torch.autograd.grad(loss, tree_leaves(pt))
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                  rel=1e-5)
    _assert_trees_close(list(grads), want_grads, rtol=1e-4, atol=1e-5)


def test_gradients_same_with_and_without_fused_scan(fused_scan):
    """LstmScan's hand-written backward against autograd through the
    step-by-step scan, inside the whole model."""
    config = _config(mask_padding=False)
    params = init_params(config, seed=8)
    batch = [torch.from_numpy(a) for a in _batch()]
    grads = {}
    for mode in ('on', 'off'):
        fused_scan(mode)
        pt = _leaves(params)
        loss = PT.loss_fn(pt, config, *batch, None)
        grads[mode] = torch.autograd.grad(loss, tree_leaves(pt))
    for a, b in zip(grads['on'], grads['off']):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_masked_train_step_same_with_and_without_fused_scan(fused_scan):
    """A mask_padding model with dropout: its encoder's masked scans
    through LstmScan (plain K4/K5 with the mask) against the step-by-step
    masked lstm_scan under autograd: the loss, every gradient and every
    leaf after two train_steps."""
    config = _config(mask_padding=True, dropout=0.2)
    params = init_params(config, seed=14)
    batch = [torch.from_numpy(a) for a in _batch()]
    got = {}
    for mode in ('on', 'off'):
        fused_scan(mode)
        pt = _leaves(params)
        loss = PT.loss_fn(pt, config, *batch,
                          torch.Generator().manual_seed(3))
        grads = torch.autograd.grad(loss, tree_leaves(pt))
        opt = PT.make_optimizer(pt, 1e-2)
        gen = torch.Generator().manual_seed(4)
        losses = [float(PT.train_step(pt, opt, config, *batch, gen))
                  for _ in range(2)]
        got[mode] = float(loss.detach()), grads, losses, tree_leaves(pt)
    on, off = got['on'], got['off']
    assert on[0] == pytest.approx(off[0], rel=1e-5)
    assert on[2] == pytest.approx(off[2], rel=1e-5)
    for a, b in zip(on[1], off[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(on[3], off[3]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dense', [False, True], ids=['index', 'onehot'])
def test_three_train_steps_match_optax(fused_scan, dense):
    """Same tree, same batches: parameters and Adam moments after three
    steps of clipnorm-5 Adam (eps 1e-7 outside the root on both sides)."""
    fused_scan('on')
    config = _config(mask_padding=False)
    params = init_params(config, seed=9)
    batch = _batch(dense)
    opt = JT.make_optimizer(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    pt = _leaves(params)
    topt = PT.make_optimizer(pt, 1e-3)
    for _ in range(3):
        jp, jstate, jloss = JT.train_step(
            jp, jstate, config, *batch, jax.random.PRNGKey(0),
            lm_loss=False, optimizer=opt)
        tloss = PT.train_step(pt, topt, config, *batch, None)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    state = PT.optimizer_state(topt, pt)
    assert state['count'] == int(adam.count) == 3
    _assert_trees_close(params_to_numpy(pt), jp, rtol=1e-5, atol=1e-5)
    _assert_trees_close(state['mu'], adam.mu, rtol=1e-4, atol=1e-7)
    _assert_trees_close(state['nu'], adam.nu, rtol=1e-4, atol=1e-9)


def test_train_step_leaves_the_numpy_tree_alone(fused_scan):
    """The step works in place on the tensors; they must not share memory
    with the numpy tree they were made from (on the CPU
    ``torch.from_numpy`` alone would)."""
    fused_scan('off')
    config = _config()
    params = init_params(config, seed=9)
    kept = jax.tree_util.tree_map(np.copy, params)
    pt = _leaves(params)
    PT.train_step(pt, PT.make_optimizer(pt, 1e-2), config, *_batch(), None)
    changed = False
    for a, b, t in zip(jax.tree_util.tree_leaves(params),
                       jax.tree_util.tree_leaves(kept), tree_leaves(pt)):
        np.testing.assert_array_equal(a, b)
        changed |= not np.array_equal(t.detach().numpy(), b)
    assert changed


def test_clipnorm_is_per_tensor():
    g = torch.full((10, 10), 3.0)             # norm 30
    np.testing.assert_allclose(
        float(torch.linalg.norm(PT.clip_per_tensor_norm(g))), 5.0, rtol=1e-6)
    small = torch.full((2,), 0.1)
    assert torch.equal(PT.clip_per_tensor_norm(small), small)
    assert torch.equal(PT.clip_per_tensor_norm(torch.zeros(3)),
                       torch.zeros(3))


def test_bf16_steps_are_finite_and_converge(fused_scan):
    fused_scan('on')
    config = _config(mask_padding=False)
    pt = _leaves(init_params(config, seed=10))
    opt = PT.make_optimizer(pt, 1e-2)
    batch = _batch()
    losses = [float(PT.train_step(pt, opt, config, *batch, None,
                                  compute_dtype='bfloat16'))
              for _ in range(12)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1
    # float32 masters stay float32, gradients are dropped after the step
    assert all(t.dtype == torch.float32 and t.grad is None
               for t in tree_leaves(pt))


def test_frozen_mask_holds_layers(fused_scan):
    fused_scan('off')
    config = _config()
    params = init_params(config, seed=11)
    pt = _leaves(params)
    mask = PT.frozen_gradient_mask(pt, ['encoder_lstm_1', 'decoder_lstm_1'],
                                   config.depth)
    jmask = JT.frozen_gradient_mask(params,
                                    ['encoder_lstm_1', 'decoder_lstm_1'],
                                    config.depth)
    assert tree_leaves(mask) == [float(m) for m in
                                 jax.tree_util.tree_leaves(jmask)]
    opt = PT.make_optimizer(pt, 1e-2)
    PT.train_step(pt, opt, config, *_batch(), None, frozen_mask=mask)
    after = params_to_numpy(pt)
    for name, n, frozen in (('encoder', 0, True), ('decoder', 0, True),
                            ('encoder', 1, False), ('decoder', 1, False)):
        same = all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(after[name][n]),
            jax.tree_util.tree_leaves(params[name][n])))
        assert same == frozen, (name, n)


def test_dropout_masks_follow_the_generator():
    config = _config(dropout=0.5)
    pt = params_from_numpy(init_params(config, seed=12), 'cpu')
    enc, dec_in, _, _ = (torch.from_numpy(a) for a in _batch())

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return PS.forward_teacher(pt, config, enc, dec_in,
                                      dropout_rng=gen, train=True)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), run(None))
    # keras_dropout: one mask row for the whole batch
    out = torch.ones(4, 3, 64)
    gen = torch.Generator().manual_seed(0)
    shared = PS._variational_dropout(
        out, _config(dropout=0.5, keras_dropout=True), gen)
    assert torch.equal(shared[0], shared[3])
    assert set(shared.unique().tolist()) == {0.0, 2.0}
    own = PS._variational_dropout(out, config, gen)
    assert not torch.equal(own[0], own[3])
    assert torch.equal(own[:, 0], own[:, 2])      # constant over time


@pytest.mark.parametrize('dense', [False, True], ids=['index', 'onehot'])
def test_degrade_encoder_matches(dense):
    enc = _batch(dense)[0]
    big = np.concatenate([enc] * 60)    # ~1% of 300 lines get hit
    np.random.seed(3)
    want = JT._degrade_encoder(big)
    np.random.seed(3)
    got = PT._degrade_encoder(big)
    np.testing.assert_array_equal(got, want)
    assert (got != big).any() and got is not big


@pytest.mark.parametrize('dense', [False, True], ids=['index', 'onehot'])
@pytest.mark.parametrize('quirk', [False, True], ids=['greedy', 'keras'])
def test_scheduled_sample_matches(dense, quirk):
    config = _config()
    params = init_params(config, seed=13)
    # sharpen the readout so greedy picks have margins above float noise
    params['char_embedding']['kernel'] = \
        params['char_embedding']['kernel'] * 300.0
    enc, dec_in, _, _ = _batch(dense)
    newline = MAPPING.get('\n')
    np.random.seed(4)
    want = JT._scheduled_sample(params, config, MAPPING, enc, dec_in, 0.6,
                                newline, keras_quirk=quirk)
    np.random.seed(4)
    got = PT._scheduled_sample(_leaves(params), config, MAPPING, enc,
                               dec_in, 0.6, newline, keras_quirk=quirk)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got != dec_in).any()
    np.random.seed(4)
    assert PT._scheduled_sample(None, config, MAPPING, enc, dec_in, 0.0,
                                newline) is dec_in


def test_checkpoint_resume_continues_identically(fused_scan, tmp_path):
    """Two steps, save, reload into fresh tensors, one more step: the
    same parameters as three uninterrupted steps."""
    fused_scan('off')
    config = _config()
    params = init_params(config, seed=14)
    batch = _batch()
    straight = _leaves(params)
    opt = PT.make_optimizer(straight, 1e-2)
    for _ in range(3):
        PT.train_step(straight, opt, config, *batch, None)

    first = _leaves(params)
    opt = PT.make_optimizer(first, 1e-2)
    for _ in range(2):
        PT.train_step(first, opt, config, *batch, None)
    split = np.linspace(0, 1, 7)
    PT.save_train_state(str(tmp_path), first,
                        PT.optimizer_state(opt, first), 2, 0.5, first, split)
    state = PT.load_train_state(str(tmp_path))
    assert state['epoch'] == 2 and state['best_loss'] == 0.5
    np.testing.assert_array_equal(state['split'], split)
    assert all(isinstance(a, np.ndarray) for key in ('params', 'best_params')
               for a in tree_leaves(state[key]))
    assert all(isinstance(a, np.ndarray)
               for key in ('mu', 'nu')
               for a in tree_leaves(state['opt_state'][key]))
    assert PT._tree_shapes_match(state['params'], first)
    resumed = _leaves(state['params'])
    opt2 = PT.make_optimizer(resumed, 1e-2)
    PT.load_optimizer_state(opt2, resumed, state['opt_state'])
    PT.train_step(resumed, opt2, config, *batch, None)
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert PT.load_train_state(str(tmp_path / 'nowhere')) is None
    other = init_params(_config(depth=3), seed=0)
    assert not PT._tree_shapes_match(state['params'], other)


def test_eval_step_is_the_data_loss(fused_scan):
    fused_scan('off')
    config = _config()
    params = init_params(config, seed=15)
    batch = _batch()
    want = float(JT.eval_step(jax.tree_util.tree_map(jnp.asarray, params),
                              config, *batch))
    got = PT.eval_step(params_from_numpy(params, 'cpu'), config, *batch)
    assert not got.requires_grad
    assert float(got) == pytest.approx(want, rel=1e-5)
