"""PyTorch port: the dispatch of the teacher-forced top layer
(``seq2seq._decode_teacher``) against the JAX package.

A tiny d2 model in float32, parameters from the JAX package's
``init_params``, dropout 0 wherever the two packages are compared (their
random streams cannot agree). Each forced route runs in both packages:
``_TEACHER_KERNEL = 'on'`` (JAX: the Pallas kernels in interpret mode, or
for a mask_padding model, whose padding mask they do not take, its dense
body; port: the plain versions of K6/K7 through ``TeacherTopFused``, with
the padding mask),
``_TEACHER_ATTENTION = 'windowed'`` with and without ``_TEACHER_VJP =
'on'``, and the dense forward of the hand-written backward. Loss and
every gradient leaf agree at rtol 1e-4 / atol 1e-5 (the bar of
tests/test_torch_train.py), through the fused kernels at rtol 2e-3 /
atol 2e-4 (the bar of tests/test_teacher_kernel.py).

The dispatch tests mirror tests/test_teacher_kernel.py,
tests/test_teacher_vjp.py and tests/test_teacher_windowed.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models import seq2seq as JS
from cor_asv_ann_tpu.models import train as JT
from cor_asv_ann_tpu.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models import seq2seq as PS
from cor_asv_ann_tpu_torch.models import train as PT
from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                 tree_leaves, tree_map)
from cor_asv_ann_tpu_torch.ops import teacher_kernel as TK
from cor_asv_ann_tpu_torch.utils import profiling
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

FLAGS = ('_TEACHER_KERNEL', '_TEACHER_ATTENTION', '_TEACHER_VJP')


def _setup(mask_padding=False, seed=3, B=4, T=12, V=14, W=8, **kw):
    rng = np.random.default_rng(seed)
    config = Seq2SeqConfig(width=W, depth=2, voc_size=V, dropout=0.0,
                           mask_padding=mask_padding, **kw)
    params = init_params(config, seed=seed)
    idx = rng.integers(1, V, size=(B, T))
    enc = np.zeros((B, T, V), np.float32)
    enc[np.arange(B)[:, None], np.arange(T)[None, :], idx] = 1.0
    if mask_padding:
        enc[-1, T // 2:] = 0.0     # one short line exercises the mask
    dec_in = np.zeros((B, T + 1, V), np.float32)
    dec_in[:, 1:] = enc
    dec_out = np.concatenate([enc, np.zeros((B, 1, V), np.float32)], axis=1)
    weights = (dec_out.sum(-1) > 0).astype(np.float32)
    return config, params, (enc, dec_in, dec_out, weights)


@pytest.fixture
def flags(monkeypatch):
    """Set the teacher dispatch flags in both packages (the JAX ones are
    read when a function is traced)."""
    def set_flags(**values):
        for name in FLAGS:
            value = values.get(name.lower().lstrip('_'), 'auto')
            monkeypatch.setattr(JS, name, value)
            monkeypatch.setattr(PS, name, value)
        jax.clear_caches()
    yield set_flags
    jax.clear_caches()


def _leaves(tree):
    return tree_map(lambda t: t.requires_grad_(),
                    params_from_numpy(tree, 'cpu'))


def _loss_and_grads_both(config, params, batch, lm_loss=False):
    want_loss, want_grads = jax.value_and_grad(JT.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), config, *batch,
        jax.random.PRNGKey(0), lm_loss)
    pt = _leaves(params)
    loss = PT.loss_fn(pt, config, *(torch.from_numpy(a) for a in batch),
                      None, lm_loss)
    grads = torch.autograd.grad(loss, tree_leaves(pt))
    return (float(loss.detach()), grads, float(want_loss),
            jax.tree_util.tree_leaves(want_grads))


def _assert_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize('lm_loss,mask_padding', [
    pytest.param(lm, mp, id=('lm' if lm else 'plain')
                 + ('-mask_padding' if mp else ''))
    for mp in (False, True) for lm in (False, True)])
def test_loss_and_gradients_match_with_kernel_on(flags, lm_loss,
                                                 mask_padding):
    """forward_teacher(train=True) through the fused teacher layer in
    both packages (mask_padding: the port's with the padding mask, the
    JAX package's dense body)."""
    flags(teacher_kernel='on')
    config, params, batch = _setup(mask_padding)
    calls = TK.teacher_fwd.launches, TK.teacher_bwd.launches
    loss, grads, want_loss, want_grads = _loss_and_grads_both(
        config, params, batch, lm_loss)
    # CPU tensors: the plain versions ran, no launch was counted
    assert (TK.teacher_fwd.launches, TK.teacher_bwd.launches) == calls
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_close(grads, want_grads, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize('mask_padding', [False, True],
                         ids=['keras_padding', 'mask_padding'])
@pytest.mark.parametrize('vjp', ['on', 'off'])
def test_loss_and_gradients_match_windowed(flags, mask_padding, vjp):
    """The windowed route, with the hand-written backward and with
    autograd through the windowed body."""
    flags(teacher_kernel='off', teacher_attention='windowed',
          teacher_vjp=vjp)
    config, params, batch = _setup(mask_padding)
    loss, grads, want_loss, want_grads = _loss_and_grads_both(
        config, params, batch)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_close(grads, want_grads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('mask_padding', [False, True],
                         ids=['keras_padding', 'mask_padding'])
def test_loss_and_gradients_match_dense_forward_vjp(flags, mask_padding):
    """Below the windowed threshold a forced _TEACHER_VJP takes the
    dense forward of teacher_top_scan in both packages."""
    flags(teacher_kernel='off', teacher_vjp='on')
    config, params, batch = _setup(mask_padding)
    loss, grads, want_loss, want_grads = _loss_and_grads_both(
        config, params, batch)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_close(grads, want_grads, rtol=1e-4, atol=1e-5)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(PS, name)

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(PS, name, spy)
    return calls


def _forward(config, params, batch, train, rng=None):
    with torch.no_grad():
        return PS.forward_teacher(
            params_from_numpy(params, 'cpu'), config,
            torch.from_numpy(batch[0]), torch.from_numpy(batch[1]),
            dropout_rng=rng, train=train)


def test_kernel_dispatch_engages_for_training_only(flags, monkeypatch):
    """_TEACHER_KERNEL='on' routes training through the fused layer, with
    or without a padding mask; eval, 'off' and global attention stay on
    the other routes."""
    config, params, batch = _setup(B=2, T=6)
    calls = _spy(monkeypatch, 'teacher_top_fused')
    flags(teacher_kernel='on')
    _forward(config, params, batch, train=False)
    assert not calls
    p_kernel = _forward(config, params, batch, train=True)
    assert len(calls) == 1
    flags(teacher_kernel='off')
    p_ref = _forward(config, params, batch, train=True)
    assert len(calls) == 1
    np.testing.assert_allclose(p_kernel.numpy(), p_ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    flags(teacher_kernel='on')
    masked, mparams, mbatch = _setup(mask_padding=True, B=2, T=6)
    pm_kernel = _forward(masked, mparams, mbatch, train=True)
    assert len(calls) == 2
    flags(teacher_kernel='off')
    pm_ref = _forward(masked, mparams, mbatch, train=True)
    assert len(calls) == 2
    np.testing.assert_allclose(pm_kernel.numpy(), pm_ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    flags(teacher_kernel='on')
    _forward(dataclasses.replace(config, window_width=0), params, batch,
             train=True)
    flags(teacher_kernel='on', teacher_attention='dense')
    _forward(config, params, batch, train=True)
    assert len(calls) == 2
    # 'auto' on CPU tensors: the gate speaks of the CUDA kernels only
    flags()
    _forward(config, params, batch, train=True)
    _forward(masked, mparams, mbatch, train=True)
    assert len(calls) == 2


def test_kernel_dispatch_passes_the_padding_mask(flags, monkeypatch):
    """A mask_padding model hands the fused layer the encoder's mask, true
    at the valid positions; a keras_padding model hands it none."""
    calls = _spy(monkeypatch, 'teacher_top_fused')
    flags(teacher_kernel='on')
    for mask_padding in (False, True):
        config, params, batch = _setup(mask_padding, B=3, T=8)
        _forward(config, params, batch, train=True)
    unmasked, masked = calls
    assert unmasked[8] is None
    want = batch[0].any(axis=2)
    assert not want.all()
    np.testing.assert_array_equal(masked[8].numpy(), want)


def test_teacher_counters_count_the_fused_route(flags, tmp_path):
    """training.teacher_calls counts the training forwards' top layers,
    training.teacher_kernel_calls those on the fused layer; eval counts
    neither."""
    config, params, batch = _setup(mask_padding=True, B=2, T=6)
    got = {}
    for mode in ('on', 'off'):
        flags(teacher_kernel=mode)
        with profiling.maybe_profile(
                profile_file=str(tmp_path / ('%s.prof' % mode))):
            _forward(config, params, batch, train=False)
            for _ in range(3):
                _forward(config, params, batch, train=True)
            got[mode] = profiling.snapshot()['counters']
    assert got['on']['training.teacher_calls'] == 3
    assert got['on']['training.teacher_kernel_calls'] == 3
    assert got['off']['training.teacher_calls'] == 3
    assert 'training.teacher_kernel_calls' not in got['off']


def test_kernel_dispatch_passes_dropout_masks(flags, monkeypatch):
    config, params, batch = _setup(B=2, T=6)
    config = dataclasses.replace(config, dropout=0.5)
    calls = _spy(monkeypatch, 'teacher_top_fused')
    flags(teacher_kernel='on')
    out = _forward(config, params, batch, True,
                   torch.Generator().manual_seed(1))
    masks = calls[0][6]
    assert masks.shape == (4, 2, config.width + config.attended_size)
    assert set(masks.unique().tolist()) == {0.0, 2.0}
    assert bool(torch.isfinite(out).all())


def test_manual_vjp_auto_engages_only_for_training(flags, monkeypatch):
    """'auto' leaves train=False on the per-step body and takes the
    hand-written backward for training when the windowed route is on."""
    calls = _spy(monkeypatch, 'teacher_top_scan')
    config, params, batch = _setup(B=2, T=52)
    flags(teacher_kernel='off', teacher_attention='windowed')
    _forward(config, params, batch, train=False)
    assert not calls
    _forward(config, params, batch, train=True)
    assert len(calls) == 1 and calls[0][10] is False     # gather forward


def test_budget_fallback_is_dense_not_windowed_autograd(flags, monkeypatch):
    """When 'auto' training selects the windowed route but the manual
    backward declines (stack budget), the step falls back to the dense
    body, not to autograd through the windowed gathers."""
    config, params, batch = _setup(B=2, T=12)
    vjp_calls = _spy(monkeypatch, 'teacher_top_scan')
    win_calls = _spy(monkeypatch, '_windowed_attention')
    flags(teacher_kernel='off')
    for pkg in (JS, PS):
        monkeypatch.setattr(pkg, '_TEACHER_WINDOWED_MIN_T', 8)
        monkeypatch.setattr(pkg, '_TEACHER_VJP_STACK_BUDGET', 1)
    want = JS.forward_teacher(params, config, batch[0], batch[1],
                              dropout_rng=jax.random.PRNGKey(3), train=True)
    got = _forward(config, params, batch, train=True)
    assert not vjp_calls and not win_calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # eval of a long line does take the windowed body
    _forward(config, params, batch, train=False)
    assert win_calls and not vjp_calls


def test_dense_forward_vjp_only_when_forced(flags, monkeypatch):
    """Below _TEACHER_WINDOWED_MIN_T 'auto' training stays on autograd
    through the dense body; the dense forward of teacher_top_scan engages
    only when _TEACHER_VJP is forced 'on'."""
    calls = _spy(monkeypatch, 'teacher_top_scan')
    config, params, batch = _setup(B=2, T=12)
    flags(teacher_kernel='off')
    _forward(config, params, batch, train=True)
    assert not calls
    flags(teacher_kernel='off', teacher_vjp='on')
    _forward(config, params, batch, train=True)
    assert len(calls) == 1 and calls[0][10] is True       # dense forward


@pytest.mark.parametrize('mask_padding', [False, True],
                         ids=['keras_padding', 'mask_padding'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_windowed_eval_probs_identical_to_dense(flags, mask_padding, dtype):
    """The windowed body skips only rows that the dense body masks, so
    the probabilities are equal bit for bit; and equal to the JAX
    package's in float32."""
    config, params, batch = _setup(mask_padding, B=8, T=64, W=16)
    pt = params_from_numpy(params, 'cpu', getattr(torch, dtype))
    enc, dec_in = (torch.from_numpy(a) for a in batch[:2])
    probs = {}
    for mode in ('dense', 'windowed'):
        flags(teacher_attention=mode)
        with torch.no_grad():
            probs[mode] = PS.forward_teacher(pt, config, enc, dec_in)
    assert torch.equal(probs['dense'], probs['windowed'])
    if dtype == 'float32':
        want = JS.forward_teacher(params, config, batch[0], batch[1])
        np.testing.assert_allclose(probs['windowed'].numpy(),
                                   np.asarray(want), atol=1e-5)


def test_global_attention_stays_dense(flags, monkeypatch):
    """window_width 0 has no window to exploit: dense at any length and
    under any flag."""
    config, params, batch = _setup(B=2, T=12, window_width=0)
    spies = [_spy(monkeypatch, n) for n in
             ('teacher_top_fused', 'teacher_top_scan',
              '_windowed_attention')]
    flags(teacher_kernel='on', teacher_attention='windowed',
          teacher_vjp='on')
    out = _forward(config, params, batch, train=True)
    assert out.shape == (2, 13, config.voc_size)
    assert not any(spies)


def test_bf16_train_steps_reach_the_fused_layer_in_bf16(flags, monkeypatch):
    """train_step with bf16 compute copies hands the fused layer bf16
    weights and activations; the loss stays finite and falls."""
    flags(teacher_kernel='on')
    calls = _spy(monkeypatch, 'teacher_top_fused')
    config, params, batch = _setup(B=4, T=10)
    pt = _leaves(params)
    opt = PT.make_optimizer(pt, 1e-2)
    losses = [float(PT.train_step(pt, opt, config, *batch, None,
                                  compute_dtype='bfloat16'))
              for _ in range(20)]
    assert len(calls) == 20
    top, xs = calls[0][0], calls[0][1]
    assert top['cell']['recurrent_kernel'].dtype == torch.bfloat16
    assert xs.dtype == torch.bfloat16
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1
    assert all(t.dtype == torch.float32 for t in tree_leaves(pt))


def test_three_train_steps_match_with_manual_vjp(flags):
    """Per-step losses with the hand-written backward track the JAX
    package's across optimizer steps."""
    flags(teacher_kernel='off', teacher_attention='windowed',
          teacher_vjp='on')
    config, params, batch = _setup(B=4, T=10)
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
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-4,
                                             abs=1e-5)
