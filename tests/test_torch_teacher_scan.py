"""PyTorch port: ``models/teacher_scan.py`` (windowed teacher-forced top
scan with a hand-written backward) against the JAX package's.

The same numpy-seeded top layer, activations, padding mask and dropout
masks go through ``teacher_top_scan`` of both packages, with the gather
forward and the dense one:

- forward at rtol 1e-5 / atol 1e-6 (float32 sums in another order; the
  JAX package's own bar against its windowed body is 1e-6 / 1e-7 within
  one framework);
- every gradient leaf at rtol 2e-4 / atol 1e-5, the bar of
  tests/test_teacher_vjp.py against autodiff;
- inside the port: the hand-written backward against autograd through the
  windowed per-step body, and the forward against that body exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models import teacher_scan as JTS
from cor_asv_ann_tpu_torch.models import teacher_scan as PTS
from cor_asv_ann_tpu_torch.models.seq2seq import _teacher_body
from torch_port_fixtures import (TEACHER_LEAVES,  # noqa: F401
                                 single_threaded_cpu, teacher_leaves)

WW = 2
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)


def _setup(seed=0, B=4, Td=9, T=14, W=8, A=12, scale=0.4):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(0, scale, s).astype(np.float32)

    top = {'W_a': f(W, W), 'v_a': f(W, 1), 'b_UW': f(W), 'b_v': f(1),
           'cell': {'kernel': f(W + A, 4 * W),
                    'recurrent_kernel': f(W, 4 * W), 'bias': f(4 * W)}}
    xs, att, u = f(B, Td, W), f(B, T, A), f(B, T, W)
    h0, c0 = f(B, W), f(B, W)
    masks = ((rng.random((4, B, W + A)) < 0.8) / 0.8).astype(np.float32)
    enc_mask = np.ones((B, T), np.float32)
    enc_mask[-1, T // 2:] = 0.0     # one short line exercises the mask
    enc_mask[0, 1] = 0.0            # and a hole inside the first window
    return top, xs, att, u, h0, c0, enc_mask, masks


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _tt(v, grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().numpy()


def _opt(a, use):
    return a if use else None


CASES = pytest.mark.parametrize(
    'dense,with_enc_mask,with_masks',
    [(d, e, m) for d in (False, True) for e in (False, True)
     for m in (False, True)])


@CASES
def test_forward_matches_jax(dense, with_enc_mask, with_masks):
    top, xs, att, u, h0, c0, enc_mask, masks = _setup()
    WIN = min(2 * WW + 2, att.shape[1])
    em, m = _opt(enc_mask, with_enc_mask), _opt(masks, with_masks)
    want = JTS.teacher_top_scan(
        _jx(top), *_jx((xs, att, u, h0, c0)),
        None if em is None else jnp.asarray(em),
        None if m is None else jnp.asarray(m), WW, WIN, dense)
    with torch.no_grad():
        got = PTS.teacher_top_scan(
            _tt(top), *(_tt(a) for a in (xs, att, u, h0, c0)),
            None if em is None else _tt(em),
            None if m is None else _tt(m), WW, WIN, dense)
    assert got.shape == xs.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


@CASES
def test_gradients_match_jax(dense, with_enc_mask, with_masks):
    top, xs, att, u, h0, c0, enc_mask, masks = _setup(seed=1)
    WIN = min(2 * WW + 2, att.shape[1])
    em, m = _opt(enc_mask, with_enc_mask), _opt(masks, with_masks)
    jem = None if em is None else jnp.asarray(em)
    jm = None if m is None else jnp.asarray(m)
    wo = np.random.default_rng(2).standard_normal(xs.shape).astype(
        np.float32)

    def jloss(top, xs, att, u, h0, c0):
        return jnp.sum(JTS.teacher_top_scan(top, xs, att, u, h0, c0, jem,
                                            jm, WW, WIN, dense) * wo)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        _jx(top), *_jx((xs, att, u, h0, c0)))
    args = (_tt(top, True), *(_tt(a, True) for a in (xs, att, u, h0, c0)))
    out = PTS.teacher_top_scan(*args, None if em is None else _tt(em),
                               None if m is None else _tt(m), WW, WIN,
                               dense)
    got = torch.autograd.grad((out * _tt(wo)).sum(), teacher_leaves(*args))
    for name, g, w in zip(TEACHER_LEAVES, got, teacher_leaves(*jg)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **GRAD)


@pytest.mark.parametrize('with_enc_mask', [False, True])
@pytest.mark.parametrize('with_masks', [False, True])
def test_manual_backward_matches_autograd_windowed_body(with_enc_mask,
                                                        with_masks):
    """Inside the port: the same forward values as the windowed per-step
    body, and the hand-written backward against autograd through it."""
    top, xs, att, u, h0, c0, enc_mask, masks = _setup(seed=3, T=40)
    WIN = 2 * WW + 2
    em = _tt(enc_mask) if with_enc_mask else None
    m = _tt(masks) if with_masks else None
    args = (_tt(top, True), *(_tt(a, True) for a in (xs, att, u, h0, c0)))
    leaves = teacher_leaves(*args)
    out = PTS.teacher_top_scan(*args, em, m, WW, WIN)
    ref = _teacher_body(*args, m, WW, WIN,
                        None if em is None else em.bool())
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-7)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    want = torch.autograd.grad((ref ** 2).sum(), leaves)
    for name, g, w in zip(TEACHER_LEAVES, got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **GRAD)


def test_dense_and_gather_forwards_share_residuals():
    """Both forwards leave the same (aw, astart) carry, so one reverse
    sweep serves both."""
    top, xs, att, u, h0, c0, enc_mask, masks = _setup(seed=4)
    WIN = 2 * WW + 2
    t = _tt(top)
    args = tuple(_tt(a) for a in (xs, att, u, h0, c0))
    gather = PTS._fwd_scan(t, *args, _tt(enc_mask), _tt(masks), WW, WIN)
    dense = PTS._fwd_scan(t, *args, _tt(enc_mask), _tt(masks), WW, WIN,
                          dense=True)
    for g, d in zip(gather, dense):
        np.testing.assert_allclose(_np(g), _np(d), rtol=1e-6, atol=1e-7)
    assert gather[3].dtype == torch.int32
    assert gather[2].shape == (xs.shape[1], xs.shape[0], WIN)
