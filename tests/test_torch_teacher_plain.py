"""PyTorch port: the plain versions of K6/K7 (fused teacher-forced top
layer) and ``TeacherTopFused`` against the JAX package.

``ops/teacher_kernel.py`` of the port keeps, beside the CUDA kernels,
step-by-step PyTorch transcriptions of the two Pallas bodies of the JAX
package's ``ops/pallas_teacher.py``. On the CPU the wrappers run these,
so the same numpy-seeded inputs go through the Pallas kernels in
interpret mode (``teacher_top_fused(..., interpret=True, bt=8)``, as
tests/test_teacher_kernel.py runs them) and through the port:

- forward and the residual stacks within 1e-4 (float32 sums in another
  order; the bar of tests/test_teacher_kernel.py), bfloat16 forward
  within 3e-2 (an ulp of a gate carried through the recurrence);
- every gradient leaf at rtol 2e-3 / atol 2e-4, the JAX test's own bar
  against autodiff, here against ``jax.grad`` of the custom_vjp and
  against autograd through the port's dense body.

The cases marked ``padded`` add the encoder's padding mask
(`padding_masks.teacher_mask`: right padding, a whole row, an
all-padding row, a row with gaps, a row whose every window is empty),
which the Pallas kernels do not take: there the JAX package's masked
route for the layer, ``teacher_top_scan`` with its dense forward, is the
reference, beside the port's dense body and its own
``teacher_top_scan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models import teacher_scan as JTS
from cor_asv_ann_tpu.ops import pallas_teacher as JP
from cor_asv_ann_tpu_torch.models import teacher_scan as PTS
from cor_asv_ann_tpu_torch.models.seq2seq import _teacher_body
from cor_asv_ann_tpu_torch.ops import teacher_kernel as K
from padding_masks import teacher_mask
from torch_port_fixtures import (TEACHER_LEAVES,  # noqa: F401
                                 single_threaded_cpu, teacher_leaves)

WW = 5
FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-3, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
# dropout masks or none, each without and with the encoder's padding mask
MASK_CASES = pytest.mark.parametrize('with_masks,padded', [
    pytest.param(m, p, id='%s%s' % (m, '-padded' if p else ''))
    for p in (False, True) for m in (False, True)])


def _setup(seed=0, B=5, Td=9, T=16, W=32, A=48, scale=0.18):
    """numpy inputs in the layout of tests/test_teacher_kernel.py."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.normal(0, scale, s).astype(np.float32)

    top = {'W_a': f(W, W), 'v_a': f(W, 1), 'b_UW': f(W), 'b_v': f(1),
           'cell': {'kernel': f(W + A, 4 * W),
                    'recurrent_kernel': f(W, 4 * W), 'bias': f(4 * W)}}
    xs = f(B, Td, W)
    att, u = f(B, T, A), f(B, T, W)
    h0, c0 = f(B, W), f(B, W)
    masks = ((rng.random((4, B, W + A)) < 0.8) / 0.8).astype(np.float32)
    return top, xs, att, u, h0, c0, masks


def _jx(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                  tree)


def _tt(tree, dtype=torch.float32, grad=False):
    def leaf(a):
        t = torch.from_numpy(np.array(a)).to(dtype)
        return t.requires_grad_() if grad else t
    if isinstance(tree, dict):
        return {k: _tt(v, dtype, grad) for k, v in tree.items()}
    return leaf(tree)


def _np(t):
    return t.detach().float().numpy()


def _enc_mask(padded, B, T, seed=0):
    """The encoder's (B, T) uint8 padding mask of a padded case, else
    None."""
    return teacher_mask(B, T, seed, WW) if padded else None


def _jax_masked(top, xs, att, u, h0, c0, enc_mask, masks):
    """The JAX package's masked route for the layer: teacher_top_scan
    with its dense forward (jnp arrays in, hs out)."""
    WIN = min(2 * WW + 2, att.shape[1])
    return JTS.teacher_top_scan(top, xs, att, u, h0, c0,
                                jnp.asarray(enc_mask.numpy(), att.dtype),
                                masks, WW, WIN, True)


@pytest.mark.parametrize('B', [5, 7])
@MASK_CASES
def test_fused_forward_matches_pallas_interpret(with_masks, padded, B):
    top, xs, att, u, h0, c0, masks = _setup(B=B)
    m = masks if with_masks else None
    jm = None if m is None else jnp.asarray(m)
    em = _enc_mask(padded, B, att.shape[1])
    if padded:
        want = _jax_masked(_jx(top), *_jx((xs, att, u, h0, c0)), em, jm)
    else:
        want = JP.teacher_top_fused(_jx(top), *_jx((xs, att, u, h0, c0)),
                                    jm, WW, True, 8)
    before = K.teacher_fwd.launches
    tm = None if m is None else _tt(m)
    args = (_tt(top), *(_tt(a) for a in (xs, att, u, h0, c0)))
    got = K.teacher_top_fused(*args, tm, WW, em)
    # a CPU tensor runs the plain version and counts no launch
    assert K.teacher_fwd.launches == before
    assert got.shape == xs.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    # and the port's own dense body under the same masks
    top_t, xs_t, att_t, u_t, h0_t, c0_t = args
    ref = _teacher_body(top_t, xs_t, att_t, u_t, h0_t, c0_t, tm, WW, 0,
                        None if em is None else em.bool())
    np.testing.assert_allclose(_np(got), _np(ref), **FWD)


@MASK_CASES
def test_plain_forward_residuals_match_pallas_interpret(with_masks, padded):
    """The raw K6 outputs (hs, cs, the dense alignment rows, the gate
    preactivations) against the Pallas forward's; padded, hs against the
    JAX package's masked route, and the alignment rows zero at padded
    positions and in the rows whose windows hold no valid position."""
    top, xs, att, u, h0, c0, masks = _setup(seed=1, B=6)
    m = masks if with_masks else None
    jm = None if m is None else jnp.asarray(m)
    em = _enc_mask(padded, 6, att.shape[1], seed=1)
    if padded:
        hs = _jax_masked(_jx(top), *_jx((xs, att, u, h0, c0)), em, jm)
        want = [jnp.swapaxes(hs, 0, 1)]
    else:
        want = JP._fwd_impl(_jx(top), *_jx((xs, att, u, h0, c0)), jm, WW,
                            True, 8)
    B, Td, W = xs.shape
    A = att.shape[2]
    t = _tt(top)
    K_x, K_ctx, v_row, b_UW, b_v, bias, mask_x, maskc = K._prep(
        t['v_a'], t['b_UW'], t['b_v'], t['cell']['kernel'],
        t['cell']['bias'], None if m is None else _tt(m), B, W, A,
        torch.float32, 'cpu')
    zx = K._zx_of(_tt(xs), mask_x, K_x, W, torch.float32)
    got = K.teacher_fwd(zx, _tt(u), _tt(att), K_ctx,
                        t['cell']['recurrent_kernel'], t['W_a'], v_row,
                        b_UW, b_v, bias, maskc, _tt(h0), _tt(c0), WW, em)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **FWD)
    aa = got[2]
    # every alignment row sums to 1 (or, where no valid position is in
    # its window, to 0) and lives inside one window
    empty = np.zeros(B, bool)
    if padded:
        empty[[1, 3]] = True
        assert not bool(aa[:, em == 0].any())
    np.testing.assert_allclose(_np(aa.sum(dim=-1)),
                               np.broadcast_to(~empty, (Td, B)), atol=1e-5)
    assert int((aa != 0).sum(dim=-1).max()) <= 2 * WW + 1


@pytest.mark.parametrize('B', [5, 7])
@MASK_CASES
def test_fused_gradients_match_pallas_interpret(with_masks, padded, B):
    """TeacherTopFused's backward (plain K7 + the outside contractions)
    against jax.grad of the custom_vjp, every leaf; padded, against
    jax.grad of the JAX package's masked route."""
    top, xs, att, u, h0, c0, masks = _setup(B=B)
    m = masks if with_masks else None
    jm = None if m is None else jnp.asarray(m)
    em = _enc_mask(padded, B, att.shape[1])

    def jloss(top, xs, att, u, h0, c0):
        if padded:
            return jnp.sum(_jax_masked(top, xs, att, u, h0, c0, em,
                                       jm) ** 2)
        return jnp.sum(JP.teacher_top_fused(top, xs, att, u, h0, c0, jm,
                                            WW, True, 8) ** 2)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        _jx(top), *_jx((xs, att, u, h0, c0)))
    want = teacher_leaves(*jg)
    args = (_tt(top, grad=True),
            *(_tt(a, grad=True) for a in (xs, att, u, h0, c0)))
    before = K.teacher_bwd.launches
    out = K.teacher_top_fused(*args, None if m is None else _tt(m), WW, em)
    got = torch.autograd.grad((out ** 2).sum(), teacher_leaves(*args))
    assert K.teacher_bwd.launches == before
    for name, g, w in zip(TEACHER_LEAVES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **GRAD)


@MASK_CASES
def test_fused_gradients_match_autograd_through_dense_body(with_masks,
                                                           padded):
    """Padded, with a decoder of 24 steps over lines of at most 20
    positions, also against the port's teacher_top_scan with its mask_f:
    loss, hs and every gradient."""
    top, xs, att, u, h0, c0, masks = _setup(seed=2, B=6, T=20,
                                            Td=24 if padded else 9)
    tm = _tt(masks) if with_masks else None
    em = _enc_mask(padded, 6, 20, seed=2)
    args = (_tt(top, grad=True),
            *(_tt(a, grad=True) for a in (xs, att, u, h0, c0)))
    leaves = teacher_leaves(*args)
    out = K.teacher_top_fused(*args, tm, WW, em)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    refs = [_teacher_body(*args, tm, WW, 0, None if em is None
                          else em.bool())]
    if padded:
        refs.append(PTS.teacher_top_scan(*args, em.float(), tm, WW,
                                         2 * WW + 2, True))
    for ref in refs:
        np.testing.assert_allclose(_np(out), _np(ref), **FWD)
        np.testing.assert_allclose(float((out.detach() ** 2).sum()),
                                   float((ref.detach() ** 2).sum()),
                                   rtol=1e-5)
        want = torch.autograd.grad((ref ** 2).sum(), leaves)
        for name, g, w in zip(TEACHER_LEAVES, got, want):
            np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **GRAD)


@MASK_CASES
def test_fused_forward_bf16(with_masks, padded):
    top, xs, att, u, h0, c0, masks = _setup(seed=3)
    bf, tb = jnp.bfloat16, torch.bfloat16
    jm = jnp.asarray(masks) if with_masks else None
    em = _enc_mask(padded, 5, att.shape[1], seed=3)
    if padded:
        want = _jax_masked(_jx(top, bf), *_jx((xs, att, u, h0, c0), bf), em,
                           jm)
    else:
        want = JP.teacher_top_fused(_jx(top, bf),
                                    *_jx((xs, att, u, h0, c0), bf), jm, WW,
                                    True, 8)
    got = K.teacher_top_fused(
        _tt(top, tb), *(_tt(a, tb) for a in (xs, att, u, h0, c0)),
        _tt(masks) if with_masks else None, WW, em)
    assert got.dtype == tb
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16)


def test_bwd_reference_contract_bf16():
    """K7's contract in bfloat16: the per-step stacks in the weight
    dtype, the carried and accumulated gradients in float32, all finite;
    gradients through the Function come back in each leaf's dtype."""
    tb = torch.bfloat16
    top, xs, att, u, h0, c0, masks = _setup(seed=4)
    args = (_tt(top, tb, grad=True),
            *(_tt(a, tb, grad=True) for a in (xs, att, u, h0, c0)))
    out = K.teacher_top_fused(*args, _tt(masks), WW)
    leaves = teacher_leaves(*args)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    for leaf, g in zip(leaves, grads):
        assert g.dtype == tb and g.shape == leaf.shape
        assert bool(torch.isfinite(g.float()).all())
    B, Td, W = xs.shape
    T, A = att.shape[1], att.shape[2]
    t = _tt(top, tb)
    _, K_ctx, v_row, b_UW, b_v, bias, _, maskc = K._prep(
        t['v_a'], t['b_UW'], t['b_v'], t['cell']['kernel'],
        t['cell']['bias'], None, B, W, A, tb, 'cpu')
    zx = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (Td, B, 4 * W)).astype(np.float32))
    R, W_a = t['cell']['recurrent_kernel'], t['W_a']
    hs, cs, aa, zs = K.teacher_fwd(zx, _tt(u, tb), _tt(att, tb), K_ctx, R,
                                   W_a, v_row, b_UW, b_v, bias, maskc,
                                   _tt(h0, tb), _tt(c0, tb), WW)
    assert all(x.dtype == tb for x in (hs, cs, aa, zs))
    hprev = torch.cat([_tt(h0, tb)[None], hs[:-1]])
    cprev = torch.cat([_tt(c0, tb)[None], cs[:-1]])
    outs = K.teacher_bwd(zs, torch.ones_like(hs), hprev, cprev, cs, aa,
                         _tt(u, tb), _tt(att, tb), K_ctx, R, W_a, v_row,
                         b_UW, maskc, WW)
    shapes = [(Td, B, 4 * W), (Td, B, T), (Td, B, A), (Td, B, W), (B, W),
              (B, W), (B, W), (B, T, W), (B, T, A)]
    for k, (o, shape) in enumerate(zip(outs, shapes)):
        assert o.dtype == (tb if k < 4 else torch.float32)
        assert tuple(o.shape) == shape
        assert bool(torch.isfinite(o.float()).all())


def test_gate_is_off_on_cpu():
    """The gate speaks of the CUDA kernels only."""
    top, xs, att, *_ = _setup()
    assert not K.teacher_fused_supported(_tt(top), 5, 9, 16, 32, 48)
