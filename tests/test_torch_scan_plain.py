"""PyTorch port: the plain versions of K4/K5 (whole-sequence LSTM scan).

``ops/lstm_scan_kernel.py`` of the port keeps, beside the CUDA kernels,
step-by-step PyTorch transcriptions of the two Pallas bodies of the JAX
package's ``ops/pallas_lstm_train.py``. On the CPU the wrappers run
these, so the same numpy-seeded inputs go through the Pallas kernels in
interpret mode and through the port:

- forward against ``lstm_scan_fused(..., interpret=True)`` and against
  the port's own ``lstm_scan``: float32 at rtol 1e-5 / atol 1e-6 (the
  logistic is written two ways, an ulp apart), bfloat16 at 2e-2 (one
  bf16 ulp of a gate, carried through the recurrence), the bars of
  tests/test_fused_scan.py;
- gradients through ``LstmScan`` against ``jax.grad`` of the fused scan
  in interpret mode at rtol 2e-4 / atol 2e-5 (float32 sums in another
  order), the bar of tests/test_fused_scan.py::test_gradients_match_xla;
- with a padding mask (which the Pallas kernels lack) against the masked
  ``lstm_scan`` of both packages, under autograd and ``jax.grad``: the
  same bars in float32; in bfloat16 the forward at 2e-2 and the
  gradients at 3e-2 of their largest value (``lstm_scan`` differentiates
  bfloat16 ops, K5 carries dh and dc in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.ops.lstm import lstm_scan as j_lstm_scan
from cor_asv_ann_tpu.ops.pallas_lstm_train import (
    lstm_scan_fused as j_lstm_scan_fused)
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as K
from cor_asv_ann_tpu_torch.ops.lstm import lstm_scan
from padding_masks import kernel_mask, padding_mask
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed, B, T, D, N, with_init=True):
    rng = np.random.default_rng(seed)
    w = {'kernel': rng.standard_normal((D, 4 * N)).astype(np.float32) * 0.3,
         'recurrent_kernel':
             rng.standard_normal((N, 4 * N)).astype(np.float32) * 0.3,
         'bias': rng.standard_normal(4 * N).astype(np.float32) * 0.1}
    xs = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = c0 = None
    if with_init:
        h0 = rng.standard_normal((B, N)).astype(np.float32) * 0.2
        c0 = rng.standard_normal((B, N)).astype(np.float32) * 0.2
    return w, xs, h0, c0


def _jx(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _tt(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('with_init', [False, True])
@pytest.mark.parametrize('B', [5, 6])
def test_plain_forward_matches_pallas_interpret(reverse, with_init, B):
    w, xs, h0, c0 = _inputs(3, B, 7, 8, 8, with_init)
    want = j_lstm_scan_fused(_jx(xs), {k: _jx(v) for k, v in w.items()},
                             _jx(h0), _jx(c0), reverse=reverse,
                             interpret=True)
    tw = {k: _tt(v) for k, v in w.items()}
    before = K.lstm_scan_fwd.launches
    got = K.lstm_scan_fused(_tt(xs), tw, _tt(h0), _tt(c0), reverse=reverse)
    ref = lstm_scan(_tt(xs), tw, _tt(h0), _tt(c0), reverse=reverse)
    # a CPU tensor runs the plain version and counts no launch
    assert K.lstm_scan_fwd.launches == before
    for g, j, r in zip(got, want, ref):
        np.testing.assert_allclose(_np(g), np.asarray(j), **F32)
        np.testing.assert_allclose(_np(g), _np(r), **F32)


@pytest.mark.parametrize('reverse', [False, True])
def test_plain_forward_bf16(reverse):
    w, xs, h0, c0 = _inputs(7, 5, 6, 8, 8)
    bf = jnp.bfloat16
    want = j_lstm_scan_fused(_jx(xs, bf),
                             {k: _jx(v, bf) for k, v in w.items()},
                             _jx(h0, bf), _jx(c0, bf), reverse=reverse,
                             interpret=True)
    tb = torch.bfloat16
    tw = {k: _tt(v, tb) for k, v in w.items()}
    got = K.lstm_scan_fused(_tt(xs, tb), tw, _tt(h0, tb), _tt(c0, tb),
                            reverse=reverse)
    ref = lstm_scan(_tt(xs, tb), tw, _tt(h0, tb), _tt(c0, tb),
                    reverse=reverse)
    assert got[0].dtype == tb
    for g, j, r in zip(got, want, ref):
        np.testing.assert_allclose(_np(g), np.asarray(j, np.float32), **BF16)
        np.testing.assert_allclose(_np(g), _np(r), **BF16)


def test_plain_kernels_outputs_and_order():
    """The raw K4 outputs: cs alongside hs, final states equal to the
    last step walked, which for a reverse scan is time index 0."""
    w, xs, h0, c0 = _inputs(5, 3, 5, 4, 8)
    R = _tt(w['recurrent_kernel'])
    zx = _tt(np.random.default_rng(1).standard_normal((5, 3, 32))
             .astype(np.float32))
    for reverse, last in ((False, -1), (True, 0)):
        hs, cs, hT, cT = K.lstm_scan_fwd(zx, R, _tt(h0), _tt(c0), reverse)
        assert hs.shape == cs.shape == (5, 3, 8)
        assert torch.equal(hT, hs[last]) and torch.equal(cT, cs[last])


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('B', [5, 6])
def test_gradients_match_pallas_interpret(reverse, B):
    """LstmScan's backward (plain K5 + the weight-gradient product) against
    jax.grad of the custom_vjp: inputs, the three weights, both states."""
    T, D, N = 6, 8, 8
    w, xs, h0, c0 = _inputs(11, B, T, D, N)
    rng = np.random.default_rng(12)
    wo = rng.standard_normal((B, T, N)).astype(np.float32)
    wh = rng.standard_normal((B, N)).astype(np.float32)
    wc = rng.standard_normal((B, N)).astype(np.float32)

    def jloss(xs, w, h0, c0):
        out, h, c = j_lstm_scan_fused(xs, w, h0, c0, reverse=reverse,
                                      interpret=True)
        return jnp.sum(out * wo) + jnp.sum(h * wh) + jnp.sum(c * wc)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        _jx(xs), {k: _jx(v) for k, v in w.items()}, _jx(h0), _jx(c0))

    def leaf(a):
        return _tt(a).requires_grad_()

    txs, th0, tc0 = leaf(xs), leaf(h0), leaf(c0)
    tw = {k: leaf(v) for k, v in w.items()}

    def tloss(fn):
        out, h, c = fn(txs, tw, th0, tc0, reverse=reverse)
        return ((out * _tt(wo)).sum() + (h * _tt(wh)).sum()
                + (c * _tt(wc)).sum())

    leaves = [txs, tw['bias'], tw['kernel'], tw['recurrent_kernel'], th0,
              tc0]
    before = K.lstm_scan_bwd.launches
    got = torch.autograd.grad(tloss(K.lstm_scan_fused), leaves)
    assert K.lstm_scan_bwd.launches == before
    # and against autograd through the port's step-by-step lstm_scan
    ref = torch.autograd.grad(tloss(lstm_scan), leaves)
    want = [jg[0], jg[1]['bias'], jg[1]['kernel'],
            jg[1]['recurrent_kernel'], jg[2], jg[3]]
    for g, j, r in zip(got, want, ref):
        np.testing.assert_allclose(_np(g), np.asarray(j), **GRAD)
        np.testing.assert_allclose(_np(g), _np(r), **GRAD)


def test_backward_without_state_cotangents():
    """Only hs is used downstream: the hT/cT cotangents arrive as None."""
    w, xs, _, _ = _inputs(13, 5, 4, 8, 8, with_init=False)
    txs = _tt(xs).requires_grad_()
    tw = {k: _tt(v).requires_grad_() for k, v in w.items()}
    out, _, _ = K.lstm_scan_fused(txs, tw)
    g_fused = torch.autograd.grad((out * out).sum(), [txs, *tw.values()])
    out, _, _ = lstm_scan(txs, tw)
    g_ref = torch.autograd.grad((out * out).sum(), [txs, *tw.values()])
    for g, r in zip(g_fused, g_ref):
        np.testing.assert_allclose(_np(g), _np(r), **GRAD)


def test_bwd_reference_dtypes_bf16():
    """K5's contract in bfloat16: dzx in the weight dtype, the state
    gradients in float32, all finite."""
    tb = torch.bfloat16
    w, xs, h0, c0 = _inputs(17, 5, 4, 8, 8)
    R = _tt(w['recurrent_kernel'], tb)
    rng = np.random.default_rng(2)
    zx = _tt(rng.standard_normal((4, 5, 32)).astype(np.float32), tb)
    hs, cs, _, _ = K.lstm_scan_fwd(zx, R, _tt(h0, tb), _tt(c0, tb))
    hprev = torch.cat([_tt(h0, tb)[None], hs[:-1]])
    cprev = torch.cat([_tt(c0, tb)[None], cs[:-1]])
    g = torch.ones_like(hs)
    dzx, dh0, dc0 = K.lstm_scan_bwd(g, g[0], g[0], zx, R, hprev, cprev, cs)
    assert dzx.dtype == tb and dzx.shape == zx.shape
    assert dh0.dtype == dc0.dtype == torch.float32
    assert all(bool(torch.isfinite(t.float()).all())
               for t in (dzx, dh0, dc0))


def test_mask_goes_through_and_gate_is_off_on_cpu():
    """The masked fused route (plain K4/K5 through LstmScan) is the masked
    plain scan, in both directions, and counts no launch on the CPU."""
    w, xs, _, _ = _inputs(19, 4, 5, 8, 8, with_init=False)
    tw = {k: _tt(v) for k, v in w.items()}
    mask = torch.from_numpy(padding_mask(4, 5, 20))
    before = K.lstm_scan_fwd.launches
    for reverse in (False, True):
        got = K.lstm_scan_fused(_tt(xs), tw, reverse=reverse, mask=mask)
        ref = lstm_scan(_tt(xs), tw, reverse=reverse, mask=mask)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), _np(r), **F32)
        # zero outputs at masked steps; the all-padding row keeps h0 = 0
        assert not bool(got[0][~mask].any()) and not bool(got[1][1].any())
    assert K.lstm_scan_fwd.launches == before
    # the gate speaks of the CUDA kernels only
    assert not K.fused_scan_supported(tw)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('with_init', [False, True])
@pytest.mark.parametrize('reverse', [False, True])
def test_masked_scan_matches_both_packages(dtype, with_init, reverse):
    """lstm_scan_fused(mask=) against the port's masked lstm_scan under
    autograd and the JAX package's under jax.grad: outputs, final states
    and the gradients of xs, the three weights, h0 and c0. The mask holds
    right padding, gaps inside a row, a whole row and a row of padding
    only."""
    B, T, D, N = 5, 7, 8, 8
    w, xs, h0, c0 = _inputs(23, B, T, D, N, with_init)
    mask = padding_mask(B, T, 24)
    rng = np.random.default_rng(25)
    wo = rng.standard_normal((B, T, N)).astype(np.float32)
    wh = rng.standard_normal((B, N)).astype(np.float32)
    wc = rng.standard_normal((B, N)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(xs, w, h0, c0):
        out, h, c = j_lstm_scan(xs, w, h0, c0, reverse=reverse,
                                mask=jnp.asarray(mask))
        f32 = jnp.float32
        return (jnp.sum(out.astype(f32) * wo) + jnp.sum(h.astype(f32) * wh)
                + jnp.sum(c.astype(f32) * wc)), (out, h, c)

    jargs = (_jx(xs, jdt), {k: _jx(v, jdt) for k, v in w.items()},
             _jx(h0, jdt), _jx(c0, jdt))
    argnums = (0, 1, 2, 3) if with_init else (0, 1)
    jg, jouts = jax.grad(jloss, argnums=argnums, has_aux=True)(*jargs)
    jwant = [jg[0], jg[1]['bias'], jg[1]['kernel'],
             jg[1]['recurrent_kernel'], *jg[2:]]

    def leaf(a):
        return None if a is None else _tt(a, tdt).requires_grad_()

    txs, th0, tc0 = leaf(xs), leaf(h0), leaf(c0)
    tw = {k: leaf(v) for k, v in w.items()}
    leaves = [txs, tw['bias'], tw['kernel'], tw['recurrent_kernel']]
    leaves += [th0, tc0] if with_init else []
    tmask = torch.from_numpy(mask)

    def run(fn):
        outs = fn(txs, tw, th0, tc0, reverse=reverse, mask=tmask)
        loss = ((outs[0].float() * _tt(wo)).sum()
                + (outs[1].float() * _tt(wh)).sum()
                + (outs[2].float() * _tt(wc)).sum())
        return outs, torch.autograd.grad(loss, leaves)

    got, got_g = run(K.lstm_scan_fused)
    ref, ref_g = run(lstm_scan)
    fwd = F32 if dtype == 'float32' else BF16
    for g, r, j in zip(got, ref, jouts):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(r), **fwd)
        np.testing.assert_allclose(_np(g), np.asarray(j, np.float32), **fwd)
    assert not bool(got[0][~tmask].any())
    for g, r, j in zip(got_g, ref_g, jwant):
        g, r, j = _np(g), _np(r), np.asarray(j, np.float32)
        if dtype == 'float32':
            np.testing.assert_allclose(g, r, **GRAD)
            np.testing.assert_allclose(g, j, **GRAD)
        else:
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g / scale, r / scale, atol=3e-2)
            np.testing.assert_allclose(g / scale, j / scale, atol=3e-2)


@pytest.mark.parametrize('reverse', [False, True])
def test_masked_plain_kernels_hold_the_carry(reverse):
    """The raw plain K4/K5 with a mask: hs and cs hold the carry at masked
    steps; dzx is zero there, the output cotangent of a masked step does
    not enter, and dh, dc pass masked steps unchanged (an all-padding row
    returns g_hT and g_cT as its dh0 and dc0)."""
    T, B, N = 5, 4, 8
    w, _, h0, c0 = _inputs(29, B, T, 4, N)
    R, h0, c0 = _tt(w['recurrent_kernel']), _tt(h0), _tt(c0)
    rng = np.random.default_rng(30)
    zx = _tt(rng.standard_normal((T, B, 4 * N)).astype(np.float32))
    mask = kernel_mask(T, B, 31)
    hs, cs, hT, cT = K.lstm_scan_fwd(zx, R, h0, c0, reverse, mask)
    walk = range(T - 1, -1, -1) if reverse else range(T)
    h, c = h0, c0
    for t in walk:
        held = mask[t].bool()
        assert torch.equal(hs[t][~held], h[~held])
        assert torch.equal(cs[t][~held], c[~held])
        h, c = hs[t], cs[t]
    assert torch.equal(hT, h) and torch.equal(cT, c)
    assert torch.equal(hT[1], h0[1]) and torch.equal(cT[1], c0[1])
    hbuf = torch.cat([hs, h0[None]]) if reverse else torch.cat([h0[None], hs])
    cbuf = torch.cat([cs, c0[None]]) if reverse else torch.cat([c0[None], cs])
    hprev = hbuf[1:] if reverse else hbuf[:-1]
    cprev = cbuf[1:] if reverse else cbuf[:-1]
    g_hs, g_hT, g_cT = (_tt(rng.standard_normal(s).astype(np.float32))
                        for s in ((T, B, N), (B, N), (B, N)))
    dzx, dh0, dc0 = K.lstm_scan_bwd(g_hs, g_hT, g_cT, zx, R, hprev, cprev,
                                    cs, reverse, mask)
    assert not bool(dzx[mask == 0].any())
    assert torch.equal(dh0[1], g_hT[1]) and torch.equal(dc0[1], g_cT[1])
    # a cotangent at a masked step changes nothing
    g2 = g_hs.clone()
    g2[mask == 0] = 100.0
    again = K.lstm_scan_bwd(g2, g_hT, g_cT, zx, R, hprev, cprev, cs,
                            reverse, mask)
    for a, b in zip(again, (dzx, dh0, dc0)):
        assert torch.equal(a, b)
