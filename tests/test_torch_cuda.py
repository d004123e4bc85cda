"""PyTorch port: the CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; skipped where no GPU is visible. This file imports no
JAX, so it also runs on a GPU machine without JAX, without the repo's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models.params import params_from_numpy
from cor_asv_ann_tpu_torch.models.seq2seq import encode, ensure_onehot
from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
from cor_asv_ann_tpu_torch.ops.lstm import lstm_scan, lstm_step
from cor_asv_ann_tpu_torch.ops.lstm_step_kernel import lstm_step_fused
from cor_asv_ann_tpu_torch.utils.data import CharMapping, lines_to_index_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize('B,D,W', [(5, 24, 40), (16, 1024, 512),
                                   (100, 512, 512)])
def test_lstm_step_kernel(dev, dtype, tol, B, D, W):
    """Ragged batch and width tiles included; f32 differs from the plain
    version only in summation order, bf16 by at most one ulp of the
    rounded products."""
    rng = np.random.default_rng(0)
    arrays = [rng.uniform(-1, 1, (B, D)), rng.uniform(-1, 1, (B, W)),
              rng.uniform(-1, 1, (B, W)), rng.normal(0, 0.05, (D, 4 * W)),
              rng.normal(0, 0.05, (W, 4 * W)), rng.normal(0, 0.5, (4 * W,))]
    x, h, c, K, R, b = (torch.from_numpy(a.astype(np.float32)).to(dtype)
                        .to(dev) for a in arrays)
    before = lstm_step_fused.launches
    hk, ck = lstm_step_fused(x, h, c, K, R, b)
    torch.cuda.synchronize()
    assert lstm_step_fused.launches == before + 1
    hp, cp = lstm_step(x, h, c, {'kernel': K, 'recurrent_kernel': R,
                                 'bias': b})
    torch.testing.assert_close(hk.float(), hp.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)
    torch.testing.assert_close(ck.float(), cp.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)


def test_lstm_step_kernel_refuses_mixed_devices(dev):
    x = torch.zeros((2, 8), device=dev)
    h = torch.zeros((2, 4), device=dev)
    with pytest.raises(ValueError):
        lstm_step_fused(x, h, h, torch.zeros((8, 16)),
                        torch.zeros((4, 16), device=dev),
                        torch.zeros((16,), device=dev))


@pytest.mark.parametrize('mask_padding', [False, True])
def test_decode_loop_kernel(dev, mask_padding):
    """K1 against its plain twin on the card: a w64 model with a sharpened
    readout, an empty line among the batch."""
    mapping = CharMapping.from_texts(["abcdefgh .,\n"])
    config = Seq2SeqConfig(width=64, depth=2, voc_size=mapping.voc_size,
                           mask_padding=mask_padding)
    params = init_params(config, seed=11)
    params['char_embedding']['kernel'] *= 300.0
    pt = params_from_numpy(params, dev, torch.bfloat16)
    lines = ["abba dig.\n", "hi.\n", "", "deaf bad cab.\n", "gag.\n"]
    enc = torch.from_numpy(lines_to_index_batch(mapping, lines, pad_to=32,
                                                bucketed=False)).to(dev)
    assert dlk.fused_greedy_supported(pt, config, 32)
    onehot = ensure_onehot(enc, config, pt)
    attended, states, u = encode(pt, config, onehot)
    B, T = enc.shape
    live = onehot.reshape(B, -1).ne(0).any(dim=1).to(torch.int32)
    mask = (onehot.ne(0).any(dim=2).to(torch.int32) if mask_padding
            else torch.ones((B, T), dtype=torch.int32, device=dev))
    args = (attended, u, states, live, mask, dlk.decoder_weights(pt),
            mapping.get('\n'), 2 * T, config.window_width)
    idx_k, prob_k, len_k, sc_k = dlk.decode_loop(*args)
    torch.cuda.synchronize()
    idx_r, prob_r, len_r, sc_r = dlk.decode_loop_reference(*args)
    assert int(len_k[2]) == 0 and float(sc_k[2]) == 0.0
    for b in range(B):
        L = int(len_r[b])
        if int(len_k[b]) == L and torch.equal(idx_k[b, :L], idx_r[b, :L]):
            continue
        # summation order may flip a near-tie: the chosen probabilities
        # must agree up to the first divergence
        d = int(torch.nonzero(idx_k[b] != idx_r[b])[0])
        torch.testing.assert_close(prob_k[b, :d + 1], prob_r[b, :d + 1],
                                   atol=2e-2, rtol=0)


def test_fused_dispatch_counts_launches(dev):
    """correct_lines sends a small bf16 batch through K1 (one launch) and
    the f32 use_pallas_lstm path through K2 (two launches per step)."""
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    mapping = CharMapping.from_texts(["abcdefgh .,\n"])
    s2s = Sequence2Sequence(device=dev)
    s2s.width, s2s.depth, s2s.mapping = 64, 2, mapping
    s2s.configure()
    s2s.status = 2
    s2s.compute = 'bfloat16'
    before = dlk.decode_loop.launches
    out, _, _, _ = s2s.correct_lines(["abba dig.\n", "hi.\n"],
                                     return_alignments=False)
    assert len(out) == 2 and dlk.decode_loop.launches == before + 1
    s2s.compute = 'float32'
    s2s.config = dataclasses.replace(s2s.config, use_pallas_lstm=True)
    before = lstm_step_fused.launches
    s2s.correct_lines(["abba dig.\n"], return_alignments=False)
    assert lstm_step_fused.launches - before >= 2


def _scan_inputs(dev, dtype, T, B, N, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((T, B, 4 * N)),
              rng.standard_normal((N, 4 * N)) * (1.0 / np.sqrt(N)),
              rng.standard_normal((B, N)) * 0.2,
              rng.standard_normal((B, N)) * 0.2]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype).to(dev)
            for a in arrays]


def _shift(hs, h0, reverse):
    return (torch.cat([hs[1:], h0[None]]) if reverse
            else torch.cat([h0[None], hs[:-1]]))


SCAN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('T,B,N', [(7, 5, 40), (12, 9, 520), (16, 64, 512)])
def test_lstm_scan_fwd_kernel(dev, dtype, reverse, T, B, N):
    """K4 against its plain version: ragged batch tiles, widths that
    leave threads to split the reduction (N=40), that fill one column
    tile (N=512) and that need a second one (N=520).
    float32 differs in summation order and in expf/tanhf against
    PyTorch's; bfloat16 by an ulp of a gate carried along the sweep."""
    zx, R, h0, c0 = _scan_inputs(dev, dtype, T, B, N)
    before = lsk.lstm_scan_fwd.launches
    got = lsk.lstm_scan_fwd(zx, R, h0, c0, reverse)
    torch.cuda.synchronize()
    assert lsk.lstm_scan_fwd.launches == before + 1
    want = lsk.lstm_scan_fwd_reference(zx, R, h0, c0, reverse)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), **SCAN_TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('T,B,N', [(7, 5, 40), (16, 64, 512)])
def test_lstm_scan_bwd_kernel(dev, dtype, reverse, T, B, N):
    """K5 against its plain version on the states the plain K4 saved."""
    zx, R, h0, c0 = _scan_inputs(dev, dtype, T, B, N, seed=1)
    hs, cs, _, _ = lsk.lstm_scan_fwd_reference(zx, R, h0, c0, reverse)
    hprev, cprev = _shift(hs, h0, reverse), _shift(cs, c0, reverse)
    rng = np.random.default_rng(2)
    g_hs, g_hT, g_cT = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        .to(dtype).to(dev) for s in ((T, B, N), (B, N), (B, N)))
    before = lsk.lstm_scan_bwd.launches
    got = lsk.lstm_scan_bwd(g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs,
                            reverse)
    torch.cuda.synchronize()
    assert lsk.lstm_scan_bwd.launches == before + 1
    want = lsk.lstm_scan_bwd_reference(g_hs, g_hT, g_cT, zx, R, hprev,
                                       cprev, cs, reverse)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    # gradients grow along the sweep: compare relative to their scale
    for g, w in zip(got, want):
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float() / scale, w.float() / scale,
                                   **SCAN_TOL[dtype])


@pytest.mark.parametrize('reverse', [False, True])
def test_lstm_scan_autograd_matches_plain_scan(dev, reverse):
    """LstmScan (K4 + K5 + the weight-gradient product) against autograd
    through the step-by-step lstm_scan in float32."""
    B, T, D, N = 9, 10, 24, 40
    rng = np.random.default_rng(3)

    def leaf(*shape, scale=1.0):
        return (torch.from_numpy((rng.standard_normal(shape) * scale)
                                 .astype(np.float32)).to(dev)
                .requires_grad_())

    xs, h0, c0 = leaf(B, T, D), leaf(B, N, scale=.2), leaf(B, N, scale=.2)
    w = {'kernel': leaf(D, 4 * N, scale=.3),
         'recurrent_kernel': leaf(N, 4 * N, scale=.3),
         'bias': leaf(4 * N, scale=.1)}
    wo, wh, wc = (leaf(*s).detach() for s in ((B, T, N), (B, N), (B, N)))
    leaves = [xs, h0, c0, *w.values()]

    def grads(fn):
        out, h, c = fn(xs, w, h0, c0, reverse=reverse)
        return torch.autograd.grad(
            (out * wo).sum() + (h * wh).sum() + (c * wc).sum(), leaves)

    assert lsk.fused_scan_supported(w)
    for g, r in zip(grads(lsk.lstm_scan_fused), grads(lstm_scan)):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-5)


def test_lstm_scan_kernel_refuses_what_it_cannot_take(dev):
    zx, R, h0, c0 = _scan_inputs(dev, torch.float32, 3, 2, 8)
    with pytest.raises(ValueError):
        lsk.lstm_scan_fwd(zx, R.cpu(), h0, c0)
    with pytest.raises(ValueError):
        lsk.lstm_scan_fwd(zx.double(), R.double(), h0.double(), c0.double())
    # a width that is no multiple of 8: the launcher reports it
    zx, R, h0, c0 = _scan_inputs(dev, torch.float32, 3, 2, 12)
    assert not lsk.fused_scan_supported({'recurrent_kernel': R})
    with pytest.raises(RuntimeError):
        lsk.lstm_scan_fwd(zx, R, h0, c0)
