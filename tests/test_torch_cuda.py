"""PyTorch port: the CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; skipped where no GPU is visible. This file imports no
JAX, so it also runs on a GPU machine without JAX, without the repo's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models.params import params_from_numpy
from cor_asv_ann_tpu_torch.models import seq2seq
from cor_asv_ann_tpu_torch.models.seq2seq import encode, ensure_onehot
from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
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
@pytest.mark.parametrize('B,D,W', [
    (5, 24, 40), (100, 512, 512), (1, 512, 512), (1, 1024, 512),
    (16, 512, 512), (16, 1024, 512), (256, 512, 512), (256, 1024, 512),
    (257, 512, 512), (257, 1024, 512)])
def test_lstm_step_kernel(dev, dtype, tol, B, D, W):
    """Greedy serving's batches (1, 16), the decoder's B = 256 with the
    lower layers' D = W and the top cell's D = W + A, a ragged row tile
    (257, 100) and ragged width tiles; f32 differs from the plain version
    only in summation order, bf16 by at most one ulp of the rounded
    products."""
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


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize('br,us', [(16, 8), (32, 16), (64, 16)])
def test_lstm_step_kernel_imposed_tiles(dev, dtype, tol, br, us):
    """Row tiles and unit slices the launcher may pick, imposed at B =
    100, D = 1024, W = 512 (ragged row tiles): each against the plain
    version, and two launches of one tile give the same bits (a small
    tile splits the reduction among warps, in a fixed order)."""
    from cor_asv_ann_tpu_torch.ops.lstm_step_kernel import step_plan
    rng = np.random.default_rng(1)
    B, D, W = 100, 1024, 512
    arrays = [rng.uniform(-1, 1, (B, D)), rng.uniform(-1, 1, (B, W)),
              rng.uniform(-1, 1, (B, W)), rng.normal(0, 0.05, (D, 4 * W)),
              rng.normal(0, 0.05, (W, 4 * W)), rng.normal(0, 0.5, (4 * W,))]
    args = [torch.from_numpy(a.astype(np.float32)).to(dtype).to(dev)
            for a in arrays]
    plan = step_plan(dtype, B, D, W, br, us)
    assert (plan['rows_per_tile'], plan['units_per_slice']) == (br, us)
    got = lstm_step_fused(*args, rows_per_tile=br, units_per_slice=us)
    again = lstm_step_fused(*args, rows_per_tile=br, units_per_slice=us)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = lstm_step(*args[:3], {'kernel': args[3],
                                 'recurrent_kernel': args[4],
                                 'bias': args[5]})
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                   rtol=0 if dtype == torch.float32 else tol)


def test_lstm_step_kernel_refuses_mixed_devices(dev):
    x = torch.zeros((2, 8), device=dev)
    h = torch.zeros((2, 4), device=dev)
    with pytest.raises(ValueError):
        lstm_step_fused(x, h, h, torch.zeros((8, 16)),
                        torch.zeros((4, 16), device=dev),
                        torch.zeros((16,), device=dev))


_K1_MAPPING = CharMapping.from_texts(["abcdefgh .,\n"])
_K1_WORDS = ["abba", "dig.", "hi.", "deaf", "bad", "cab.", "gag.", "fed,",
             "a", "bed", "hag."]


@functools.lru_cache(maxsize=None)
def _k1_params(width, mask_padding):
    """A random d2 model of `width` with a sharpened readout (margins well
    above summation-order noise), as numpy arrays."""
    config = Seq2SeqConfig(width=width, depth=2,
                           voc_size=_K1_MAPPING.voc_size,
                           mask_padding=mask_padding)
    params = init_params(config, seed=11)
    params['char_embedding']['kernel'] *= 300.0
    return config, params


def _k1_args(dev, B, width, mask_padding, T=32, S=None):
    """decode_loop's arguments for B lines of ragged lengths (line 2 empty)
    through the encoder of `_k1_params`."""
    config, params = _k1_params(width, mask_padding)
    pt = params_from_numpy(params, dev, torch.bfloat16)
    rng = np.random.default_rng(B)
    lines = [" ".join(rng.choice(_K1_WORDS, rng.integers(1, 5))) + "\n"
             for _ in range(B)]
    if B > 2:
        lines[2] = ""
    enc = torch.from_numpy(lines_to_index_batch(_K1_MAPPING, lines, pad_to=T,
                                                bucketed=False)).to(dev)
    onehot = ensure_onehot(enc, config, pt)
    attended, states, u = encode(pt, config, onehot)
    live = onehot.reshape(B, -1).ne(0).any(dim=1).to(torch.int32)
    mask = (onehot.ne(0).any(dim=2).to(torch.int32) if mask_padding
            else torch.ones((B, T), dtype=torch.int32, device=dev))
    return pt, config, (attended, u, states, live, mask,
                        dlk.decoder_weights(pt), _K1_MAPPING.get('\n'),
                        2 * T if S is None else S, config.window_width)


def _k1_agree(got, want):
    """Equal indices and lengths, or, where summation order flips a near
    tie, equal chosen probabilities (within 2e-2) up to the first
    divergence."""
    idx_k, prob_k, len_k, _ = got
    idx_r, prob_r, len_r, _ = want
    for b in range(idx_r.shape[0]):
        L = int(len_r[b])
        if int(len_k[b]) == L and torch.equal(idx_k[b, :L], idx_r[b, :L]):
            continue
        d = int(torch.nonzero(idx_k[b] != idx_r[b])[0])
        torch.testing.assert_close(prob_k[b, :d + 1], prob_r[b, :d + 1],
                                   atol=2e-2, rtol=0)


@pytest.mark.parametrize('mask_padding', [False, True])
@pytest.mark.parametrize('width', [64, 512])
@pytest.mark.parametrize('B', [1, 5, 16, 17, 40])
def test_decode_loop_kernel(dev, mask_padding, width, B):
    """K1 against its plain twin on the card: random d2 models with a
    sharpened readout at W = 64 and the flagship's 512, one tile of 1, 5
    or 16 lines, or 17 and 40 lines in tiles of 16 run in turn; an empty
    line among them."""
    pt, config, args = _k1_args(dev, B, width, mask_padding)
    assert dlk.fused_greedy_supported(pt, config, 32)
    before = dlk.decode_loop.launches
    got = dlk.decode_loop(*args)
    torch.cuda.synchronize()
    assert dlk.decode_loop.launches == before + -(-B // 16)
    want = dlk.decode_loop_reference(*args)
    if B > 2:
        assert int(got[2][2]) == 0 and float(got[3][2]) == 0.0
    _k1_agree(got, want)


@pytest.mark.parametrize('mask_padding', [False, True])
@pytest.mark.parametrize('B', [5, 17])
def test_decode_loop_kernel_widest(dev, mask_padding, B):
    """W = A = 768, the widest the card's shared memory holds: 128 unit
    blocks leave two attention blocks of 8 lines each, whose windows do not
    all fit in shared memory, so the lines beyond the prefetched ones load
    theirs when their attention starts."""
    pt, config, args = _k1_args(dev, B, 768, mask_padding)
    assert dlk.fused_greedy_supported(pt, config, 32)
    plan = dlk.decode_loop_plan(768, 768, config.voc_size,
                                config.window_width, lines=16)
    assert plan['unit_blocks'] == 128 and plan['line_blocks'] == 2
    got = dlk.decode_loop(*args)
    torch.cuda.synchronize()
    _k1_agree(got, dlk.decode_loop_reference(*args))


@pytest.mark.parametrize('mask_padding', [False, True])
def test_decode_loop_kernel_longest_t(dev, mask_padding):
    """The longest bucket `max_decode_t` admits at W = 64 (65,536
    positions; the kernel keeps only the window), 40 steps of 3 lines on
    random encoder rows and weights. Serving sends the kernel buckets up
    to 256 only (`loop_covers`)."""
    config, params = _k1_params(64, mask_padding)
    pt = params_from_numpy(params, dev, torch.bfloat16)
    W, V, ww = 64, config.voc_size, config.window_width
    T = dlk.max_decode_t(W, config.attended_size, V, ww, dev)
    assert T == 65536
    assert dlk.fused_greedy_supported(pt, config, 256)
    assert not dlk.fused_greedy_supported(pt, config, 257)
    gen = torch.Generator().manual_seed(3)
    mk = lambda *shape: (torch.randn(*shape, generator=gen) * 0.5).to(
        torch.bfloat16).to(dev)
    B = 3
    states = [(mk(B, W), mk(B, W)) for _ in range(2)]
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    if mask_padding:
        mask[1, 20:] = 0
    live = torch.ones((B,), dtype=torch.int32, device=dev)
    args = (mk(B, T, config.attended_size), mk(B, T, W), states, live, mask,
            dlk.decoder_weights(pt), _K1_MAPPING.get('\n'), 40, ww)
    got = dlk.decode_loop(*args)
    torch.cuda.synchronize()
    _k1_agree(got, dlk.decode_loop_reference(*args))


def test_decode_loop_kernel_equal_bits(dev):
    """Two launches at the flagship's width give the same bits (fixed
    summation order, no atomics in any sum), with the launcher's split and
    with imposed ones; another split sums in another order and agrees by
    the near-tie rule."""
    _, _, args = _k1_args(dev, 16, 512, True)
    first = dlk.decode_loop(*args)
    for us in (0, 4, 5):
        got = dlk.decode_loop(*args, units_per_block=us)
        again = dlk.decode_loop(*args, units_per_block=us)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        _k1_agree(got, first)


def test_decode_loop_limits(dev):
    """What `fused_greedy_supported` accepts and the launcher takes: the
    flagship and every width that is a multiple of 8 up to 768, with the
    flagship's `max_decode_t` past 22,600 positions (serving stops at
    256); not W = 1024, whose weights the SMs' shared memory does not
    hold, nor a grid of more blocks than SMs."""
    from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig as C
    emb = {'char_embedding': {'kernel': torch.zeros(
        (45, 8), dtype=torch.bfloat16, device=dev)}}
    for W in range(8, 769, 8):
        assert dlk.fused_greedy_supported(emb, C(width=W, depth=2,
                                                 voc_size=45), 64), W
    flagship = C(width=512, depth=2, voc_size=45)
    assert dlk.max_decode_t(512, 512, 45, 5, dev) >= 22600
    assert dlk.fused_greedy_supported(emb, flagship, 256)
    assert not dlk.fused_greedy_supported(emb, flagship, 257)
    assert not dlk.fused_greedy_supported(emb, C(width=1024, depth=2,
                                                 voc_size=45), 64)
    plan = dlk.decode_loop_plan(512, 512, 45, 5)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan['unit_blocks'] + 2 * plan['line_blocks'] <= n_sm
    assert dlk.decode_loop_plan(512, 512, 45, 5, units_per_block=2) is None
    _, _, args = _k1_args(dev, 2, 64, False)
    with pytest.raises(RuntimeError):
        dlk.decode_loop(*args, units_per_block=17)


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


def test_long_lines_skip_k1_and_k3(dev):
    """bfloat16 serving sends buckets up to 256 to K1 (greedy) and K3
    (beam), longer ones to the windowed decoder and the per-op beam step,
    whose window positions follow the JAX package's there
    (tests/test_torch_long_lines.py)."""
    from cor_asv_ann_tpu_torch.models import beam
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    mapping = CharMapping.from_texts(["abcdefgh .,\n"])
    s2s = Sequence2Sequence(device=dev)
    s2s.width, s2s.depth, s2s.mapping = 64, 2, mapping
    s2s.configure()
    s2s.status = 2
    s2s.compute = 'bfloat16'
    pt = s2s._infer_params()
    assert beam._step_kernel_route(pt, s2s.config, False, 256)
    assert not beam._step_kernel_route(pt, s2s.config, False, 257)
    for chars, bucket, k1 in ((200, 256, 1), (300, 384, 0)):
        lines = [('abba dig. ' * 40)[:chars] + '\n'] * 2
        before = dlk.decode_loop.launches
        out, _, _, _ = s2s.correct_lines(lines, return_alignments=False)
        assert len(out) == 2
        assert dlk.decode_loop.launches - before == k1, bucket
        before = dsk.fused_decode_step_indexed.launches
        s2s.correct_lines(lines, fast=False, greedy=False,
                          return_alignments=False)
        assert (dsk.fused_decode_step_indexed.launches > before) == bool(k1)


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
@pytest.mark.parametrize('T,B,N', [(7, 5, 40), (12, 9, 520), (16, 64, 512),
                                   (16, 256, 1024), (9, 1, 512)])
def test_lstm_scan_fwd_kernel(dev, dtype, reverse, T, B, N):
    """K4 against its plain version: a width padded along the reduction
    (N=40), slices that do not divide the width (N=520), the flagship's
    width, the widest layer at the training batch (N=1024, B=256) and a
    single row.
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
@pytest.mark.parametrize('T,B,N', [(7, 5, 40), (16, 64, 512),
                                   (16, 256, 1024), (9, 1, 512)])
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_lstm_scan_kernels_repeat_their_bits(dev, dtype):
    """Two launches of K4, and of K5, give the same bits: every sum runs
    in a fixed order, the blocks only exchange finished values."""
    T, B, N = 16, 256, 512
    zx, R, h0, c0 = _scan_inputs(dev, dtype, T, B, N, seed=4)
    first = lsk.lstm_scan_fwd(zx, R, h0, c0)
    second = lsk.lstm_scan_fwd(zx, R, h0, c0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    hs, cs = first[:2]
    g = torch.full_like(hs, 0.01)
    args = (g, g[0], g[0], zx, R, _shift(hs, h0, False),
            _shift(cs, c0, False), cs)
    for a, b in zip(lsk.lstm_scan_bwd(*args), lsk.lstm_scan_bwd(*args)):
        assert torch.equal(a, b)


def test_lstm_scan_grid_that_cannot_be_co_resident_raises(dev):
    """A grid of more blocks than the card holds at once: the cooperative
    launch is refused and the wrapper raises, rather than hanging on a
    barrier that some blocks never reach."""
    T, B, N = 3, 1024, 1024
    zx, R, h0, c0 = _scan_inputs(dev, torch.bfloat16, T, B, N)
    # 64 groups of 16 rows x 128 slices of 8 units
    with pytest.raises(RuntimeError):
        lsk._scan_fwd(zx, R, h0, c0, False, rows_per_group=16,
                      units_per_slice=8)
    plan = lsk.scan_plan('fwd', torch.bfloat16, B, N)
    assert plan['groups'] * plan['slices'] <= \
        torch.cuda.get_device_properties(dev).multi_processor_count


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


def _teacher_inputs(dev, dtype, B, Td, T, W, A, with_masks, seed=0):
    """K6's inputs in its own order (without ww)."""
    rng = np.random.default_rng(seed)

    def mk(shape, scale, dt=dtype):
        return (torch.from_numpy(rng.normal(0, scale, shape)
                                 .astype(np.float32)).to(dt).to(dev))

    zx = mk((Td, B, 4 * W), 1.0, torch.float32)
    u, att = mk((B, T, W), 0.5), mk((B, T, A), 0.5)
    Kc, R = mk((A, 4 * W), A ** -0.5), mk((W, 4 * W), W ** -0.5)
    W_a, v = mk((W, W), W ** -0.5), mk((1, W), 2 * W ** -0.5)
    b_UW, b_v = mk((1, W), 0.1), mk((1, 1), 0.1, torch.float32)
    bias = mk((1, 4 * W), 0.1)
    maskc = (torch.from_numpy(((rng.random((4, B, A)) < 0.8) / 0.8)
                              .astype(np.float32)).to(dtype).to(dev)
             if with_masks else
             torch.ones((4, B, A), dtype=dtype, device=dev))
    h0, c0 = mk((B, W), 0.2), mk((B, W), 0.2)
    return [zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0]


# (B, Td, T, W, A, ww): odd batches, T != Td, widths that leave threads to
# split a product's reduction and the flagship's widths
TEACHER_SHAPES = [(5, 7, 16, 40, 24, 5), (9, 6, 30, 512, 512, 5),
                  (3, 5, 9, 64, 128, 2)]
# float32: summation order, expf/tanhf against PyTorch's; bfloat16: an ulp
# of a gate carried along the sweep. A row whose window centre lies within
# the third number (relative) of an integer may see another window.
TEACHER_TOL = {torch.float32: (2e-5, 1e-5, 1e-5),
               torch.bfloat16: (2e-2, 2e-2, 2e-2)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_masks', [False, True])
@pytest.mark.parametrize('B,Td,T,W,A,ww', TEACHER_SHAPES)
def test_teacher_fwd_kernel(dev, dtype, with_masks, B, Td, T, W, A, ww):
    """K6 against its plain version."""
    ins = _teacher_inputs(dev, dtype, B, Td, T, W, A, with_masks)
    before = tk.teacher_fwd.launches
    got = tk.teacher_fwd(*ins, ww)
    torch.cuda.synchronize()
    assert tk.teacher_fwd.launches == before + 1
    want = tk.teacher_fwd_reference(*ins, ww)
    assert all(g.dtype == dtype and g.shape == w.shape
               for g, w in zip(got, want))
    _, share = tk.teacher_fwd_agreement(got, want, *TEACHER_TOL[dtype])
    assert share >= (0.99 if dtype == torch.float32 else 0.9)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,Td,T,W,A,with_masks', [
    (300, 6, 20, 512, 512, True),      # ragged 64-row tiles
    (64, 256, 256, 64, 128, False),    # a sweep at T >= 192
])
def test_teacher_fwd_kernel_long_and_ragged(dev, dtype, B, Td, T, W, A,
                                            with_masks):
    """K6 at a batch that is no multiple of its row tiles, and over a
    sweep of 256 steps."""
    ins = _teacher_inputs(dev, dtype, B, Td, T, W, A, with_masks, seed=4)
    got = tk.teacher_fwd(*ins, 5)
    torch.cuda.synchronize()
    want = tk.teacher_fwd_reference(*ins, 5)
    _, share = tk.teacher_fwd_agreement(got, want, *TEACHER_TOL[dtype])
    assert share >= (0.99 if dtype == torch.float32 else 0.9)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_teacher_fwd_kernel_repeats_its_bits(dev, dtype):
    """No atomics in any sum: two launches on the same inputs agree bit
    for bit."""
    ins = _teacher_inputs(dev, dtype, 70, 9, 24, 512, 512, True, seed=4)
    first = tk.teacher_fwd(*ins, 5)
    second = tk.teacher_fwd(*ins, 5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _teacher_bwd_case(dev, dtype, B, Td, T, W, A, ww, with_masks, seed=4):
    """K7's arguments on the residuals the plain K6 saved, and its plain
    result."""
    ins = _teacher_inputs(dev, dtype, B, Td, T, W, A, with_masks, seed=seed)
    zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0 = ins
    hs, cs, aa, zs = tk.teacher_fwd_reference(*ins, ww)
    g = (torch.from_numpy(np.random.default_rng(seed + 1)
                          .normal(0, 0.1, hs.shape).astype(np.float32))
         .to(dtype).to(dev))
    args = (zs, g, _shift(hs, h0, False), _shift(cs, c0, False), cs, aa, u,
            att, Kc, R, W_a, v, b_UW, maskc, ww)
    return args, tk.teacher_bwd_reference(*args)


def _assert_teacher_bwd_close(got, want, dtype):
    atol, rtol, _ = TEACHER_TOL[dtype]
    for g_, w in zip(got, want):
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g_.float() / scale, w.float() / scale,
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('with_masks', [False, True])
@pytest.mark.parametrize('B,Td,T,W,A,ww', TEACHER_SHAPES)
def test_teacher_bwd_kernel(dev, dtype, with_masks, B, Td, T, W, A, ww):
    """K7 against its plain version on the residuals the plain K6 saved."""
    args, want = _teacher_bwd_case(dev, dtype, B, Td, T, W, A, ww, with_masks,
                                   seed=1)
    before = tk.teacher_bwd.launches
    got = tk.teacher_bwd(*args)
    torch.cuda.synchronize()
    assert tk.teacher_bwd.launches == before + 1
    assert [g_.dtype for g_ in got] == [dtype] * 4 + [torch.float32] * 5
    _assert_teacher_bwd_close(got, want, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,Td,T,W,A,with_masks', [
    (300, 6, 20, 512, 512, True),      # ragged 64-row tiles
    (64, 256, 256, 64, 128, False),    # the first check at T >= 192
])
def test_teacher_bwd_kernel_long_and_ragged(dev, dtype, B, Td, T, W, A,
                                            with_masks):
    """K7 at a batch that is no multiple of its row tile, and over a
    sweep of 256 steps."""
    args, want = _teacher_bwd_case(dev, dtype, B, Td, T, W, A, 5, with_masks)
    got = tk.teacher_bwd(*args)
    torch.cuda.synchronize()
    _assert_teacher_bwd_close(got, want, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_teacher_bwd_kernel_repeats_its_bits(dev, dtype):
    """No atomics in any sum: two launches on the same inputs agree bit
    for bit."""
    args, _ = _teacher_bwd_case(dev, dtype, 70, 9, 24, 512, 512, 5, True)
    first = tk.teacher_bwd(*args)
    second = tk.teacher_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_teacher_kernels_at_the_widest_width(dev):
    """W = A = 1024, the widest width that K6 took before its stage
    kernels: K6 and K7 against their plain versions."""
    B, Td, T, W, A, ww = 5, 4, 12, 1024, 1024, 5
    ins = _teacher_inputs(dev, torch.bfloat16, B, Td, T, W, A, True, seed=6)
    top = {'cell': {'recurrent_kernel': ins[4]}}
    assert tk.teacher_fused_supported(top, B, Td, T, W, A, False, ww)
    got = tk.teacher_fwd(*ins, ww)
    want = tk.teacher_fwd_reference(*ins, ww)
    tk.teacher_fwd_agreement(got, want, *TEACHER_TOL[torch.bfloat16])
    args, want = _teacher_bwd_case(dev, torch.bfloat16, B, Td, T, W, A, ww,
                                   True, seed=6)
    _assert_teacher_bwd_close(tk.teacher_bwd(*args), want, torch.bfloat16)


@pytest.mark.parametrize('with_masks', [False, True])
def test_teacher_autograd_matches_dense_body(dev, with_masks):
    """TeacherTopFused (K6 + K7 + the outside contractions) against
    autograd through the dense per-step body in float32."""
    B, Td, T, W, A, ww = 9, 10, 20, 40, 24, 5
    rng = np.random.default_rng(3)

    def leaf(*shape, scale=0.18):
        return (torch.from_numpy(rng.normal(0, scale, shape)
                                 .astype(np.float32)).to(dev)
                .requires_grad_())

    top = {'W_a': leaf(W, W), 'v_a': leaf(W, 1), 'b_UW': leaf(W),
           'b_v': leaf(1),
           'cell': {'kernel': leaf(W + A, 4 * W),
                    'recurrent_kernel': leaf(W, 4 * W),
                    'bias': leaf(4 * W)}}
    xs, att, u = leaf(B, Td, W), leaf(B, T, A), leaf(B, T, W)
    h0, c0 = leaf(B, W), leaf(B, W)
    masks = (torch.from_numpy(((rng.random((4, B, W + A)) < 0.8) / 0.8)
                              .astype(np.float32)).to(dev)
             if with_masks else None)
    leaves = [top['W_a'], top['v_a'], top['b_UW'], top['b_v'],
              *top['cell'].values(), xs, att, u, h0, c0]
    assert tk.teacher_fused_supported(top, B, Td, T, W, A, False, ww)
    before = tk.teacher_fwd.launches, tk.teacher_bwd.launches
    out = tk.teacher_top_fused(top, xs, att, u, h0, c0, masks, ww)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    assert (tk.teacher_fwd.launches, tk.teacher_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = seq2seq._teacher_body(top, xs, att, u, h0, c0, masks, ww, 0, None)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    want = torch.autograd.grad((ref ** 2).sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)


def test_teacher_kernel_refuses_what_it_cannot_take(dev):
    ins = _teacher_inputs(dev, torch.float32, 3, 4, 9, 16, 24, False)
    ok = tk.teacher_fwd(*ins, 2)
    assert ok[0].shape == (4, 3, 16)
    # a non-contiguous tensor
    bad = list(ins)
    bad[1] = ins[1].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        tk.teacher_fwd(*bad, 2)
    # a misaligned one: a view that starts 4 bytes into its storage
    bad = list(ins)
    bad[2] = torch.zeros(ins[2].numel() + 1, device=dev)[1:].view_as(ins[2])
    with pytest.raises(ValueError):
        tk.teacher_fwd(*bad, 2)
    # mixed devices, a dtype the kernels do not take, shapes that disagree
    bad = list(ins)
    bad[4] = ins[4].cpu()
    with pytest.raises(ValueError):
        tk.teacher_fwd(*bad, 2)
    with pytest.raises(ValueError):
        tk.teacher_fwd(ins[0], *(t.double() for t in ins[1:]), 2)
    bad = list(ins)
    bad[11] = ins[11][:2].contiguous()
    with pytest.raises(ValueError):
        tk.teacher_fwd(*bad, 2)
    # the gate: widths, window, padding mask
    top = {'cell': {'recurrent_kernel': ins[4]}}
    assert tk.teacher_fused_supported(top, 3, 4, 9, 16, 24, False, 2)
    assert tk.teacher_fused_supported(top, 256, 128, 128, 512, 512, False)
    assert not tk.teacher_fused_supported(top, 3, 4, 9, 16, 24, True, 2)
    assert not tk.teacher_fused_supported(top, 3, 4, 9, 16, 24, False, 0)
    assert not tk.teacher_fused_supported(top, 3, 4, 9, 12, 24, False, 2)
    # no width is kept in shared memory
    assert tk.teacher_fused_supported(top, 3, 4, 9, 2048, 2048, False)
    # a width that is no multiple of 8: the launcher reports it
    ins12 = _teacher_inputs(dev, torch.float32, 3, 4, 9, 12, 24, False)
    with pytest.raises(RuntimeError):
        tk.teacher_fwd(*ins12, 2)


@pytest.mark.parametrize('compute', [None, 'bfloat16'])
def test_train_step_goes_through_the_teacher_kernels(dev, compute):
    """One K6 and one K7 launch per train_step without a padding mask,
    none with one, none with the kernels switched off."""
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.params import tree_map
    rng = np.random.default_rng(5)
    B, Tn, V = 6, 12, 14
    idx = rng.integers(1, V, size=(B, Tn))
    enc = np.eye(V, dtype=np.float32)[idx]
    dec_in = np.concatenate([np.zeros((B, 1, V), np.float32), enc], axis=1)
    dec_out = np.concatenate([enc, np.zeros((B, 1, V), np.float32)], axis=1)
    weights = (dec_out.sum(-1) > 0).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for mask_padding, mode, want in ((False, 'auto', 1), (True, 'auto', 0),
                                     (False, 'off', 0)):
        config = Seq2SeqConfig(width=64, depth=2, voc_size=V,
                               mask_padding=mask_padding)
        params = tree_map(lambda t: t.requires_grad_(),
                          params_from_numpy(init_params(config, seed=1),
                                            dev))
        opt = T.make_optimizer(params)
        before = tk.teacher_fwd.launches, tk.teacher_bwd.launches
        seq2seq._TEACHER_KERNEL = mode
        try:
            loss = T.train_step(params, opt, config, enc, dec_in, dec_out,
                                weights, gen, compute_dtype=compute)
        finally:
            seq2seq._TEACHER_KERNEL = 'auto'
        assert bool(torch.isfinite(loss))
        assert (tk.teacher_fwd.launches - before[0],
                tk.teacher_bwd.launches - before[1]) == (want, want)


def _step_inputs(dev, wdtype, udtype, N, V, W, A, WIN, seed):
    """K3's activations and packed weights, at the scale a model's have;
    row 1 has no visible position."""
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    rng = np.random.default_rng(seed)

    def mk(shape, scale, dtype=torch.float32):
        return (torch.from_numpy(rng.normal(0, scale, shape)
                                 .astype(np.float32)).to(dtype).to(dev))

    fb = torch.softmax(mk((N, V), 3.0), dim=-1)
    states = [mk((N, W), .5) for _ in range(4)]
    u_w, att_w = mk((N, WIN, W), .5, udtype), mk((N, WIN, A), .5, udtype)
    visible = torch.from_numpy(rng.random((N, WIN)) < 0.8).to(dev)
    visible[:, 0] = True
    visible[1:2] = False
    shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W), b1=(4 * W,),
                  k2=(W + A, 4 * W), r2=(W, 4 * W), b2=(4 * W,),
                  W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,))
    weights = {k: mk(s, s[0] ** -0.5 if len(s) > 1 else .1,
                     torch.float32 if k in dsk._BIASES else wdtype)
               for k, s in shapes.items()}
    weights.update(dsk.kernel_layouts(weights))
    return [fb, *states, u_w, att_w, visible], weights


def _indexed_windows(dev, udtype, N, W, A, WIN, rows_per_line, T, seed):
    """u, attended (lines, T, .) and window starts for N rows: starts
    over the whole line, so windows run off its end (clamped at T - 1),
    and row 0 at 0."""
    rng = np.random.default_rng(seed)
    lines = -(-N // rows_per_line)
    u, att = (torch.from_numpy(rng.normal(0, .5, (lines, T, n))
                               .astype(np.float32)).to(udtype).to(dev)
              for n in (W, A))
    start = torch.from_numpy(rng.integers(0, max(T - WIN // 2, 1), N)
                             .astype(np.int32)).to(dev)
    start[0] = 0
    return u, att, start


@pytest.mark.parametrize('wdtype,udtype,tol', [
    (torch.float32, torch.float32, 2e-5),
    (torch.bfloat16, torch.bfloat16, 5e-3),
    (torch.bfloat16, torch.float32, 5e-3)])
@pytest.mark.parametrize('N,V,W,A,WIN', [(5, 11, 16, 24, 12),
                                         (770, 45, 512, 512, 12),
                                         (33, 200, 40, 8, 4)])
def test_decode_step_kernel(dev, wdtype, udtype, tol, N, V, W, A, WIN):
    """K3 against its plain version: N no multiple of the row tile, an
    all-masked row, V above W, the flagship's widths. float32 differs in
    summation order and expf/tanhf against PyTorch's (2e-5, the JAX
    package's bar for its kernel); with bfloat16 weights an operand that
    rounds the other way moves a sum by an ulp of bfloat16."""
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    acts, weights = _step_inputs(dev, wdtype, udtype, N, V, W, A, WIN, N)
    before = dsk.fused_decode_step.launches
    got = dsk.fused_decode_step(*acts, weights)
    torch.cuda.synchronize()
    assert dsk.fused_decode_step.launches == before + 1
    want = dsk.fused_decode_step_reference(*acts, weights)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=tol, rtol=0)
    if N > 1:
        assert float(got[5][1].abs().max()) == 0.0


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize('N,rows_per_line', [
    (512, 32), (768, 48), (4096, 32), (8192, 32), (12288, 48), (770, 5)])
def test_decode_step_kernel_both_forms(dev, dtype, tol, N, rows_per_line):
    """K3 at the rows of every beam step of the flagship's widths (chip
    smoke's STEP_ROWS: 16, 32 and 64-row tiles) and an odd N: the gathered
    and the indexed form against the plain version (float32 2e-5; bfloat16
    weights and windows 2e-3), and equal to each other bit for bit on the
    same window rows."""
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    V, W, A, WIN, T = 45, 512, 512, 12, 64
    acts, weights = _step_inputs(dev, dtype, dtype, N, V, W, A, WIN, N)
    u, att, start = _indexed_windows(dev, dtype, N, W, A, WIN,
                                     rows_per_line, T, N + 1)
    u_w, att_w = dsk.gather_windows(u, att, rows_per_line, start, WIN)
    gathered = acts[:5] + [u_w, att_w, acts[7]]
    before = (dsk.fused_decode_step.launches,
              dsk.fused_decode_step_indexed.launches)
    got_g = dsk.fused_decode_step(*gathered, weights)
    got_i = dsk.fused_decode_step_indexed(*acts[:5], u, att, rows_per_line,
                                          start, acts[7], weights)
    torch.cuda.synchronize()
    assert (dsk.fused_decode_step.launches,
            dsk.fused_decode_step_indexed.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = dsk.fused_decode_step_reference(*gathered, weights)
    for g, i, w in zip(got_g, got_i, want):
        assert torch.equal(g, i)
        torch.testing.assert_close(g, w, atol=tol, rtol=0)
    assert float(got_i[5][1].abs().max()) == 0.0


def test_decode_step_kernel_refuses_what_it_cannot_take(dev):
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    acts, weights = _step_inputs(dev, torch.float32, torch.float32, 4, 11,
                                 16, 24, 12, 0)
    with pytest.raises(ValueError, match='one CUDA device'):
        dsk.fused_decode_step(acts[0].cpu(), *acts[1:], weights)
    with pytest.raises(ValueError, match='weight k1'):
        dsk.fused_decode_step(*acts, dict(weights, k1=weights['k1'].t()))
    # ragged widths are beyond the 16-byte loads
    acts, weights = _step_inputs(dev, torch.float32, torch.float32, 4, 11,
                                 12, 24, 12, 0)
    with pytest.raises(ValueError, match='beyond the kernel'):
        dsk.fused_decode_step(*acts, weights)


def test_top_k_is_stable_on_the_card(dev):
    """The beam's top-k keeps the lowest index first among equal values
    on the card as on the CPU."""
    from cor_asv_ann_tpu_torch.models.beam import _top_k
    x = torch.full((64, 800), -float('inf'))
    x[:, 5::7] = -1.0
    x[:, 3] = 0.5
    v_cpu, i_cpu = _top_k(x, 32)
    v_dev, i_dev = _top_k(x.to(dev), 32)
    assert torch.equal(i_dev.cpu(), i_cpu) and torch.equal(v_dev.cpu(), v_cpu)
    assert i_cpu[0, :4].tolist() == [3, 5, 12, 19]


@pytest.mark.parametrize('compute', ['float32', 'bfloat16'])
def test_beam_through_the_step_kernel(dev, compute):
    """decode_beam on the card through K3 ('on') against the per-op route
    ('off') on a peaked w64 model: one launch per beam iteration, the same
    1-best texts, costs within 1e-3 (float32) or 5e-2 (bfloat16 states)."""
    from cor_asv_ann_tpu_torch.models import beam
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    mapping = CharMapping.from_texts(["abcdefgh .,\n"])
    config = Seq2SeqConfig(width=64, depth=2, voc_size=mapping.voc_size)
    params = init_params(config, seed=11)
    params['char_embedding']['kernel'] *= 300.0
    pt = params_from_numpy(params, dev,
                           torch.bfloat16 if compute == 'bfloat16' else None)
    lines = ["abba dig.\n", "hi.\n", "", "deaf bad cab.\n", "gag.\n"]
    enc = torch.from_numpy(lines_to_index_batch(mapping, lines, pad_to=32,
                                                bucketed=False)).to(dev)
    src_len = np.array([len(line) for line in lines], np.int32)
    bp = beam.BeamParams(reservoir=32, expand=16, beam_width_in=6,
                         beam_width_out=4)
    out = {}
    for mode in ('off', 'on'):
        beam._BEAM_STEP_KERNEL = mode
        try:
            before = (dsk.fused_decode_step.launches,
                      dsk.fused_decode_step_indexed.launches)
            out[mode] = beam.decode_beam(pt, config, bp, enc,
                                         mapping.get('\n'), src_len,
                                         return_trace=True)
            # the beam reads the window rows by index: no gathered launch
            assert dsk.fused_decode_step.launches == before[0]
            launched = dsk.fused_decode_step_indexed.launches - before[1]
        finally:
            beam._BEAM_STEP_KERNEL = 'auto'
        assert launched == (out[mode]['trace']['t'] if mode == 'on' else 0)
    off, on = out['off'], out['on']
    assert torch.equal(off['count'], on['count']) and int(on['count'][2]) == 0
    assert torch.equal(off['length'][:, 0], on['length'][:, 0])
    assert torch.equal(off['idx'][:, 0], on['idx'][:, 0])
    live = torch.isfinite(off['cum'][:, 0])
    torch.testing.assert_close(
        on['cum'][:, 0][live], off['cum'][:, 0][live], rtol=0,
        atol=1e-3 if compute == 'float32' else 5e-2)
    # bfloat16 parameters take the kernel under 'auto' as well
    if compute == 'bfloat16':
        assert beam._step_kernel_route(pt, config, False, enc.shape[1])
