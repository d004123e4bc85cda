#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cor_asv_ann_tpu_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
port's CUDA kernels from ``cor_asv_ann_tpu_torch/csrc`` into
``build/kernels/`` (six sources), holds each of the seven kernels
against its plain PyTorch version at the shapes the main paths give it,
and drives the three paths of the port:

- greedy serving of the bundled d2/w512 model
  (``testmodels/flagship.d2.w512.synthetic.h5``) through
  ``Sequence2Sequence.correct_lines`` at float32 and bfloat16, checked
  against the repo's goldens (the decode-loop and LSTM-step kernels);
- training of a d2/w512 model at batch 256 on a synthetic corpus through
  ``train_step`` and ``Sequence2Sequence.train`` in float32 and bfloat16,
  with and without masked padding, then saving the model, loading it
  back and serving from the file (the LSTM scan kernels and, without
  masked padding, the fused teacher-layer kernels, forward and backward),
  and steps at T = Td = 128 with the teacher kernels on and off;
- beam serving of the flagship through ``correct_lines(greedy=False)``:
  float32 on the per-op route against every beam golden of the repo,
  float32 and bfloat16 through the fused decode-step kernel, and the
  ``proc`` and ``eval`` command lines as modules;
- ocrd-cor-asv-ann-process of the flagship on a PAGE-XML workspace
  (``python -m cor_asv_ann_tpu_torch.wrapper.transcode`` on the default
  device) against the JAX processor's golden
  (``tests/golden_page_process.json``), the port's evaluate on its
  output, the beam in bfloat16 through the fused decode-step kernel, and
  the processor server;
- the bf16 beam of the flagship on 16 lines of 300-400 characters (the
  384 bucket, ``long_beam_path``): through the fused decode-step kernel,
  one launch an iteration, and on the per-op route, every K3 step held
  against the per-op step on the same inputs (with a control, K3 given
  window starts one late, that must fail), and timed in turns;
- the measurement and tuning surface (``tuning_path``): the fused-decode
  autotune of the flagship in bfloat16 at B = 16-256 and by default, the
  decode-loop kernel against the per-op decode through ``correct_lines``
  at B = 32, 64 and 256, a batch of 300-400-character lines that the
  kernel must not take, ``proc -f --autotune-fused --torch-trace`` and
  ``eval --torch-trace`` as modules (the trace must name the kernel), and
  an LM converted by ``scripts.transfer_dta_lm`` loaded into a d2/w512
  model that takes two training steps;
- the multi-device layer (``mesh_path``): a world of 1 on NCCL serving
  the flagship through ``use_mesh()``, a bf16 mesh ``train_step`` through
  K4-K7 and ``proc --mesh -1``; two ranks sharing the card through gloo,
  each taking its 128 rows of an f32 and a bf16 ``train_step`` at B = 256
  and serving the golden lines, held against one process.

It shows that each path launched its kernels, and times the kernels.
Any failed check raises, so the script exits non-zero. It imports
nothing of JAX and nothing of the JAX package.

Output: the card's name and power limit, one JSON line ``{"kernels":
[...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, 'testmodels', 'flagship.d2.w512.synthetic.h5')
ARTIFACT = os.path.join(ROOT, 'testmodels', 'reference_trained.w64.h5')

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError('check failed: ' + msg)


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` runs after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load_model(device, compute='float32', filename=FLAGSHIP,
               keras_padding=False):
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    s2s = Sequence2Sequence(device=device)
    # the padding mode is the caller's choice, not part of the file
    s2s.keras_padding = keras_padding
    s2s.load_config(filename)
    s2s.configure()
    s2s.load_weights(filename)
    s2s.compute = compute
    return s2s


def _dtype_name(dt):
    return str(dt).split('.')[-1]


def phase_k2(torch, dev):
    """K2 against its plain version at the decoder's shapes: greedy
    serving's batches (1, 16), the B=256 batch and a ragged row tile
    (257), the lower layers' D = W and the top cell's D = W + A, with the
    tile the launcher picks for each."""
    from cor_asv_ann_tpu_torch.ops.lstm import lstm_step
    from cor_asv_ann_tpu_torch.ops.lstm_step_kernel import (lstm_step_fused,
                                                            step_plan)
    gen = torch.Generator().manual_seed(0)
    W = 512
    errs = {}
    for dt, tol in ((torch.float32, dict(atol=1e-5, rtol=0.0)),
                    (torch.bfloat16, dict(atol=1e-2, rtol=1e-2))):
        for B in (1, 16, 256, 257):
            for D in (512, 1024):
                def mk(*shape, scale=None):
                    v = (torch.rand(*shape, generator=gen) * 2 - 1
                         if scale is None
                         else torch.randn(*shape, generator=gen) * scale)
                    return v.to(dt).to(dev)
                x, h, c = mk(B, D), mk(B, W), mk(B, W)
                K, R = mk(D, 4 * W, scale=0.05), mk(W, 4 * W, scale=0.05)
                b = mk(4 * W, scale=0.5)
                hk, ck = lstm_step_fused(x, h, c, K, R, b)
                torch.cuda.synchronize()
                hp, cp = lstm_step(x, h, c, {'kernel': K,
                                             'recurrent_kernel': R,
                                             'bias': b})
                for got, want in ((hk, hp), (ck, cp)):
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                err = max((hk.float() - hp.float()).abs().max().item(),
                          (ck.float() - cp.float()).abs().max().item())
                errs[(_dtype_name(dt), B, D)] = err
                plan = step_plan(dt, B, D, W)
                print('K2 %-8s B=%-3d D=%-4d tile %d rows x %d units (%d x %d '
                      'blocks): max|kernel-plain| = %.3g'
                      % (_dtype_name(dt), B, D, plan['rows_per_tile'],
                         plan['units_per_slice'], plan['row_tiles'],
                         plan['unit_slices'], err))
    return errs


def phase_k1(torch, dev, goldens, corpus):
    """K1 against the plain bf16 decode and against its plain twin."""
    from cor_asv_ann_tpu_torch.models.seq2seq import encode, ensure_onehot
    from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
    from cor_asv_ann_tpu_torch.utils.data import lines_to_index_batch
    s2s = load_model(dev, 'bfloat16')
    batches = [corpus[:16], goldens['inputs'][:16], goldens['inputs'][16:]]
    for lines in batches:
        s2s.fused_decode = True
        before = dlk.decode_loop.launches
        out_k, _, sc_k, _ = s2s.correct_lines(list(lines),
                                              return_alignments=False)
        check(dlk.decode_loop.launches > before,
              'bf16 batch of %d lines did not go through K1' % len(lines))
        s2s.fused_decode = False
        out_p, _, sc_p, _ = s2s.correct_lines(list(lines),
                                              return_alignments=False)
        check(out_k == out_p, 'K1 text differs from the plain bf16 decode: '
              '%s' % [(a, b) for a, b in zip(out_k, out_p) if a != b])
        d = max(abs(a - b) for a, b in zip(sc_k, sc_p))
        check(d <= 5e-3, 'K1 scores differ from the plain bf16 decode by '
              '%g > 5e-3' % d)
        print('K1 vs plain bf16 decode: %d lines byte-equal, max score '
              'diff %.3g' % (len(lines), d))
    # K1 against decode_loop_reference on the card, same encoded inputs
    params = s2s._infer_params()
    config = s2s.config
    nl = s2s.mapping.get('\n')
    enc = torch.from_numpy(lines_to_index_batch(
        s2s.mapping, corpus[:16], pad_to=64)).to(dev)
    enc = ensure_onehot(enc, config, params)
    attended, states, u = encode(params, config, enc)
    live = enc.reshape(16, -1).ne(0).any(dim=1).to(torch.int32)
    mask = enc.ne(0).any(dim=2).to(torch.int32)
    weights = dlk.decoder_weights(params)
    args = (attended, u, states, live, mask, weights, nl, 128,
            config.window_width)
    idx_k, prob_k, len_k, sc_k = dlk.decode_loop(*args)
    torch.cuda.synchronize()
    idx_r, prob_r, len_r, sc_r = dlk.decode_loop_reference(*args)
    check(torch.equal(idx_k, idx_r) and torch.equal(len_k, len_r),
          'K1 indices/lengths differ from decode_loop_reference')
    err = (prob_k - prob_r).abs().max().item()
    check(err <= 1e-2, 'K1 probs differ from decode_loop_reference by %g'
          % err)
    sd = ((sc_k - sc_r) / len_k.clamp(min=1)).abs().max().item()
    check(sd <= 5e-3, 'K1 scores differ from decode_loop_reference by %g'
          % sd)
    print('K1 vs decode_loop_reference: indices equal, max prob diff %.3g, '
          'max score diff %.3g' % (err, sd))
    return err, args


def main_path(torch, dev, goldens, corpus):
    """The port's main path: greedy serving through correct_lines, f32
    (plain and with the LSTM-step kernel) and bf16 at B <= 16."""
    art_gold = load_json('testmodels', 'reference_trained.goldens.json')
    s2s = load_model(dev)
    out, _, sc, _ = s2s.correct_lines(list(goldens['inputs']),
                                      return_alignments=False)
    check(out == goldens['greedy'], 'f32 flagship greedy differs from '
          'golden_decodes.json: %s' % [(a, b) for a, b in
                                       zip(out, goldens['greedy']) if a != b])
    d = max(abs(a - b) for a, b in zip(sc, goldens['greedy_scores']))
    check(d <= 2e-3, 'f32 scores off the goldens by %g' % d)
    print('f32 flagship: %d/%d golden lines byte-equal, max score diff %.3g'
          % (len(out), len(out), d))
    s2s.config = dataclasses.replace(s2s.config, use_pallas_lstm=True)
    out, _, sc, _ = s2s.correct_lines(list(goldens['inputs']),
                                      return_alignments=False)
    check(out == goldens['greedy'], 'f32 flagship with the LSTM-step '
          'kernel differs from golden_decodes.json')
    d = max(abs(a - b) for a, b in zip(sc, goldens['greedy_scores']))
    check(d <= 2e-3, 'f32 LSTM-step-kernel scores off the goldens by %g' % d)
    print('f32 flagship + K2: golden lines byte-equal, max score diff %.3g'
          % d)
    art = load_model(dev, filename=ARTIFACT)
    out, _, _, _ = art.correct_lines(list(art_gold['sources']),
                                     return_alignments=False)
    eq = sum(a == b for a, b in zip(out, art_gold['reference_greedy']))
    check(eq >= len(out) - 2, 'reference artifact: %d/%d greedy lines'
          % (eq, len(out)))
    print('reference-trained w64: %d/%d greedy lines byte-equal to the '
          'reference decoder' % (eq, len(out)))
    bf = load_model(dev, 'bfloat16')
    out, _, sc, _ = bf.correct_lines(list(corpus[:16]),
                                     return_alignments=False)
    check(len(out) == 16 and all(o.endswith('\n') for o in out)
          and all(0.0 <= s < 10.0 for s in sc),
          'bf16 fused serving gave malformed output')
    print('bf16 flagship, 16 lines: served')


def serving_scan(torch, dev, lines):
    """The flagship's serving encoder (``encode(train=False)``) on K4
    against the same encoder with ``_FUSED_SCAN = 'off'`` (the
    step-by-step ``lstm_scan``), f32 and bf16, over `lines`: three K4
    launches a call on the route (f32 under 'auto'; bf16, which serves
    on ``lstm_scan`` under 'auto', forced 'on'), none off; f32 within the
    scan kernels' f32 bar; the largest difference printed for each
    dtype."""
    from cor_asv_ann_tpu_torch.models import seq2seq
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    from cor_asv_ann_tpu_torch.utils.data import lines_to_index_batch
    report = {}
    for compute in ('float32', 'bfloat16'):
        s2s = load_model(dev, compute)
        params = s2s._infer_params()
        enc = seq2seq.ensure_onehot(torch.from_numpy(lines_to_index_batch(
            s2s.mapping, list(lines))).to(dev), s2s.config, params)
        route = 'auto' if compute == 'float32' else 'on'
        got = {}
        for mode in (route, 'off', 'auto'):
            seq2seq._FUSED_SCAN = mode
            try:
                before = lsk.lstm_scan_fwd.launches
                with torch.no_grad():
                    attended, states, u = seq2seq.encode(params, s2s.config,
                                                         enc)
                torch.cuda.synchronize()
            finally:
                seq2seq._FUSED_SCAN = 'auto'
            got[mode] = ([attended, u] + [t for hc in states for t in hc],
                         lsk.lstm_scan_fwd.launches - before)
        (on, launched), (off, none) = got[route], got['off']
        auto = got['auto'][1]
        check(launched == 3 and none == 0
              and auto == (3 if compute == 'float32' else 0),
              '%s serving encoder: %d K4 launches on the route, %d off it, '
              '%d under auto' % (compute, launched, none, auto))
        names = ['attended', 'u'] + ['%s%d' % (v, n) for n in
                                      range(len(on) // 2 - 1) for v in 'hc']
        errs = {k: (g.float() - w.float()).abs().max().item()
                for k, g, w in zip(names, on, off)}
        err = max(errs.values())
        check(all(bool(torch.isfinite(g).all()) for g in on),
              '%s serving encoder on K4: not finite' % compute)
        if compute == 'float32':
            for g, w in zip(on, off):
                torch.testing.assert_close(g, w, **scan_tolerance(
                    torch, torch.float32))
        report[compute] = dict(max_abs_diff=err, by_tensor=errs,
                               k4_launches=launched, shape=list(enc.shape))
        print('serving_scan %-8s B=%d T=%d: encode on K4 (%d launches, '
              '_FUSED_SCAN=%s; %d under auto) against _FUSED_SCAN=off, '
              'max|diff| over attended, u, states = %.3g (%s)'
              % (compute, enc.shape[0], enc.shape[1], launched, route, auto,
                 err, ', '.join('%s %.3g' % kv for kv in errs.items())))
    return report


def _scan_inputs(torch, dev, dt, T, B, N, seed):
    gen = torch.Generator().manual_seed(seed)
    zx = torch.randn(T, B, 4 * N, generator=gen)
    R = torch.randn(N, 4 * N, generator=gen) / N ** 0.5
    h0 = torch.randn(B, N, generator=gen) * 0.2
    c0 = torch.randn(B, N, generator=gen) * 0.2
    return [t.to(dt).to(dev) for t in (zx, R, h0, c0)]


def _shift(torch, hs, h0, reverse):
    return (torch.cat([hs[1:], h0[None]]) if reverse
            else torch.cat([h0[None], hs[:-1]]))


SCAN_SHAPES = ((128, 256, 512), (7, 5, 40))     # (T, B, N)


def scan_tolerance(torch, dt):
    """float32: summation order and expf/tanhf against PyTorch's; bf16:
    an ulp of a gate carried along the sweep (the JAX package's bar for
    its scan kernel, 2e-2)."""
    return (dict(atol=2e-5, rtol=1e-5) if dt == torch.float32
            else dict(atol=2e-2, rtol=2e-2))


# the masked cases (T, B, N): the benchmark's training cell (d2/w128, T
# up to 96), train_path's own shape (d2/w512, B = 256, T = 64) and a
# small odd one
MASKED_SCAN_SHAPES = ((96, 256, 128), (64, 256, 512), (7, 5, 40))


def _scan_cases():
    """(T, B, N, masked) for the K4/K5 phases."""
    return ([shape + (False,) for shape in SCAN_SHAPES]
            + [shape + (True,) for shape in MASKED_SCAN_SHAPES])


def _padding_mask(torch, dev, T, B, seed):
    """(T, B) uint8, 1 at valid steps: right padding at random lengths,
    row 0 whole, row 1 all padding, row 2 with gaps inside."""
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, T + 1, (B,), generator=gen)
    m = torch.arange(T)[:, None] < lengths[None]
    m[:, 0] = True
    m[:, 1] = False
    m[:, 2] = torch.arange(T) % 3 != 1
    return m.to(torch.uint8).to(dev)


def phase_k4(torch, dev):
    """K4 against its plain version, both dtypes, both directions, with
    and without a padding mask."""
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = scan_tolerance(torch, dt)
        for T, B, N, masked in _scan_cases():
            for reverse in (False, True):
                args = _scan_inputs(torch, dev, dt, T, B, N, 2)
                mask = _padding_mask(torch, dev, T, B, 9) if masked else None
                got = lsk.lstm_scan_fwd(*args, reverse, mask)
                torch.cuda.synchronize()
                want = lsk.lstm_scan_fwd_reference(*args, reverse, mask)
                err = 0.0
                for g, w in zip(got, want):
                    torch.testing.assert_close(g.float(), w.float(), **tol)
                    err = max(err, (g.float() - w.float()).abs().max().item())
                errs[(_dtype_name(dt), T, B, N, reverse, masked)] = err
                print('K4 %-8s T=%-3d B=%-3d N=%-3d reverse=%d masked=%d '
                      'max|kernel-plain| = %.3g (atol %g rtol %g)'
                      % (_dtype_name(dt), T, B, N, reverse, masked, err,
                         tol['atol'], tol['rtol']))
    return errs


def phase_k5(torch, dev):
    """K5 against its plain version on the states the plain K4 saved,
    with and without a padding mask, then LstmScan against autograd
    through the plain lstm_scan."""
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    from cor_asv_ann_tpu_torch.ops.lstm import lstm_scan
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = scan_tolerance(torch, dt)
        for T, B, N, masked in _scan_cases():
            for reverse in (False, True):
                zx, R, h0, c0 = _scan_inputs(torch, dev, dt, T, B, N, 3)
                mask = (_padding_mask(torch, dev, T, B, 10) if masked
                        else None)
                # masked, hs and cs hold the carry at padded steps, so the
                # shifted buffers are the states each step started from
                hs, cs, _, _ = lsk.lstm_scan_fwd_reference(zx, R, h0, c0,
                                                           reverse, mask)
                hprev = _shift(torch, hs, h0, reverse)
                cprev = _shift(torch, cs, c0, reverse)
                gen = torch.Generator().manual_seed(4)
                # cotangents of the size a mean loss hands back, so the
                # carried gradients stay in range over 128 steps
                g_hs, g_hT, g_cT = (
                    (torch.randn(*shape, generator=gen) * 0.1).to(dt).to(dev)
                    for shape in ((T, B, N), (B, N), (B, N)))
                args = (g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs, reverse,
                        mask)
                got = lsk.lstm_scan_bwd(*args)
                torch.cuda.synchronize()
                want = lsk.lstm_scan_bwd_reference(*args)
                err = 0.0
                for g, w in zip(got, want):
                    # relative to the gradient's own scale
                    scale = max(1.0, w.float().abs().max().item())
                    torch.testing.assert_close(g.float() / scale,
                                               w.float() / scale, **tol)
                    err = max(err, ((g.float() - w.float()).abs().max()
                                    / scale).item())
                errs[(_dtype_name(dt), T, B, N, reverse, masked)] = err
                print('K5 %-8s T=%-3d B=%-3d N=%-3d reverse=%d masked=%d '
                      'max|kernel-plain|/scale = %.3g (atol %g rtol %g)'
                      % (_dtype_name(dt), T, B, N, reverse, masked, err,
                         tol['atol'], tol['rtol']))
    # the autograd.Function against autograd through the plain scan, f32
    B, T, D, N = 64, 32, 512, 512
    gen = torch.Generator().manual_seed(5)

    def leaf(*shape, scale=1.0):
        return ((torch.randn(*shape, generator=gen) * scale).to(dev)
                .requires_grad_())

    xs, h0, c0 = leaf(B, T, D), leaf(B, N, scale=.2), leaf(B, N, scale=.2)
    w = {'kernel': leaf(D, 4 * N, scale=D ** -0.5),
         'recurrent_kernel': leaf(N, 4 * N, scale=N ** -0.5),
         'bias': leaf(4 * N, scale=.1)}
    wo, wh, wc = (leaf(*shape).detach() / (B * T) for shape in
                  ((B, T, N), (B, N), (B, N)))
    leaves = [xs, h0, c0, *w.values()]
    for reverse in (False, True):
        def grads(fn):
            out, h, c = fn(xs, w, h0, c0, reverse=reverse)
            return torch.autograd.grad(
                (out * wo).sum() + (h * wh).sum() + (c * wc).sum(), leaves)
        worst = 0.0
        for g, r in zip(grads(lsk.lstm_scan_fused), grads(lstm_scan)):
            scale = r.abs().max().item()
            torch.testing.assert_close(g / scale, r / scale, rtol=2e-4,
                                       atol=2e-5)
            worst = max(worst, ((g - r).abs().max() / scale).item())
        print('LstmScan vs autograd through lstm_scan, f32, reverse=%d: '
              'max gradient diff / scale = %.3g (rtol 2e-4 atol 2e-5)'
              % (reverse, worst))
    return errs


def _teacher_inputs(torch, dev, dt, B, Td, T, W, A, with_masks, seed):
    """K6's inputs in its own order (without ww), at the scale a model's
    activations have."""
    gen = torch.Generator().manual_seed(seed)

    def mk(shape, scale, dtype=dt):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    zx = mk((Td, B, 4 * W), 1.0, torch.float32)
    u, att = mk((B, T, W), 0.5), mk((B, T, A), 0.5)
    Kc, R = mk((A, 4 * W), A ** -0.5), mk((W, 4 * W), W ** -0.5)
    W_a, v = mk((W, W), W ** -0.5), mk((1, W), 2 * W ** -0.5)
    b_UW, b_v = mk((1, W), 0.1), mk((1, 1), 0.1, torch.float32)
    bias = mk((1, 4 * W), 0.1)
    if with_masks:
        maskc = ((torch.rand(4, B, A, generator=gen) < 0.8) / 0.8)
        maskc = maskc.to(dt).to(dev)
    else:
        maskc = torch.ones((4, B, A), dtype=dt, device=dev)
    h0, c0 = mk((B, W), 0.2), mk((B, W), 0.2)
    return [zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0]


# (B, Td, T, W, A, ww): the flagship training shape, and a small one with
# a ragged last block of rows, T != Td and narrow widths
TEACHER_SHAPES = ((256, 128, 128, 512, 512, 5), (7, 9, 16, 40, 24, 5))
# with the encoder's padding mask as well: the benchmark's training cell
# (d2/w128, lines up to 96), the flagship shape, and a small one whose
# decoder runs past every line
PADDED_TEACHER_SHAPES = ((256, 96, 96, 128, 128, 5),
                         (256, 128, 128, 512, 512, 5), (7, 20, 16, 40, 24, 5))


def _teacher_cases():
    """(B, Td, T, W, A, ww, dropout masks, padded) for the K6/K7 phases."""
    return ([shape + (m, False) for shape in TEACHER_SHAPES
             for m in (False, True)]
            + [shape + (True, True) for shape in PADDED_TEACHER_SHAPES])


def _teacher_padding_mask(torch, dev, B, T, seed, ww):
    """The encoder's (B, T) uint8 padding mask as K6/K7 take it: the rows
    of `_padding_mask`, and row 3 valid only from position ww + 2 on, so
    that its every attention window is empty (as row 1's)."""
    m = _padding_mask(torch, dev, T, B, seed).t().contiguous()
    m[3] = (torch.arange(T, device=dev) >= ww + 2).to(torch.uint8)
    return m


def teacher_tolerance(torch, dt):
    """(atol, rtol, t0_rtol). float32: summation order and expf/tanhf
    against PyTorch's; bf16: an ulp of a gate carried along the sweep
    (as `scan_tolerance`). t0_rtol: how close, relative to its value, a
    row's window centre must lie to an integer for the two to be allowed
    to see different windows there (the row is compared up to that
    step): float32 sums of ~100 terms, or bf16 ulps of the alignment."""
    return ((2e-5, 1e-5, 1e-5) if dt == torch.float32
            else (2e-2, 2e-2, 2e-2))


def phase_k6(torch, dev):
    """K6 against its plain version, both dtypes, with and without
    dropout masks, and with the encoder's padding mask."""
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = teacher_tolerance(torch, dt)
        for B, Td, T, W, A, ww, with_masks, padded in _teacher_cases():
            ins = _teacher_inputs(torch, dev, dt, B, Td, T, W, A,
                                  with_masks, 7)
            enc_mask = (_teacher_padding_mask(torch, dev, B, T, 12, ww)
                        if padded else None)
            got = tk.teacher_fwd(*ins, ww, enc_mask)
            torch.cuda.synchronize()
            want = tk.teacher_fwd_reference(*ins, ww, enc_mask)
            err, share = tk.teacher_fwd_agreement(got, want, *tol)
            # float32 rows part ways only by accident; bf16 rows do where
            # an ulp of the alignment moves t0 past an integer (measured:
            # 0.7-1.4% of the pairs at the flagship shape)
            check(share >= (0.99 if dt == torch.float32 else 0.9),
                  'K6 %s: only %.3f of the (step, row) pairs could be '
                  'compared' % (_dtype_name(dt), share))
            if padded:
                aa = got[2]
                check(not bool(aa[:, enc_mask == 0].any())
                      and not bool(aa[:, 1:4:2].any()),
                      'K6 %s: an alignment on a padded position'
                      % _dtype_name(dt))
            errs[(_dtype_name(dt), B, T, with_masks, padded)] = err
            print('K6 %-8s B=%-3d Td=%-3d T=%-3d W=%-3d A=%-3d masks=%d '
                  'padded=%d max|kernel-plain| = %.3g over %.1f%% of the '
                  '(step, row) pairs (atol %g rtol %g, windows may differ '
                  'where t0 is within %g*t0 of an integer)'
                  % (_dtype_name(dt), B, Td, T, W, A, with_masks, padded,
                     err, 100 * share, *tol))
    return errs


def phase_k7(torch, dev):
    """K7 against its plain version on the residuals the plain K6 saved,
    with and without the encoder's padding mask, then TeacherTopFused
    against autograd through the dense body."""
    from cor_asv_ann_tpu_torch.models.seq2seq import _teacher_body
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        atol, rtol, _ = teacher_tolerance(torch, dt)
        for B, Td, T, W, A, ww, with_masks, padded in _teacher_cases():
            ins = _teacher_inputs(torch, dev, dt, B, Td, T, W, A,
                                  with_masks, 8)
            zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0 = ins
            enc_mask = (_teacher_padding_mask(torch, dev, B, T, 13, ww)
                        if padded else None)
            hs, cs, aa, zs = tk.teacher_fwd_reference(*ins, ww, enc_mask)
            gen = torch.Generator().manual_seed(9)
            # cotangents of the size a mean loss hands back
            g = (torch.randn(*hs.shape, generator=gen) * 0.1).to(dt).to(dev)
            args = (zs, g, _shift(torch, hs, h0, False),
                    _shift(torch, cs, c0, False), cs, aa, u, att, Kc, R,
                    W_a, v, b_UW, maskc, ww, enc_mask)
            got = tk.teacher_bwd(*args)
            torch.cuda.synchronize()
            want = tk.teacher_bwd_reference(*args)
            err = 0.0
            for g_, w in zip(got, want):
                # relative to the gradient's own scale
                scale = max(1.0, w.float().abs().max().item())
                torch.testing.assert_close(g_.float() / scale,
                                           w.float() / scale,
                                           atol=atol, rtol=rtol)
                err = max(err, ((g_.float() - w.float()).abs().max()
                                / scale).item())
            if padded:
                padding = enc_mask == 0
                check(not bool(got[1][:, padding].any())
                      and not bool(got[7][padding].any())
                      and not bool(got[8][padding].any()),
                      'K7 %s: a gradient on a padded position'
                      % _dtype_name(dt))
            errs[(_dtype_name(dt), B, T, with_masks, padded)] = err
            print('K7 %-8s B=%-3d Td=%-3d T=%-3d W=%-3d A=%-3d masks=%d '
                  'padded=%d max|kernel-plain|/scale = %.3g (atol %g rtol '
                  '%g)' % (_dtype_name(dt), B, Td, T, W, A, with_masks,
                           padded, err, atol, rtol))
    # the autograd.Function against autograd through the dense body, f32
    B, Td, T, W, A, ww = 9, 10, 20, 512, 512, 5
    gen = torch.Generator().manual_seed(10)

    def leaf(*shape, scale):
        return ((torch.randn(*shape, generator=gen) * scale).to(dev)
                .requires_grad_())

    top = {'W_a': leaf(W, W, scale=W ** -0.5),
           'v_a': leaf(W, 1, scale=2 * W ** -0.5),
           'b_UW': leaf(W, scale=.1), 'b_v': leaf(1, scale=.1),
           'cell': {'kernel': leaf(W + A, 4 * W, scale=(W + A) ** -0.5),
                    'recurrent_kernel': leaf(W, 4 * W, scale=W ** -0.5),
                    'bias': leaf(4 * W, scale=.1)}}
    xs, att, u = (leaf(*shape, scale=.5) for shape in
                  ((B, Td, W), (B, T, A), (B, T, W)))
    h0, c0 = leaf(B, W, scale=.2), leaf(B, W, scale=.2)
    leaves = [top['W_a'], top['v_a'], top['b_UW'], top['b_v'],
              *top['cell'].values(), xs, att, u, h0, c0]
    for with_masks, padded in ((False, False), (True, False), (True, True)):
        masks = (((torch.rand(4, B, W + A, generator=gen) < 0.8) / 0.8)
                 .to(dev) if with_masks else None)
        enc_mask = (_teacher_padding_mask(torch, dev, B, T, 14, ww)
                    if padded else None)
        out = tk.teacher_top_fused(top, xs, att, u, h0, c0, masks, ww,
                                   enc_mask)
        ref = _teacher_body(top, xs, att, u, h0, c0, masks, ww, 0,
                            None if enc_mask is None else enc_mask.bool())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        worst = 0.0
        for g_, r in zip(torch.autograd.grad((out ** 2).sum(), leaves),
                         torch.autograd.grad((ref ** 2).sum(), leaves)):
            # relative to the gradient's scale; the gradient of b_v is 0
            # up to rounding (a softmax ignores a shift of its energies)
            scale = max(1.0, r.abs().max().item())
            torch.testing.assert_close(g_ / scale, r / scale, rtol=2e-3,
                                       atol=2e-4)
            worst = max(worst, ((g_ - r).abs().max() / scale).item())
        print('TeacherTopFused vs autograd through the dense body, f32, '
              'masks=%d padded=%d: max gradient diff / scale = %.3g (rtol '
              '2e-3 atol 2e-4)' % (with_masks, padded, worst))
    return errs


def write_corpus(path, n):
    from cor_asv_ann_tpu_torch.utils.synthdata import make_pairs
    with open(path, 'w', encoding='utf-8') as f:
        for noisy, clean in make_pairs(n, seed=7):
            f.write('%s\t%s\n' % (noisy, clean))


def new_trainer(dev, data, keras_padding, compute):
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    s2s = Sequence2Sequence(device=dev)
    s2s.width, s2s.depth, s2s.batch_size = 512, 2, 256
    s2s.keras_padding = keras_padding
    s2s.train_compute = compute
    s2s.map_files([data])
    s2s.configure()
    return s2s


def long_line_steps(torch, dev, data, batch, launches_of):
    """train_steps at the flagship training shape B=256, T=Td=128 (the
    batch of short lines padded out), bf16 compute, no masked padding,
    with the fused teacher kernels ('auto') and with the dense body
    ('off'): ms per step, peak memory and wrapper launches per step."""
    import numpy as np
    from cor_asv_ann_tpu_torch.models import seq2seq
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                     tree_map)
    s2s = new_trainer(dev, data, True, 'bfloat16')
    *indices, w = batch

    def pad(a, value):
        return np.pad(a, ((0, 0), (0, 128 - a.shape[1])),
                      constant_values=value)

    long_batch = (*(pad(a, -1) for a in indices), pad(w, 0))
    report = {}
    steps = 3
    for mode in ('auto', 'off'):
        params = tree_map(lambda t: t.requires_grad_(),
                          params_from_numpy(s2s.params, dev))
        opt = T.make_optimizer(params, s2s.learning_rate)
        gen = torch.Generator().manual_seed(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = launches_of()
        losses, times = [], []
        seq2seq._TEACHER_KERNEL = mode
        try:
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = T.train_step(params, opt, s2s.config, *long_batch,
                                    gen, compute_dtype='bfloat16')
                losses.append(float(loss))
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            seq2seq._TEACHER_KERNEL = 'auto'
        after = launches_of()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = {k: (after[k] - before[k]) / steps for k in after}
        teacher = 1 if mode == 'auto' else 0
        check(all(np.isfinite(losses)), 'T=128 %s: loss not finite: %s'
              % (mode, losses))
        check(per_step['teacher_fwd'] == per_step['teacher_bwd'] == teacher
              and per_step['lstm_scan_fwd'] == per_step['lstm_scan_bwd'] == 4,
              'T=128 with _TEACHER_KERNEL=%r: launches per step %s'
              % (mode, per_step))
        name = 'keras_padding_bfloat16_T128_teacher_kernel_' + mode
        report[name] = dict(step_ms=min(times[1:]), first_step_ms=times[0],
                            peak_gib=peak, train_losses=losses,
                            launches_per_step=per_step,
                            shape='B=%d T=%d Td=%d' % (
                                *long_batch[0].shape,
                                long_batch[1].shape[1]))
        print('train_step bf16 %s, _TEACHER_KERNEL=%r: %.1f ms/step (first '
              '%.1f), peak %.2f GiB, launches per step %s'
              % (report[name]['shape'], mode, report[name]['step_ms'],
                 times[0], peak, per_step))
    return report


def masked_route_gaps(torch, dev, s2s, batch, flag):
    """A mask_padding model's loss and gradients on one batch with the
    kernels that `flag` of models/seq2seq.py switches on ('auto': the
    training scans on K4/K5 for `_FUSED_SCAN`, the top layer on
    K6/K7 for `_TEACHER_KERNEL`) against the same step with them 'off'
    (the step-by-step masked scan; the dense top layer under autograd),
    float32, with the same dropout draws: the loss's relative gap and the
    largest gradient gap relative to its leaf's scale (at least 1e-4 of
    the largest gradient: some leaves of a fresh model get almost
    none)."""
    from cor_asv_ann_tpu_torch.models import seq2seq
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                     tree_leaves, tree_map)
    tensors = [torch.as_tensor(a).to(dev) for a in batch]
    got = {}
    for mode in ('auto', 'off'):
        setattr(seq2seq, flag, mode)
        try:
            params = tree_map(lambda t: t.requires_grad_(),
                              params_from_numpy(s2s.params, dev))
            loss = T.loss_fn(params, s2s.config, *tensors,
                             torch.Generator().manual_seed(3))
            grads = torch.autograd.grad(loss, tree_leaves(params))
        finally:
            setattr(seq2seq, flag, 'auto')
        got[mode] = float(loss.detach()), grads
    (l_on, g_on), (l_off, g_off) = got['auto'], got['off']
    loss_gap = abs(l_on - l_off) / abs(l_off)
    top = max(r.abs().max().item() for r in g_off)
    grad_gap = 0.0
    for g, r in zip(g_on, g_off):
        scale = max(r.abs().max().item(), 1e-4 * top)
        torch.testing.assert_close(g / scale, r / scale, rtol=2e-4,
                                   atol=2e-5)
        grad_gap = max(grad_gap, ((g - r).abs().max() / scale).item())
    check(loss_gap <= 1e-6, 'mask_padding float32, %s: the loss with the '
          'kernels is %r, without %r' % (flag, l_on, l_off))
    return loss_gap, grad_gap


def train_path(torch, dev, tmp, launches_of):
    """The training path at width 512, depth 2, batch 256: train_steps in
    float32 and bfloat16 under both padding modes (both through the fused
    teacher kernels; with masked padding, float32, the loss and gradients
    held against the masked plain scan and against the dense top layer),
    steps at T = Td = 128
    with those kernels on and off, then train() for one epoch, save(),
    reload and serve from the file. Returns per-regime step times, peak
    memory and launch counts."""
    import numpy as np
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                     tree_map)
    from cor_asv_ann_tpu_torch.utils import io_h5
    from cor_asv_ann_tpu_torch.utils.data import gen_line_batches
    data = os.path.join(tmp, 'train.tsv')
    write_corpus(data, 768)
    report = {}
    steps = 4
    for keras_padding in (False, True):
        # what the configuration implies: the two directions of encoder
        # layer 1, encoder layer 2 and the lower decoder layer scan
        # through K4/K5 either way (the encoder's with its padding mask),
        # and the top layer runs through K6/K7 (with the encoder's
        # padding mask where the model masks padding)
        scans, teacher = 4, 1
        for compute in ('float32', 'bfloat16'):
            s2s = new_trainer(dev, data, keras_padding, compute)
            sources, confs, targets, _ = next(gen_line_batches(
                [data], s2s.batch_size, repeat=False))
            batch = T._vectorize(s2s.mapping, sources, targets, confs,
                                 s2s.logger)
            params = tree_map(lambda t: t.requires_grad_(),
                              params_from_numpy(s2s.params, dev))
            opt = T.make_optimizer(params, s2s.learning_rate)
            gen = torch.Generator().manual_seed(0)
            compute_dtype = 'bfloat16' if compute == 'bfloat16' else None
            # the loss that has to fall is the batch's evaluation loss
            # (no dropout noise, float32 masters) before and after
            eval_before = float(T.eval_step(params, s2s.config, *batch))
            before = launches_of()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = T.train_step(params, opt, s2s.config, *batch, gen,
                                    compute_dtype=compute_dtype)
                losses.append(float(loss))
                times.append((time.perf_counter() - t0) * 1e3)
            after = launches_of()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            eval_after = float(T.eval_step(params, s2s.config, *batch))
            name = '%s_%s' % ('keras_padding' if keras_padding
                              else 'mask_padding', compute)
            check(all(np.isfinite(losses + [eval_before, eval_after])),
                  '%s: loss not finite: %s' % (name, losses))
            check(eval_after < eval_before, '%s: loss did not fall: %s -> '
                  '%s' % (name, eval_before, eval_after))
            per_step = {k: (after[k] - before[k]) / steps for k in after}
            gaps = {}
            if not keras_padding and compute == 'float32':
                # the masked encoder's scans on K4/K5 against the same
                # step on the masked plain scan, and the masked top layer
                # on K6/K7 against the same step on the dense body
                for flag, key, what in (
                        ('_FUSED_SCAN', 'route_off', 'K4/K5 against '
                         'the masked plain scan'),
                        ('_TEACHER_KERNEL', 'teacher_off', 'K6/K7 against '
                         'the masked dense top layer')):
                    loss_gap, grad_gap = masked_route_gaps(torch, dev, s2s,
                                                           batch, flag)
                    gaps.update({key + '_loss_gap': loss_gap,
                                 key + '_grad_gap': grad_gap})
                    print('train_step %s: %s, loss gap %.3g (relative, bar '
                          '1e-6), gradient gap / scale %.3g (rtol 2e-4 atol '
                          '2e-5)' % (name, what, loss_gap, grad_gap))
            check(per_step == {'lstm_scan_fwd': scans,
                               'lstm_scan_bwd': scans,
                               'teacher_fwd': teacher,
                               'teacher_bwd': teacher},
                  '%s: launches per step %s, expected %d of each scan '
                  'kernel and %d of each teacher kernel'
                  % (name, per_step, scans, teacher))
            report[name] = dict(
                step_ms=min(times[1:]), first_step_ms=times[0],
                peak_gib=peak, eval_loss_before=eval_before,
                eval_loss_after=eval_after, train_losses=losses,
                launches_per_step=per_step, **gaps,
                shape='B=%d T=%d Td=%d' % (batch[0].shape[0],
                                           batch[0].shape[1],
                                           batch[1].shape[1]))
            print('train_step %-22s %s: %.1f ms/step (first %.1f), peak '
                  '%.2f GiB, eval loss %.4f -> %.4f, launches per step '
                  'K4/K5 %d/%d K6/K7 %d/%d'
                  % (name, report[name]['shape'], report[name]['step_ms'],
                     times[0], peak, eval_before, eval_after, scans, scans,
                     teacher, teacher))
    report.update(long_line_steps(torch, dev, data, batch, launches_of))
    # the whole loop: one short epoch, model file out, served back in
    # (without masked padding)
    s2s = new_trainer(dev, data, True, 'bfloat16')
    s2s.epochs = 1
    history = s2s.train([data], checkpoint_dir=tmp)
    check(s2s.status == 2 and len(history['loss']) == 1
          and np.isfinite(history['loss'][0])
          and np.isfinite(history['val_loss'][0]),
          'train() did not finish an epoch: %s' % history)
    model = os.path.join(tmp, 'trained.h5')
    s2s.save(model)
    served = load_model(dev, filename=model, keras_padding=True)
    config, mapping = io_h5.load_config(model)
    check(config.width == 512 and config.depth == 2
          and mapping.c2i == s2s.mapping.c2i, 'saved config differs')
    lines = [src + '\n' for src in sources[:8]]
    out_file, _, sc_file, _ = served.correct_lines(list(lines),
                                                   return_alignments=False)
    out_mem, _, sc_mem, _ = s2s.correct_lines(list(lines),
                                              return_alignments=False)
    check(out_file == out_mem and sc_file == sc_mem,
          'serving from the saved file differs from serving the trained '
          'model')
    check(len(out_file) == 8 and all(np.isfinite(sc_file)),
          'serving from the saved file gave malformed output')
    print('train(): 1 epoch, loss %.4f val_loss %.4f; saved, reloaded and '
          'served %d lines from the file, equal to the model in memory'
          % (history['loss'][0], history['val_loss'][0], len(out_file)))
    return report


def scan_times(torch, dev, dt):
    """K4 and K5 at the flagship shape: kernel, plain version, bound and
    the cuDNN LSTM as the library yardstick, timed in turns with the
    kernel (cuDNN, kernel, kernel, cuDNN): cuDNN's time moves between
    calls far more than the kernels'."""
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    T, B, N = SCAN_SHAPES[0]
    zx, R, h0, c0 = _scan_inputs(torch, dev, dt, T, B, N, 6)
    hs, cs, _, _ = lsk.lstm_scan_fwd(zx, R, h0, c0)
    hprev, cprev = _shift(torch, hs, h0, False), _shift(torch, cs, c0, False)
    g = torch.full_like(hs, 1e-3)
    bwd_args = (g, g[0], g[0], zx, R, hprev, cprev, cs)
    size = zx.element_size()
    name = _dtype_name(dt)
    # torch.nn.LSTM (cuDNN) with the same recurrent weights: it includes
    # the input projection (D = N) that the kernels leave outside, and
    # its backward also forms both weight gradients
    lstm = torch.nn.LSTM(N, N).to(dev).to(dt)
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(R.t())
    x = torch.randn(T, B, N, device=dev).to(dt).requires_grad_()
    state = (h0[None], c0[None])
    y, _ = lstm(x, state)
    leaves = [x, *lstm.parameters()]

    def lib_fwd():
        with torch.no_grad():
            lstm(x, state)

    def in_turns(kernel, library):
        lib_a = cuda_time_ms(library, 5)
        k_a, k_b = cuda_time_ms(kernel, 5), cuda_time_ms(kernel, 5)
        lib_b = cuda_time_ms(library, 5)
        return (k_a + k_b) / 2, (lib_a + lib_b) / 2, [lib_a, k_a, k_b, lib_b]

    out = {}
    out['fwd_ms'], out['fwd_library_ms'], out['fwd_turns_ms'] = in_turns(
        lambda: lsk.lstm_scan_fwd(zx, R, h0, c0), lib_fwd)
    out['fwd_plain_ms'] = cuda_time_ms(
        lambda: lsk.lstm_scan_fwd_reference(zx, R, h0, c0), 2)
    out['bwd_ms'], out['bwd_library_ms'], out['bwd_turns_ms'] = in_turns(
        lambda: lsk.lstm_scan_bwd(*bwd_args),
        lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
    out['bwd_plain_ms'] = cuda_time_ms(
        lambda: lsk.lstm_scan_bwd_reference(*bwd_args), 2)
    product = 2 * T * B * N * 4 * N
    # K4 reads zx, R, h0, c0 and writes hs, cs, hT, cT
    fwd_bytes = size * (T * B * 4 * N + N * 4 * N + 2 * T * B * N
                        + 4 * B * N)
    out['fwd_bound_ms'], out['fwd_bound_by'] = bound(fwd_bytes, product,
                                                     name)
    # K5 reads g_hs, zx, hprev, cprev, cs, R and the two state cotangents,
    # writes dzx and the float32 dh0, dc0; two products per step
    bwd_bytes = size * (4 * T * B * N + 2 * T * B * 4 * N + N * 4 * N
                        + 2 * B * N) + 4 * 2 * B * N
    out['bwd_bound_ms'], out['bwd_bound_by'] = bound(bwd_bytes, 2 * product,
                                                     name)
    for kind in ('fwd', 'bwd'):
        out[kind + '_plan'] = lsk.scan_plan(kind, dt, B, N)
    print('K4 %s T=%d B=%d N=%d: kernel %.3f ms, plain %.3f ms, cuDNN LSTM '
          'forward (with the input projection) %.3f ms, bound %.4f ms (%s); '
          'turns cuDNN/kernel/kernel/cuDNN %s'
          % (name, T, B, N, out['fwd_ms'], out['fwd_plain_ms'],
             out['fwd_library_ms'], out['fwd_bound_ms'],
             out['fwd_bound_by'], _ms_list(out['fwd_turns_ms'])))
    print('K5 %s T=%d B=%d N=%d: kernel %.3f ms, plain %.3f ms, cuDNN LSTM '
          'backward (with both weight gradients) %.3f ms, bound %.4f ms '
          '(%s); turns cuDNN/kernel/kernel/cuDNN %s'
          % (name, T, B, N, out['bwd_ms'], out['bwd_plain_ms'],
             out['bwd_library_ms'], out['bwd_bound_ms'],
             out['bwd_bound_by'], _ms_list(out['bwd_turns_ms'])))
    return out


def _ms_list(values):
    return '/'.join('%.3f' % v for v in values)


def scan_plans(torch):
    """The grid the K4/K5 launcher picks at the flagship shape and the
    resources nvcc gave each kernel (registers, spills)."""
    from cor_asv_ann_tpu_torch.ops import _build
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    T, B, N = SCAN_SHAPES[0]
    for kind, k in (('fwd', 'K4'), ('bwd', 'K5')):
        for dt in (torch.bfloat16, torch.float32):
            p = lsk.scan_plan(kind, dt, B, N)
            print('%s %s B=%d N=%d: G=%d row groups x S=%d unit slices = '
                  '%d blocks of 256 threads, %d rows x %d units a block, '
                  'reduction chunk %d, R resident %s, %d bytes of shared '
                  'memory, %d launch(es)'
                  % (k, _dtype_name(dt), B, N, p['groups'], p['slices'],
                     p['groups'] * p['slices'], p['rows_per_group'],
                     p['units_per_slice'], p['chunk'],
                     {0: 'none', 1: 'gate columns', 2: 'rows',
                      3: 'gate columns and rows'}[p['resident']],
                     p['smem_bytes'], p['launches']))
    entry = None
    for line in _build.build_log.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif entry and 'lstm_scan' in entry and ('spill' in line
                                                  or 'Used' in line):
            kernel = ('K4' if 'fwd' in entry else 'K5') + (
                ' bf16' if 'bfloat16' in entry else ' f32')
            print('  %s: %s' % (kernel, line.strip().replace(
                'ptxas info    : ', '')))


def traced_counters(fn, tmp):
    """fn() with the program's tracer on (a `maybe_profile` block with a
    cProfile file, no torch.profiler session): its result and the
    tracer's counters."""
    from cor_asv_ann_tpu_torch.utils import profiling
    with profiling.maybe_profile(
            profile_file=os.path.join(tmp, 'counters.prof')):
        out = fn()
        counters = profiling.snapshot()['counters']
    return out, counters


def kernel_device_ms(torch, fn, pattern):
    """{kernel name: (device ms, launches)} of one fn() call under
    torch.profiler, for the CUDA kernels whose name matches `pattern`."""
    import re
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(pattern, e.key)
        us = e.self_device_time_total
        if found and us > 0:
            ms, n = out.get(found.group(0), (0.0, 0))
            out[found.group(0)] = (ms + us / 1e3, n + e.count)
    return out


def teacher_times(torch, dev, dt):
    """K6 and K7 at the flagship training shape, with dropout masks:
    kernel (the wrapper, which also lays out the weights that the stage
    kernels read, allocates their scratch and, for K7, zeroes du/datt),
    plain version, bound, and the split of each over its stage kernels.
    No single PyTorch call computes either function, so there is no
    library yardstick."""
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    B, Td, T, W, A, ww = TEACHER_SHAPES[0]
    ins = _teacher_inputs(torch, dev, dt, B, Td, T, W, A, True, 11)
    zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0 = ins
    hs, cs, aa, zs = tk.teacher_fwd(*ins, ww)
    g = torch.full_like(hs, 1e-3)
    bwd_args = (zs, g, _shift(torch, hs, h0, False),
                _shift(torch, cs, c0, False), cs, aa, u, att, Kc, R, W_a, v,
                b_UW, maskc, ww)
    name = _dtype_name(dt)
    size = u.element_size()
    out = {}
    out['fwd_ms'] = cuda_time_ms(lambda: tk.teacher_fwd(*ins, ww), 3)
    out['fwd_plain_ms'] = cuda_time_ms(
        lambda: tk.teacher_fwd_reference(*ins, ww), 1)
    out['bwd_ms'] = cuda_time_ms(lambda: tk.teacher_bwd(*bwd_args), 3)
    out['bwd_plain_ms'] = cuda_time_ms(
        lambda: tk.teacher_bwd_reference(*bwd_args), 1)
    # what this run's data needs: of u and attended only the rows that
    # some step's window reaches, and the window terms of the visible
    # (step, row, position) triples
    visible = aa != 0
    nnz, touched = int(visible.sum()), int(visible.any(dim=0).sum())
    n = Td * B
    weights = A * 4 * W + W * 4 * W + W * W
    # K6 reads zx (float32), the touched rows of u and attended, Kc, R,
    # W_a, v, b_UW, b_v, bias, maskc, h0, c0; writes hs, cs, aa, zs
    fwd_bytes = 4 * n * 4 * W + 4 + size * (
        touched * (W + A) + weights + 6 * W + 4 * B * A + 2 * B * W
        + n * (2 * W + T + 4 * W))
    fwd_flops = n * 2 * (W * W + 4 * A * W + 4 * W * W) \
        + 2 * nnz * (W + A)
    out['fwd_bound_ms'], out['fwd_bound_by'] = bound(fwd_bytes, fwd_flops,
                                                     name)
    # K7 reads zs, g, hprev, cprev, cs, aa, the touched rows, the three
    # weights, v, b_UW, maskc; writes dz, ds, dctx, dwvec and, in
    # float32, dh0, dc0, dva, du, datt
    bwd_bytes = size * (n * (8 * W + T) + touched * (W + A) + weights
                        + 2 * W + 4 * B * A + n * (4 * W + T + A + W)) \
        + 4 * (3 * B * W + B * T * (W + A))
    bwd_flops = n * 2 * (2 * W * W + 4 * A * W + 4 * W * W) \
        + 2 * nnz * (2 * A + 3 * W)
    out['bwd_bound_ms'], out['bwd_bound_by'] = bound(bwd_bytes, bwd_flops,
                                                     name)
    # the bound counts du and datt once; the sweep read-modify-writes the
    # visible rows of both every step
    out['bwd_window_rmw_gb'] = 8 * nnz * (W + A) / 1e9
    # where K6's and K7's time goes: their stage kernels under the profiler
    for k, which, fn, names in (
            ('K6', 'fwd', lambda: tk.teacher_fwd(*ins, ww), tk.FWD_STAGES),
            ('K7', 'bwd', lambda: tk.teacher_bwd(*bwd_args), tk.BWD_STAGES)):
        prefix = 'teacher_%s_' % which
        split = kernel_device_ms(torch, fn, prefix + r'\w+')
        stages = [prefix + s for s in names]
        if not split:
            print('%s %s stage split: not measured (the profiler saw no '
                  'device time)' % (k, name))
            continue
        check(sorted(split) == sorted(stages), '%s launched %s' % (k, split))
        out[which + '_stages_ms'] = {s[len(prefix):]: split[s][0]
                                     for s in stages}
        print('%s %s stage split (device ms, launches): %s' % (
            k, name, ', '.join('%s %.3f (%d)' % (s[len(prefix):], *split[s])
                               for s in stages)))
    for k, which in (('K6', 'fwd'), ('K7', 'bwd')):
        print('%s %s B=%d Td=%d T=%d W=%d A=%d: kernel %.3f ms, plain %.3f '
              'ms, bound %.4f ms (%s; %d visible positions, %d rows of '
              'u/attended touched)'
              % (k, name, B, Td, T, W, A, out[which + '_ms'],
                 out[which + '_plain_ms'], out[which + '_bound_ms'],
                 out[which + '_bound_by'], nnz, touched))
    print('K7 %s: the window rows of du and datt read and written every '
          'step move %.3f GB' % (name, out['bwd_window_rmw_gb']))
    return out


def lines_per_s(torch, s2s, lines, reps=2, greedy=True):
    def run():
        s2s.correct_lines(list(lines), fast=greedy, greedy=greedy,
                          return_alignments=False)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return reps * len(lines) / (time.perf_counter() - t0)


STEP_SHAPE = dict(V=45, W=512, A=512, WIN=12)   # the flagship's beam step


def _step_inputs(torch, dev, dt, N, seed, V, W, A, WIN, T):
    """K3's activations and packed weights at the scale a model's have;
    rows 3 and N-1 have no visible position. Besides, the encoder rows of
    the indexed form: N / rows_per_line lines of T positions, window
    starts over the whole line, so windows run off its end and clamp at
    T - 1, and the gathered windows are those rows."""
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    gen = torch.Generator().manual_seed(seed)

    def mk(shape, scale, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    fb = torch.softmax(mk((N, V), 3.0), dim=-1)
    states = [mk((N, W), 0.5) for _ in range(4)]
    per_line = STEP_LINE_ROWS.get(N, 5)
    u, att = mk((-(-N // per_line), T, W), 0.5, dt), \
        mk((-(-N // per_line), T, A), 0.5, dt)
    start = torch.randint(0, T - WIN // 2, (N,), generator=gen,
                          dtype=torch.int32).to(dev)
    start[0] = 0
    visible = (torch.rand(N, WIN, generator=gen) < 0.8).to(dev)
    visible[3] = visible[N - 1] = False
    shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W), b1=(4 * W,),
                  k2=(W + A, 4 * W), r2=(W, 4 * W), b2=(4 * W,),
                  W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,))
    weights = {k: mk(shape, shape[0] ** -0.5 if len(shape) > 1 else 0.1,
                     torch.float32 if k in dsk._BIASES else dt)
               for k, shape in shapes.items()}
    weights.update(dsk.kernel_layouts(weights))
    u_w, att_w = dsk.gather_windows(u, att, per_line, start, WIN)
    indexed = [fb, *states, u, att, per_line, start, visible]
    return [fb, *states, u_w, att_w, visible], indexed, weights


def step_tolerance(torch, dt):
    """float32: summation order and expf/tanhf against PyTorch's (the JAX
    package's bar for its kernel, tests/test_pallas_decode.py); bfloat16
    weights: an operand that rounds the other way to bfloat16 moves a sum
    of ~500 terms by an ulp of one of them."""
    return 2e-5 if dt == torch.float32 else 2e-3


# rows of one beam step (lines x expanded nodes) on the flagship: the
# automatic bounds expand K = min(48, R) nodes, R = 32 at rejection <= 0.3
# (what `beam_path` serves) and R = 64 above it (the command lines' and
# the processor's default, 0.5), at batch sizes 256 and 16, in the
# 128-line bucket and in the 32-line bucket of `processor_path`'s 24 lines
STEP_ROWS = {'B256_r03': 8192, 'B128_r03': 4096, 'B16_r03': 512,
             'B256_r05': 12288, 'B16_r05': 768, 'B32_r05': 1536}
# rows of a line at those steps (K), and the encoder rows of a line
STEP_LINE_ROWS = {8192: 32, 4096: 32, 512: 32, 12288: 48, 768: 48,
                  1536: 48}
STEP_T = 64
# the bucket of `make_long_lines` (300-400 characters), where the bf16
# beam (`long_beam_path`) steps 16 lines of K = 32 rows through K3
LONG_T, LONG_ROWS = 384, 512
# `long_beam_path`'s bars on the largest difference of a K3 step from the
# per-op step on the same inputs there, between what an H100 gave with
# sound wiring (0.230, 0.041) and with window starts one late (0.9995,
# 1.0)
LONG_STEP_BAR = {'probs': 0.6, 'align': 0.25}


def phase_k3(torch, dev):
    """K3 against its plain version at the flagship's widths: the rows of
    a beam step (`STEP_ROWS`, row tiles of 16, 32 and 64) and a count that
    is no multiple of the row tile, float32 and bfloat16, all-masked rows
    included, in both forms: gathered windows and the window rows read by
    index, which must give the same bits; and the rows of the long lines'
    bucket (LONG_T) in the indexed form's line length."""
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = step_tolerance(torch, dt)
        for N, T in (*((n, STEP_T) for n in sorted(STEP_ROWS.values())),
                     (770, STEP_T), (LONG_ROWS, LONG_T)):
            acts, indexed, weights = _step_inputs(torch, dev, dt, N, N,
                                                  **STEP_SHAPE, T=T)
            got = dsk.fused_decode_step(*acts, weights)
            got_i = dsk.fused_decode_step_indexed(*indexed, weights)
            torch.cuda.synchronize()
            want = dsk.fused_decode_step_reference(*acts, weights)
            for g, gi, w in zip(got, got_i, want):
                torch.testing.assert_close(g, w, atol=tol, rtol=0)
                check(torch.equal(g, gi), 'K3 N=%d: the indexed form differs '
                      'from the gathered form' % N)
            check(float(got[5][3].abs().max()) == 0.0
                  and float(got[5][N - 1].abs().max()) == 0.0,
                  'K3: an all-masked row has a non-zero alignment')
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            errs[(_dtype_name(dt), N, T)] = err
            print('K3 %-8s N=%-5d T=%-3d (%d-row product tiles) V=%d W=%d '
                  'A=%d WIN=%d max|kernel-plain| = %.3g (atol %g), indexed '
                  'form equal' % (_dtype_name(dt), N, T,
                                  dsk.step_rows_per_tile(dt, N,
                                                         STEP_SHAPE['W']),
                                  *STEP_SHAPE.values(), err, tol))
    return errs


def step_times(torch, dev, dt, N, T=STEP_T):
    """K3 at the flagship's widths, both forms: kernel (through its
    wrapper), plain version and bound. No single PyTorch call computes
    this function, so there is no library yardstick. The gathered form's
    bound reads the gathered windows; the indexed form's reads each
    line's encoder rows that its windows touch, once."""
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    acts, indexed, weights = _step_inputs(torch, dev, dt, N, 12,
                                          **STEP_SHAPE, T=T)
    V, W, A, WIN = STEP_SHAPE.values()
    reps = 10 if N > 4096 else 40
    out = {'ms': cuda_time_ms(
        lambda: dsk.fused_decode_step(*acts, weights), reps)}
    out['plain_ms'] = cuda_time_ms(
        lambda: dsk.fused_decode_step_reference(*acts, weights), reps)
    out['indexed_ms'] = cuda_time_ms(
        lambda: dsk.fused_decode_step_indexed(*indexed, weights), reps)
    out['indexed_plain_ms'] = cuda_time_ms(
        lambda: dsk.fused_decode_step_indexed_reference(*indexed, weights),
        reps)
    size = weights['E'].element_size()
    matrices = V * W + 4 * W * 4 * W + A * 4 * W + W * W + W
    # reads fb, four states, the window rows, visible, the weights and
    # biases; writes probs, four states and the alignment
    rest = (4 * N * (V + 4 * W) + N * WIN + size * matrices
            + 4 * (9 * W + 1) + 4 * N * (V + 4 * W + WIN))
    per_line, start = indexed[7], indexed[8]
    T = indexed[5].shape[1]
    line = torch.div(torch.arange(N, device=dev), per_line,
                     rounding_mode='floor')
    touched = torch.zeros(indexed[5].shape[0], T, dtype=torch.bool,
                          device=dev)
    for j in range(WIN):
        touched[line, torch.clamp(start.long() + j, max=T - 1)] = True
    rows = int(touched.sum())
    flops = 2 * N * (2 * V * W + 4 * W * 4 * W + A * 4 * W + W * W
                     + WIN * (W + A))
    out['bound_ms'], out['bound_by'] = bound(
        rest + size * N * WIN * (W + A), flops, _dtype_name(dt))
    out['indexed_bound_ms'], out['indexed_bound_by'] = bound(
        rest + size * rows * (W + A) + 4 * N, flops, _dtype_name(dt))
    print('K3 %s N=%d T=%d: gathered %.3f ms (plain %.3f, bound %.4f %s), '
          'indexed %.3f ms (plain %.3f, bound %.4f %s; %d encoder rows)'
          % (_dtype_name(dt), N, T, out['ms'], out['plain_ms'],
             out['bound_ms'], out['bound_by'], out['indexed_ms'],
             out['indexed_plain_ms'], out['indexed_bound_ms'],
             out['indexed_bound_by'], rows))
    return out


class StepCounter:
    """Counts the beam's decoder steps (one per iteration of the search)
    while it is entered, and keeps the largest number of hypothesis rows
    a step had and the longest bucket (encoder positions) it stepped.

    With `compare`, every step is also taken on the per-op route on the
    same inputs, and the largest differences of its probabilities and of
    its alignment row are kept (`probs_err`, `align_err`): that holds the
    K3 route's wiring (the window starts and the visible mask it is
    given) against the per-op route step by step, where whole searches
    part at the first rounding.

    It counts the step's Python calls, which a replayed CUDA graph of the
    iteration does not make, so the beam runs op by op while it is
    entered (`beam._BEAM_GRAPH = 'off'`)."""

    def __init__(self, compare=False):
        self.compare = compare

    def __enter__(self):
        from cor_asv_ann_tpu_torch.models import beam
        self.calls = self.rows = self.positions = 0
        self.probs_err = self.align_err = 0.0
        self._beam, self._step = beam, beam.beam_decoder_step
        self._graph, beam._BEAM_GRAPH = beam._BEAM_GRAPH, 'off'

        def counted(params, config, feedback, layer_states, aw, astart,
                    attended, *args, **kw):
            self.calls += 1
            self.rows = max(self.rows,
                            feedback.shape[0] * feedback.shape[1])
            self.positions = max(self.positions, attended.shape[1])
            out = self._step(params, config, feedback, layer_states, aw,
                             astart, attended, *args, **kw)
            if self.compare:
                route, beam._BEAM_STEP_KERNEL = beam._BEAM_STEP_KERNEL, 'off'
                try:
                    ref = self._step(params, config, feedback, layer_states,
                                     aw, astart, attended, *args, **kw)
                finally:
                    beam._BEAM_STEP_KERNEL = route
                self.probs_err = max(self.probs_err, float(
                    (out[0].float() - ref[0].float()).abs().max()))
                self.align_err = max(self.align_err, float(
                    (out[2].float() - ref[2].float()).abs().max()))
            return out
        beam.beam_decoder_step = counted
        return self

    def __exit__(self, *exc):
        self._beam.beam_decoder_step = self._step
        self._beam._BEAM_GRAPH = self._graph


def beam_lines(s2s, lines, conf=None):
    return s2s.correct_lines(list(lines), conf=conf, fast=False,
                             greedy=False, return_alignments=False)


def corpus_mode_inputs(inputs, kind):
    """(lines, conf) of one input format of tests/golden_corpus.json."""
    if kind == 'plain':
        return inputs['plain'], None
    if kind == 'probline':
        return ([''.join(c for c, _ in e) for e in inputs['probline']],
                [[p for _, p in e] for e in inputs['probline']])
    conf = [[[tuple(alt) for alt in chunk] for chunk in e]
            for e in inputs[kind]]
    return [''.join(ch[0][0] if ch else '' for ch in e) for e in conf], conf


BEAM_MODES = (('beam_r00_plain', 'plain', 0.0),
              ('beam_r03_plain', 'plain', 0.3),
              ('beam_r03_probline', 'probline', 0.3),
              ('beam_r03_confmat', 'confmat', 0.3),
              ('beam_r03_confmat_multi', 'confmat_multi', 0.3),
              ('beam_r05_plain', 'plain', 0.5))


def prospective_cost(line, score, source):
    """A solution's prospective cost from its length-normalised score:
    cum + 3*|length + 1 - len0|, the order the beam ranks by."""
    return score * len(line) + 3.0 * abs(len(line) + 1 - len(source))


def beam_path(torch, dev, goldens, golden_corpus, tmp, launches_of):
    """Beam serving of the flagship through correct_lines(greedy=False):
    (a) float32, per-op route, against every beam golden; (b) float32
    through K3; (c) bfloat16 through K3 at batch sizes 256 and 16, with
    the launches counted against the beam's iterations; (d) the proc and
    eval command lines as modules."""
    from cor_asv_ann_tpu_torch.lib.alignment import Alignment
    from cor_asv_ann_tpu_torch.models import beam
    inputs = golden_corpus['inputs']
    plain = inputs['plain']
    # (a) float32 on the per-op route: the goldens
    s2s = load_model(dev)
    s2s.rejection_threshold = 0.5
    out, _, _, _ = beam_lines(s2s, goldens['inputs'])
    check(out == goldens['beamed'], 'f32 flagship beam differs from '
          'golden_decodes.json: %s' % [(a, b) for a, b in
                                       zip(out, goldens['beamed']) if a != b])
    print('f32 flagship beam: %d/%d lines of golden_decodes.json byte-equal'
          % (len(out), len(out)))
    plain_r03 = None
    for name, kind, rejection in BEAM_MODES:
        lines, conf = corpus_mode_inputs(inputs, kind)
        s2s.rejection_threshold = rejection
        out, _, sc, _ = beam_lines(s2s, lines, conf)
        want = golden_corpus['modes'][name]
        check(out == want['output'], 'f32 %s differs from golden_corpus.json:'
              ' %s' % (name, [(a, b) for a, b in zip(out, want['output'])
                              if a != b][:5]))
        d = max(abs(a - b) for a, b in zip(sc, want['scores']))
        check(d <= 2e-3, 'f32 %s scores off the goldens by %g' % (name, d))
        print('f32 %-22s %d/%d lines byte-equal, max score diff %.3g'
              % (name, len(out), len(out), d))
        if name == 'beam_r03_plain':
            plain_r03 = (out, sc)
    check(launches_of()['decode_step'] == 0,
          'the float32 beam launched K3 under _BEAM_STEP_KERNEL = "auto"')
    art_gold = load_json('testmodels', 'reference_trained.goldens.json')
    art = load_model(dev, filename=ARTIFACT)
    for key, value in art_gold['serving'].items():
        setattr(art, key, value)
    out, _, _, _ = beam_lines(art, art_gold['sources'])
    eq = sum(a == b for a, b in zip(out, art_gold['reference_beamed']))

    def cer(lines):
        return sum(Alignment(0).get_levenshtein_distance(
            a.strip('\n'), b.strip('\n'))[0]
            for a, b in zip(lines, art_gold['targets'])) / len(lines)

    check(eq >= 40 and cer(out) <= cer(art_gold['reference_beamed']) * 1.10
          + 1e-9, 'reference artifact beam: %d/%d lines, CER %g against %g'
          % (eq, len(out), cer(out), cer(art_gold['reference_beamed'])))
    print('reference-trained w64 beam (auto bounds): %d/%d lines byte-equal '
          'to the reference decoder, CER %.4f against its %.4f'
          % (eq, len(out), cer(out), cer(art_gold['reference_beamed'])))

    # (b) float32 through K3: a line that differs must be a near tie
    s2s.rejection_threshold = 0.3
    beam._BEAM_STEP_KERNEL = 'on'
    try:
        with StepCounter() as steps:
            out, _, sc, _ = beam_lines(s2s, plain)
    finally:
        beam._BEAM_STEP_KERNEL = 'auto'
    check(launches_of()['decode_step'] == steps.calls > 0,
          'f32 beam with K3 on: %d launches in %d iterations'
          % (launches_of()['decode_step'], steps.calls))
    check(steps.rows == STEP_ROWS['B128_r03'], 'f32 beam with K3 on: %d '
          'rows a step, K3 was checked and timed at %d'
          % (steps.rows, STEP_ROWS['B128_r03']))
    eq = sum(a == b for a, b in zip(out, plain_r03[0]))
    for line, score, ref, ref_score, source in zip(out, sc, *plain_r03,
                                                   plain):
        if line != ref:
            check(prospective_cost(line, score, source)
                  <= prospective_cost(ref, ref_score, source) * 1.005 + 1e-6,
                  'f32 K3 beam: %r against %r is no near tie' % (line, ref))
    print('f32 beam_r03_plain through K3 (%d rows a step): %d/%d lines '
          'byte-equal to the golden, the others near ties; %d launches in %d '
          'iterations' % (steps.rows, eq, len(out), steps.calls, steps.calls))

    # (c) bfloat16: K3 under 'auto' against the per-op bf16 route
    bf = load_model(dev, 'bfloat16')
    bf.rejection_threshold = 0.3
    lines256 = (plain * 3)[:256]
    report = {}
    for batch_size, lines in ((256, lines256), (16, plain[:16])):
        bf.batch_size = batch_size
        before = launches_of()['decode_step']
        with StepCounter() as steps:
            out_k, _, sc_k, _ = beam_lines(bf, lines)
        launched = launches_of()['decode_step'] - before
        check(launched == steps.calls > 0, 'bf16 beam at B=%d: %d launches '
              'of K3 in %d iterations' % (batch_size, launched, steps.calls))
        check(steps.rows == STEP_ROWS['B%d_r03' % batch_size],
              'bf16 beam at B=%d: %d rows a step, K3 was checked and timed '
              'at %d' % (batch_size, steps.rows,
                         STEP_ROWS['B%d_r03' % batch_size]))
        beam._BEAM_STEP_KERNEL = 'off'
        try:
            out_p, _, _, _ = beam_lines(bf, lines)
        finally:
            beam._BEAM_STEP_KERNEL = 'auto'
        check(launches_of()['decode_step'] - before == launched,
              'the per-op bf16 beam launched K3')
        check(launches_of()['decode_step_gathered'] == 0,
              'the bf16 beam launched K3 on gathered windows: it reads them '
              'by index')
        # the same batch on the route serving takes outside a
        # StepCounter, the CUDA graph of the iteration: a first run
        # captures its keys (K3's wrapper counts each capture's launch
        # and its warm-ups'), a second replays them under the tracer;
        # both serve the same lines and scores, and each iteration of the
        # second is a replay or, where a key was declined, a K3 launch
        # from Python: together as many as the op-by-op run's launches
        before = launches_of()['decode_step']
        out_g, _, sc_g, _ = beam_lines(bf, lines)
        captured = launches_of()['decode_step'] - before
        (out_r, _, sc_r, _), counters = traced_counters(
            lambda: beam_lines(bf, lines), tmp)
        replayed = counters.get('decoders.beam_graph_iterations', 0)
        eager = launches_of()['decode_step'] - before - captured
        check(out_g == out_r == out_k and sc_g == sc_r == sc_k,
              'bf16 beam at B=%d: the CUDA graph of the iteration served '
              'other lines or scores than the iteration op by op'
              % batch_size)
        check(captured > 0 and captured % (beam._GRAPH_WARMUP + 1) == 0,
              'bf16 beam at B=%d: %d K3 launches in the captures'
              % (batch_size, captured))
        check(counters['decoders.beam_iterations'] == replayed + eager
              == launched, 'bf16 beam at B=%d under the CUDA graph: %d '
              'iterations, %d replays, %d K3 launches from Python; op by op '
              '%d launches' % (batch_size,
                               counters['decoders.beam_iterations'],
                               replayed, eager, launched))
        # agreement with the float32 golden, counted over the distinct
        # lines of the batch (the B=256 batch repeats the 120 lines)
        want = golden_corpus['modes']['beam_r03_plain']['output']
        eq_k = sum(a == b for a, b in zip(out_k, want))
        eq_p = sum(a == b for a, b in zip(out_p, want))
        distinct = min(len(lines), len(want))
        check(all(o.endswith('\n') for o in out_k)
              and all(0.0 <= x < 10.0 for x in sc_k),
              'bf16 beam through K3 gave malformed output')
        check(eq_k >= eq_p - 2, 'bf16 beam at B=%d: K3 agrees with the f32 '
              'golden on %d of %d lines, the per-op route on %d'
              % (batch_size, eq_k, distinct, eq_p))
        report['B%d' % batch_size] = dict(
            lines=len(lines), distinct_lines=distinct,
            rows_per_step=steps.rows, iterations=steps.calls,
            k3_launches=launched,
            k3_equal_to_f32_golden=eq_k, per_op_equal_to_f32_golden=eq_p)
        print('bf16 beam B=%-3d %d lines, %d rows a step: K3 %d launches in '
              '%d iterations; of %d distinct lines byte-equal to the f32 '
              'golden: K3 route %d, per-op route %d'
              % (batch_size, len(lines), steps.rows, launched, steps.calls,
                 distinct, eq_k, eq_p))
        for got, ref in zip(out_k, want):
            if got != ref:
                print('  K3 route %r, f32 golden %r' % (got, ref))

    # (d) the command lines, as modules, on the card
    page = os.path.join(tmp, 'page.txt')
    with open(page, 'w', encoding='utf-8') as f:
        f.write(''.join(plain[:8]))
    gt = os.path.join(tmp, 'gt.tsv')
    with open(gt, 'w', encoding='utf-8') as f:
        for src, tgt in zip(plain[:8], plain_r03[0]):
            f.write('%s\t%s\n' % (src.rstrip('\n'), tgt.rstrip('\n')))
    env = dict(os.environ, PYTHONPATH=ROOT)
    for module, data in (('proc', page), ('eval', gt)):
        run = subprocess.run(
            [sys.executable, '-m', 'cor_asv_ann_tpu_torch.scripts.' + module,
             '-m', FLAGSHIP, '-r', '0.3', data],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        check(run.returncode == 0, 'scripts.%s exited with %d:\n%s'
              % (module, run.returncode, run.stderr[-2000:]))
    with open(os.path.join(tmp, 'page.cor.txt'), encoding='utf-8') as f:
        check(f.read() == ''.join(plain_r03[0][:8]), 'scripts.proc without '
              '-f wrote other lines than correct_lines gave')
    check('CER beamed' in run.stderr, 'scripts.eval reported no beamed CER')
    print('scripts.proc without -f and scripts.eval: exit code 0, proc\'s '
          'output file equal to the f32 beam\'s lines')
    return report


PROCESSOR_CASES = ('glyph_beam', 'glyph_fast', 'line_beam')


def processor_path(torch, tmp, k3_launches):
    """ocrd-cor-asv-ann-process of the port on the flagship, held against
    the JAX processor's golden (tests/golden_page_process.json): (a) each
    case of the golden as ``python -m cor_asv_ann_tpu_torch.wrapper.
    transcode`` on the default device, f32, texts equal and confs within
    1e-3; (b) the port's evaluate on the glyph-level beam's output, its
    report equal to the golden's; (c) the glyph-level beam in bf16 through
    K3 (rejection 0.5, with alignments): of the 24 lines no fewer equal to
    the f32 golden than the per-op bf16 route's less 2 and than the JAX
    processor's bf16 beam's (in the golden), and all but 2 equal to that
    beam's own lines; (d)
    the processor server, byte-equal to the direct run; (e) the
    processor's times."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from torch_wrapper_pages import compare_pages, line_texts, write_workspace
    from cor_asv_ann_tpu_torch.utils import page as P
    from cor_asv_ann_tpu_torch.utils.workspace import Workspace, make_workspace
    from cor_asv_ann_tpu_torch.wrapper.evaluate import EvaluateLines
    from cor_asv_ann_tpu_torch.wrapper.server import (ProcessorServer,
                                                      client_process)
    from cor_asv_ann_tpu_torch.wrapper.transcode import ANNCorrection
    golden = load_json('tests', 'golden_page_process.json')
    model = os.path.join(ROOT, golden['model_file'])
    pages = {pid: data.encode('utf-8')
             for pid, data in golden['pages'].items()}
    n_lines = sum(len(line_texts(P, data)) for data in pages.values())
    grp_in, grp_out = golden['input_file_grp'], golden['output_file_grp']

    def workspace(name):
        root = os.path.join(tmp, name)
        write_workspace(make_workspace, root, pages, grp=grp_in)
        return root

    def outputs(root):
        out = {}
        for pid, f in Workspace(root).page_files(grp_out).items():
            with open(f.path, 'rb') as fh:
                out[pid] = fh.read()
        return out

    def flag(value):
        return 'true' if value else 'false'

    # (a) the command line as a module, f32 on the default device
    report = {'lines': n_lines, 'pages': len(pages)}
    direct = {}
    env = dict(os.environ, PYTHONPATH=ROOT)
    for case in PROCESSOR_CASES:
        want = golden['cases'][case]
        root = workspace(case)
        params = ['-P', 'model_file', model]
        for key, value in want['parameter'].items():
            params += ['-P', key, flag(value) if isinstance(value, bool)
                       else str(value)]
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, '-m', 'cor_asv_ann_tpu_torch.wrapper.transcode',
             '-m', root, '-I', grp_in, '-O', grp_out] + params,
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, 'wrapper.transcode %s exited with %d:\n%s'
              % (case, run.returncode, run.stderr[-3000:]))
        direct[case] = got = outputs(root)
        check(sorted(got) == sorted(want['output']),
              'wrapper.transcode %s wrote pages %s' % (case, sorted(got)))
        worst = 0.0
        for pid, data in want['output'].items():
            try:
                d, parted = compare_pages(data.encode('utf-8'), got[pid],
                                          1e-3)
            except AssertionError as exc:
                raise RuntimeError('check failed: f32 processor %s, page %s '
                                   'differs from the JAX golden at %s'
                                   % (case, pid, exc)) from None
            check(not parted, 'f32 processor %s parted lines %s'
                  % (case, parted))
            worst = max(worst, d)
        report[case + '_max_conf_diff'] = worst
        report[case + '_module_wall_s'] = wall
        print('processor %-10s as a module on cuda: pages equal to the JAX '
              'golden (tree, ids, coordinates, texts), largest conf '
              'difference %.3g; %.2f s wall for the process' % (case, worst,
                                                                wall))
    check(k3_launches() == 0, 'the f32 processor launched K3')

    # (b) evaluate of the glyph-level beam's output against its input
    ev = golden['evaluate']
    root = os.path.join(tmp, ev['case'])
    proc = EvaluateLines(parameter={})
    proc.process_workspace(root, ev['input_file_grp'].split(','), 'EVAL')
    check(proc.report == ev['report'], 'evaluate report %s differs from '
          'the golden %s' % (proc.report, ev['report']))
    print('evaluate of the glyph-level beam output: report equal to the '
          'golden (CER %.4f over %d lines)'
          % (proc.report['COR,OCR']['char-error-rate-mean'],
             proc.report['COR,OCR']['num-lines']))

    # (c) + (e) in-process: f32 beam, fast mode, bf16 beam through K3
    def timed_run(proc, name, reps=3):
        """Correct the workspace once to warm up, then `reps` times;
        returns the outputs and the best of the timed runs in s."""
        best = None
        for rep in range(reps + 1):
            root = workspace('%s_%d' % (name, rep))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proc.process_workspace(root, [grp_in], grp_out)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if rep:
                best = dt if best is None else min(best, dt)
        return outputs(root), best

    times = {}
    glyph = golden['cases']['glyph_beam']
    for name, fast in (('f32_beam', False), ('f32_fast', True)):
        proc = ANNCorrection(parameter={'model_file': model,
                                        'textequiv_level': 'glyph',
                                        'fast_mode': fast})
        check(proc.s2s.device.type == 'cuda', 'the processor serves on %s'
              % proc.s2s.device)
        out, times[name] = timed_run(proc, name)
        case = 'glyph_fast' if fast else 'glyph_beam'
        check(out == direct[case], 'in-process %s differs from the module '
              'run' % name)
    check(k3_launches() == 0, 'the f32 processor launched K3')
    # bf16 through K3 under 'auto', counted op by op, then timed on the
    # CUDA graph of the beam's iteration; then once on the per-op route:
    # the beam's bf16 bar is no fewer lines equal to the f32 golden than
    # the per-op route less 2, and than the JAX processor's bf16 beam
    # (the golden's glyph_beam_bfloat16_lines) less 2
    from cor_asv_ann_tpu_torch.models import beam
    proc = ANNCorrection(parameter={'model_file': model,
                                    'textequiv_level': 'glyph'})
    proc.s2s.compute = 'bfloat16'
    reps = 3
    with StepCounter() as steps:
        out, _ = timed_run(proc, 'bf16', reps)
    launched = k3_launches()
    check(launched == steps.calls > 0, 'bf16 processor: %d launches of K3 '
          'in %d beam iterations' % (launched, steps.calls))
    check(steps.rows == STEP_ROWS['B32_r05'], 'bf16 processor: %d rows a '
          'step, K3 was checked and timed at %d'
          % (steps.rows, STEP_ROWS['B32_r05']))
    out_g, times['bf16_beam_k3'] = timed_run(proc, 'bf16_graph', reps)
    # one more run under the tracer: each of its iterations is a replay
    # or, where a key was busy, a K3 launch from Python; together one
    # run's share of the op-by-op launches (timed_run makes reps + 1)
    traced = workspace('bf16_graph_traced')
    before = k3_launches()
    _, counters = traced_counters(lambda: proc.process_workspace(
        traced, [grp_in], grp_out), tmp)
    replayed = counters.get('decoders.beam_graph_iterations', 0)
    eager = k3_launches() - before
    check(out_g == out == outputs(traced), 'bf16 processor: the CUDA graph '
          'of the beam\'s iteration wrote other pages')
    check((replayed + eager) * (reps + 1) == launched
          == counters['decoders.beam_iterations'] * (reps + 1),
          'bf16 processor under the CUDA graph: %d replays and %d K3 '
          'launches from Python in a run, op by op %d launches in %d runs'
          % (replayed, eager, launched, reps + 1))
    total = k3_launches()
    beam._BEAM_STEP_KERNEL = 'off'
    try:
        out_p, times['bf16_beam_per_op'] = timed_run(proc, 'bf16_op', 1)
    finally:
        beam._BEAM_STEP_KERNEL = 'auto'
    check(k3_launches() == total, 'the per-op bf16 processor launched K3')

    def texts(pages_out):
        return [t for pid in sorted(pages_out)
                for t in line_texts(P, pages_out[pid])]
    want_lines = texts({pid: data.encode('utf-8')
                        for pid, data in glyph['output'].items()})
    got_lines, per_op_lines = texts(out), texts(out_p)
    jax_bf16 = golden['glyph_beam_bfloat16_lines']
    equal = sum(a == b for a, b in zip(got_lines, want_lines))
    equal_p = sum(a == b for a, b in zip(per_op_lines, want_lines))
    equal_j = sum(a == b for a, b in zip(jax_bf16, want_lines))
    same_j = [sum(a == b for a, b in zip(lines, jax_bf16))
              for lines in (got_lines, per_op_lines)]
    report.update(bf16_k3_launches=launched, bf16_iterations=steps.calls,
                  bf16_rows_per_step=steps.rows,
                  bf16_k3_lines_equal_to_f32_golden=equal,
                  bf16_per_op_lines_equal_to_f32_golden=equal_p,
                  jax_bf16_lines_equal_to_f32_golden=equal_j,
                  bf16_k3_lines_equal_to_jax_bf16=same_j[0],
                  bf16_per_op_lines_equal_to_jax_bf16=same_j[1])
    print('bf16 processor (glyph level, beam at rejection 0.5 with '
          'alignments) through K3: %d launches in %d iterations of up to %d '
          'rows over %d runs; lines equal to the f32 golden: K3 route %d of '
          '%d, per-op route %d, JAX bf16 processor %d; equal to the JAX '
          'bf16 processor\'s: K3 %d, per-op %d'
          % (launched, steps.calls, steps.rows, reps + 1, equal,
             len(want_lines), equal_p, equal_j, *same_j))
    for got, ref, per_op, jx in zip(got_lines, want_lines, per_op_lines,
                                    jax_bf16):
        if got != ref or per_op != ref:
            print('  K3 route %r, per-op %r, JAX bf16 %r, f32 golden %r'
                  % (got, per_op, jx, ref))
    # two valid bf16 roundings: K3 keeps no fewer f32 golden lines than
    # the per-op route less 2 and than the JAX bf16 processor, and gives
    # that processor's own lines on all but 2 (23 of 24 on an H100)
    check(len(got_lines) == len(want_lines) and equal >= equal_p - 2
          and equal >= equal_j and same_j[0] >= len(want_lines) - 2,
          'bf16 processor: through K3 %d of %d lines equal to the f32 '
          'golden, on the per-op route %d, the JAX bf16 processor %d; K3 '
          'equal to the JAX bf16 processor on %d'
          % (equal, len(want_lines), equal_p, equal_j, same_j[0]))
    for pid, data in out.items():
        for line in P.parse_page(data).get_lines():
            check(' '.join(w.get_text() or '' for w in line.get_words())
                  == line.get_text(), 'bf16 processor: the words of %s do '
                  'not give its text' % line.id)

    # (d) the processor server, the model resident on the card
    server = ProcessorServer(ANNCorrection, '127.0.0.1:0').start()
    try:
        root = workspace('served')
        reply = client_process(server.address, {
            'workspace': root, 'input_file_grp': grp_in,
            'output_file_grp': grp_out,
            'parameter': {'model_file': model,
                          'textequiv_level': 'glyph'}})
        check(reply.get('ok'), 'processor server: %s' % reply)
    finally:
        server.stop()
    check(outputs(root) == direct['glyph_beam'], 'the processor server '
          'wrote other bytes than the direct run')
    print('processor server on cuda: output byte-equal to the direct run')

    for name, t in times.items():
        report[name + '_s_per_page'] = t / len(pages)
        report[name + '_lines_per_s'] = n_lines / t
    print('processor times (glyph level, %d lines on %d pages, best of 3 '
          'after a warm-up): %s' % (n_lines, len(pages), json.dumps(
              {k: '%.4f s/page, %.1f lines/s' % (t / len(pages), n_lines / t)
               for k, t in times.items()})))
    return report


def write_keras_lm(path, voc_size, width, depth, context_dims, seed):
    """An ocrd_keraslm-shaped language model file, written with the port's
    h5write (Keras 2's ``save_weights`` layout: ``layer_names`` on the
    root, ``weight_names`` and ``<layer>/<layer>/<weight>:0`` on each
    layer group): `depth` LSTMs of `width` units over a one-hot input of
    voc_size + context_dims, then a dense readout; random weights."""
    import numpy as np
    from cor_asv_ann_tpu_torch.utils import h5write
    rng = np.random.default_rng(seed)
    lstms = ['lstm_%d' % (i + 1) for i in range(depth)]
    layers = ['input_1'] + lstms + ['dense_1']
    weights = {name: [('kernel:0', (voc_size + context_dims if i == 0
                                    else width, 4 * width)),
                      ('recurrent_kernel:0', (width, 4 * width)),
                      ('bias:0', (4 * width,))]
               for i, name in enumerate(lstms)}
    weights['dense_1'] = [('kernel:0', (width, voc_size)),
                          ('bias:0', (voc_size,))]
    arrays = {}
    with h5write.File(path, 'w') as f:
        f.attrs['layer_names'] = np.array([n.encode() for n in layers])
        f.attrs['backend'] = b'tensorflow'
        f.attrs['keras_version'] = b'2.2.4'
        f.create_group('input_1').attrs['weight_names'] = np.array([])
        for name, ws in weights.items():
            group = f.create_group(name)
            group.attrs['weight_names'] = np.array(
                [('%s/%s' % (name, w)).encode() for w, _ in ws])
            for w, shape in ws:
                key = '%s/%s' % (name, w)
                arrays[key] = (rng.standard_normal(shape) * 0.05).astype(
                    np.float32)
                group.create_dataset(key, data=arrays[key])
    return arrays


def make_long_lines(corpus, n=16):
    """n lines of 300-400 characters (the 384 bucket), golden-corpus
    lines joined by spaces."""
    lines, pieces = [], [line.rstrip('\n') for line in corpus]
    i = 0
    while len(lines) < n:
        text = ''
        while len(text) < 300:
            text = (text + ' ' + pieces[i % len(pieces)]).strip()
            i += 1
        lines.append(text[:400] + '\n')
    return lines


def long_beam_path(torch, dev, corpus, smi, k3_launches):
    """The bf16 beam of the flagship at rejection 0.3 on the 16 long
    lines of `tuning_path` (the 384 bucket, past the 256 up to which
    bfloat16 holds every position): through K3 under 'auto', one launch
    an iteration, and on the per-op route. The two routes are two valid
    roundings, and on lines this long the first rounding parts the
    searches on every line, so lines equal to the f32 beam's and the mean
    prospective costs are printed but not held (a K3 given window starts
    one position late finds solutions as cheap, PERF.md §6). The routes
    are held step by step instead: every K3 step is also taken on the
    per-op route on the same inputs, and its probabilities and alignment
    rows agree within LONG_STEP_BAR, which a control run with window
    starts one position late must fail. Lines/s of each route in
    turns."""
    import numpy as np
    from cor_asv_ann_tpu_torch.models import beam
    lines = make_long_lines(corpus)
    f32 = load_model(dev)
    f32.rejection_threshold = 0.3
    with StepCounter() as f32_steps:
        want, _, sc_f, _ = beam_lines(f32, lines)
    check(k3_launches() == 0, 'the f32 beam launched K3')
    bf = load_model(dev, 'bfloat16')
    bf.rejection_threshold = 0.3
    with StepCounter(compare=True) as steps:
        out_k, _, sc_k, _ = beam_lines(bf, lines)
    launched = k3_launches()
    check(launched == steps.calls > 0, 'bf16 beam at the %d bucket: %d '
          'launches of K3 in %d iterations' % (steps.positions, launched,
                                              steps.calls))
    check(steps.positions == LONG_T and steps.rows == LONG_ROWS,
          'bf16 long-line beam: %d rows a step in the %d bucket, K3 was '
          'checked and timed at %d rows in the %d bucket'
          % (steps.rows, steps.positions, LONG_ROWS, LONG_T))
    beam._BEAM_STEP_KERNEL = 'off'
    try:
        with StepCounter() as steps_p:
            out_p, _, sc_p, _ = beam_lines(bf, lines)
    finally:
        beam._BEAM_STEP_KERNEL = 'auto'
    check(k3_launches() == launched, 'the per-op bf16 beam launched K3')
    check(all(o.endswith('\n') for o in out_k + out_p)
          and np.isfinite(sc_k + sc_p).all(),
          'bf16 long-line beam: malformed output')
    eq_k = sum(a == b for a, b in zip(out_k, want))
    eq_p = sum(a == b for a, b in zip(out_p, want))
    same = sum(a == b for a, b in zip(out_k, out_p))

    def mean_cost(out, scores):
        return sum(prospective_cost(o, x, src) for o, x, src in
                   zip(out, scores, lines)) / len(lines)

    def mean_length_off(out):
        return sum(abs(len(o) - len(src)) for o, src in
                   zip(out, lines)) / len(lines)

    cost = {'f32': mean_cost(want, sc_f), 'k3': mean_cost(out_k, sc_k),
            'per_op': mean_cost(out_p, sc_p)}
    cost_ratio = cost['k3'] / cost['per_op']
    length_off = {'f32': mean_length_off(want),
                  'k3': mean_length_off(out_k),
                  'per_op': mean_length_off(out_p)}
    print('bf16 beam, %d lines of %d-%d characters (the %d bucket, %d rows a '
          'step): K3 %d launches in %d iterations (per-op %d, f32 %d); K3 '
          'steps against the per-op step on the same inputs: probabilities '
          'within %.4g, alignments within %.4g; lines equal to the f32 beam: '
          'K3 route %d, per-op route %d (K3 = per-op on %d); mean '
          'prospective cost K3 %.3f, per-op %.3f (ratio %.4f), f32 %.3f; mean '
          'characters off the source length K3 %.2f, per-op %.2f, f32 %.2f'
          % (len(lines), min(map(len, lines)), max(map(len, lines)),
             steps.positions, steps.rows, launched, steps.calls,
             steps_p.calls, f32_steps.calls, steps.probs_err,
             steps.align_err, eq_k, eq_p, same, cost['k3'], cost['per_op'],
             cost_ratio, cost['f32'], length_off['k3'],
             length_off['per_op'], length_off['f32']))
    check(steps.probs_err <= LONG_STEP_BAR['probs']
          and steps.align_err <= LONG_STEP_BAR['align'],
          'bf16 beam at the %d bucket: K3 steps differ from the per-op step '
          'on the same inputs by %g in the probabilities, %g in the '
          'alignments (bars %s)' % (LONG_T, steps.probs_err, steps.align_err,
                                    LONG_STEP_BAR))
    lps = {}
    for route in ('k3', 'per_op', 'k3_2', 'per_op_2'):
        beam._BEAM_STEP_KERNEL = 'auto' if route.startswith('k3') else 'off'
        try:
            lps[route] = lines_per_s(torch, bf, lines, reps=1, greedy=False)
        finally:
            beam._BEAM_STEP_KERNEL = 'auto'
    print('bf16 beam in the %d bucket, lines/s in turns: K3 %.2f / %.2f, '
          'per-op %.2f / %.2f (%s)' % (LONG_T, lps['k3'], lps['k3_2'],
                                       lps['per_op'], lps['per_op_2'], smi))
    main_path_launches = k3_launches()

    # the step bars' control: K3 given window starts one position late
    # (in range) must fail both; its launches are not the main path's
    indexed = beam.fused_decode_step_indexed

    def late(fb, h1, c1, h2, c2, u, attended, K, start, visible, weights):
        start = torch.clamp(start + 1, max=attended.shape[1]
                            - visible.shape[-1])
        return indexed(fb, h1, c1, h2, c2, u, attended, K, start, visible,
                       weights)
    beam.fused_decode_step_indexed = late
    try:
        with StepCounter(compare=True) as late_steps:
            out_l, _, sc_l, _ = beam_lines(bf, lines)
    finally:
        beam.fused_decode_step_indexed = indexed
    late_cost = mean_cost(out_l, sc_l)
    print('control, K3 given window starts one late: K3 steps against the '
          'per-op step on the same inputs: probabilities within %.4g, '
          'alignments within %.4g; mean prospective cost %.3f (ratio to '
          'per-op %.4f)' % (late_steps.probs_err, late_steps.align_err,
                            late_cost, late_cost / cost['per_op']))
    check(late_steps.probs_err > LONG_STEP_BAR['probs']
          and late_steps.align_err > LONG_STEP_BAR['align'],
          'the step bars %s pass K3 given window starts one late (%g, %g)'
          % (LONG_STEP_BAR, late_steps.probs_err, late_steps.align_err))
    return dict(lines=len(lines), chars=[min(map(len, lines)),
                                         max(map(len, lines))],
                bucket=steps.positions, rows_per_step=steps.rows,
                iterations=steps.calls, per_op_iterations=steps_p.calls,
                f32_iterations=f32_steps.calls, k3_launches=launched,
                k3_equal_to_f32=eq_k, per_op_equal_to_f32=eq_p,
                k3_equal_to_per_op=same, step_probs_err=steps.probs_err,
                step_align_err=steps.align_err, mean_cost=cost,
                mean_cost_ratio=cost_ratio,
                mean_length_off_source=length_off, lines_per_s=lps,
                main_path_k3_launches=main_path_launches,
                late_start_control=dict(
                    step_probs_err=late_steps.probs_err,
                    step_align_err=late_steps.align_err,
                    mean_cost=late_cost), card=smi)


def tuning_path(torch, dev, corpus, tmp):
    """The measurement and tuning surface on the flagship in bf16: the
    fused-decode autotune at B = 16-256 and by default; K1 against the
    per-op bf16 decode above B = 16 through correct_lines; a batch of long
    lines (the 384 bucket), which K1 must not take; ``proc -f
    --autotune-fused --torch-trace`` and ``eval --torch-trace`` as
    modules; an LM converted by ``transfer_dta_lm`` loaded into a d2/w512
    model that takes two training steps."""
    import numpy as np
    from cor_asv_ann_tpu_torch.models import api
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                     tree_map)
    from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
    from cor_asv_ann_tpu_torch.utils.data import gen_line_batches

    def k1():
        return dlk.decode_loop.launches

    report = {}
    bf = load_model(dev, 'bfloat16')
    # the autotune: a warm-up and `repeats` timed calls of each route at
    # each batch size, each K1 call one launch per tile of 16 lines
    batches, repeats = (16, 32, 64, 128, 256), 8
    before = k1()
    t0 = time.perf_counter()
    tuned = bf.autotune_fused_decode(batches=batches, repeats=repeats)
    tune_s = time.perf_counter() - t0
    check(tuned is not None, 'autotune_fused_decode declined on the card')
    check(tuned['chosen'] == api._pick_fused_bound(tuned['ratios']),
          'autotune window %s is not _pick_fused_bound of its ratios %s'
          % (tuned['chosen'], tuned['ratios']))
    tiles = sum(-(-b // 16) for b in batches)
    tune_launches = k1() - before
    check(tune_launches == (1 + repeats) * tiles,
          'autotune: %d K1 launches, %d tiles timed and %d warmed up'
          % (tune_launches, repeats * tiles, tiles))
    default = load_model(dev, 'bfloat16').autotune_fused_decode()
    check(default is not None
          and default['chosen'] == api._pick_fused_bound(default['ratios']),
          'default autotune: %s' % default)
    report['autotune'] = dict(ratios=tuned['ratios'],
                              window=tuned['chosen'], seconds=tune_s,
                              k1_launches=tune_launches,
                              default_ratios=default['ratios'],
                              default_window=default['chosen'])
    print('autotune B=%s: ratios (per-op / K1 wall time) %s, window %s, '
          '%d K1 launches, %.1f s; default B=(16, 32, 64): ratios %s, '
          'window %s' % (batches, json.dumps(tuned['ratios']),
                         tuned['chosen'], tune_launches, tune_s,
                         json.dumps(default['ratios']), default['chosen']))

    # K1 above B = 16 through correct_lines, its window forced open to B,
    # against the per-op bf16 decode: texts byte-equal, scores within
    # 5e-3 (phase_k1's bar)
    for B in (32, 64, 256):
        lines = (corpus * 3)[:B]
        bf.fused_decode_min_b, bf.fused_decode_max_b = 1, B
        bf.fused_decode = True
        before = k1()
        out_k, _, sc_k, _ = bf.correct_lines(list(lines),
                                             return_alignments=False)
        launched = k1() - before
        check(launched == -(-B // 16), 'B=%d: %d K1 launches, expected '
              'one a tile' % (B, launched))
        bf.fused_decode = False
        out_p, _, sc_p, _ = bf.correct_lines(list(lines),
                                             return_alignments=False)
        check(k1() - before == launched, 'the per-op decode launched K1')
        check(out_k == out_p, 'K1 at B=%d differs from the plain bf16 '
              'decode on %d lines' % (B, sum(a != b for a, b in
                                             zip(out_k, out_p))))
        d = max(abs(a - b) for a, b in zip(sc_k, sc_p))
        check(d <= 5e-3, 'K1 at B=%d: scores off the plain bf16 decode by '
              '%g' % (B, d))
        lps = {}
        for route in ('k1', 'per_op', 'k1_2', 'per_op_2'):
            bf.fused_decode = route.startswith('k1')
            lps[route] = lines_per_s(torch, bf, lines, reps=1)
        report['B%d' % B] = dict(k1_launches=launched, max_score_diff=d,
                                 k1_lines_per_s=(lps['k1'] + lps['k1_2']) / 2,
                                 per_op_lines_per_s=(lps['per_op']
                                                     + lps['per_op_2']) / 2)
        print('K1 at B=%d through correct_lines: %d launches, %d lines '
              'byte-equal to the per-op bf16 decode, max score diff %.3g; '
              'lines/s in turns K1 %.1f / %.1f, per-op %.1f / %.1f'
              % (B, launched, B, d, lps['k1'], lps['k1_2'], lps['per_op'],
                 lps['per_op_2']))
    bf.fused_decode = True
    bf.fused_decode_min_b, bf.fused_decode_max_b = 1, api.FUSED_DECODE_MAX_B

    # 16 lines of 300-400 characters: the 384 bucket, past K1's 256
    long_lines = make_long_lines(corpus)
    before = k1()
    out, _, sc, _ = bf.correct_lines(list(long_lines),
                                     return_alignments=False)
    check(k1() == before, 'K1 took the 384 bucket')
    check(len(out) == 16 and all(np.isfinite(sc)),
          'long lines: malformed output')
    lps_long = lines_per_s(torch, bf, long_lines)
    check(k1() == before, 'K1 took the 384 bucket')
    report['long_lines'] = dict(lines=16, chars=[min(map(len, long_lines)),
                                                 max(map(len, long_lines))],
                                lines_per_s=lps_long, k1_launches=0)
    print('16 lines of %d-%d characters (the 384 bucket), bf16: no K1 '
          'launch, %.1f lines/s' % (min(map(len, long_lines)),
                                    max(map(len, long_lines)), lps_long))

    # proc and eval as modules with a device trace
    src = os.path.join(tmp, 'page.txt')
    with open(src, 'w', encoding='utf-8') as f:
        f.write(''.join(corpus[:16]))
    trace_dir = os.path.join(tmp, 'trace')
    outputs = []
    for suffix, extra in (('.plain.txt', []),
                          ('.traced.txt', ['--autotune-fused',
                                           '--torch-trace', trace_dir])):
        cmd = [sys.executable, '-m', 'cor_asv_ann_tpu_torch.scripts.proc',
               '-m', FLAGSHIP, '-f', '--compute', 'bfloat16', '-s',
               suffix] + extra + [src]
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        check(run.returncode == 0, 'proc %s: exit %d: %s'
              % (extra, run.returncode, run.stderr[-2000:]))
        with open(os.path.join(tmp, 'page' + suffix), encoding='utf-8') as f:
            outputs.append(f.read())
    check(outputs[0] == outputs[1], 'proc --autotune-fused --torch-trace '
          'wrote other lines than proc without them')
    traces = [n for n in os.listdir(trace_dir) if n.endswith('.json')]
    check(len(traces) == 1, 'proc wrote %d traces' % len(traces))
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    k1_events = [e for e in kernels
                 if 'decode_loop_kernel' in e.get('name', '')]
    check(k1_events, 'the proc trace names no decode_loop_kernel among its '
          '%d device kernels' % len(kernels))
    gt = os.path.join(tmp, 'gt.tsv')
    with open(gt, 'w', encoding='utf-8') as f:
        f.write(''.join('%s\t%s\n' % (a.rstrip('\n'), b.rstrip('\n'))
                        for a, b in zip(corpus[:16],
                                        outputs[0].splitlines())))
    eval_trace = os.path.join(tmp, 'eval_trace')
    run = subprocess.run([sys.executable, '-m',
                          'cor_asv_ann_tpu_torch.scripts.eval', '-m',
                          FLAGSHIP, '-f', '--compute', 'bfloat16',
                          '--torch-trace', eval_trace, gt],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    check(run.returncode == 0 and len(os.listdir(eval_trace)) == 1,
          'eval --torch-trace: exit %d: %s' % (run.returncode,
                                               run.stderr[-2000:]))
    report['trace'] = dict(device_kernels=len(kernels),
                           decode_loop_kernel_events=len(k1_events),
                           bytes=os.path.getsize(os.path.join(trace_dir,
                                                              traces[0])))
    print('proc -f --compute bfloat16 --autotune-fused --torch-trace: the '
          'same %d lines as without the flags; its trace holds %d device '
          'kernels, %d of them decode_loop_kernel; eval --torch-trace: '
          'exit 0' % (len(outputs[0].splitlines()), len(kernels),
                      len(k1_events)))

    # an LM through transfer_dta_lm, into a d2/w512 model, two steps
    data = os.path.join(tmp, 'train.tsv')
    write_corpus(data, 256)
    s2s = new_trainer(dev, data, False, None)
    lm, init = os.path.join(tmp, 'lm.h5'), os.path.join(tmp, 'init.h5')
    arrays = write_keras_lm(lm, s2s.voc_size, 512, 2, 10, seed=13)
    run = subprocess.run([sys.executable, '-m',
                          'cor_asv_ann_tpu_torch.scripts.transfer_dta_lm',
                          lm, init], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    check(run.returncode == 0, 'transfer_dta_lm: exit %d: %s'
          % (run.returncode, run.stderr[-2000:]))
    s2s.load_transfer_weights(init)
    dec = s2s.params['decoder']
    check(np.array_equal(dec[0]['recurrent_kernel'],
                         arrays['lstm_1/recurrent_kernel:0'])
          and np.array_equal(dec[1]['cell']['kernel'][:512],
                             arrays['lstm_2/kernel:0']),
          'the LM did not land in the decoder')
    sources, confs, targets, _ = next(gen_line_batches(
        [data], s2s.batch_size, repeat=False))
    batch = T._vectorize(s2s.mapping, sources, targets, confs, s2s.logger)
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(s2s.params, dev))
    opt = T.make_optimizer(params, s2s.learning_rate)
    gen = torch.Generator().manual_seed(0)
    losses = [float(T.train_step(params, opt, s2s.config, *batch, gen))
              for _ in range(2)]
    check(all(np.isfinite(losses)), 'transfer: losses %s' % losses)
    report['transfer'] = dict(train_losses=losses,
                              batch=list(batch[0].shape))
    print('transfer_dta_lm: d2/w512 LM (input V+10 = %d) into a d2/w512 '
          'model, two train_steps at B=%d: losses %s'
          % (s2s.voc_size + 10, batch[0].shape[0],
             ', '.join('%.4f' % x for x in losses)))
    return report


def mesh_path(torch, dev, goldens, tmp, width=512, batch_size=256):
    """The multi-device layer (parallel/mesh.py) on the one card, the
    port's counterpart of the JAX package's dryrun_multichip:

    (a) a world of 1 on NCCL in this process: use_mesh() f32 greedy and
        beam serving of the golden lines, byte-equal to the goldens and
        to serving without a mesh; a bf16 mesh train_step of a d2/w512
        model without masked padding (K4-K7) at B = 256, T = 64, its loss
        equal to the unmeshed step's; ``python -m
        cor_asv_ann_tpu_torch.scripts.proc --mesh -1`` writing what proc
        without --mesh writes;
    (b) 2 ranks sharing the card through gloo (NCCL refuses two ranks on
        one device), spawned after the kernels were built: an f32 and a
        bf16 train_step of 128 rows a rank against one process's, with
        each rank's K4-K7 launches, and greedy and beam serving equal to
        one process's.

    Returns the report; its step times are the ranks' on a shared card,
    no scaling figure."""
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import torch_mesh_worker as MW
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    from cor_asv_ann_tpu_torch.parallel import mesh as M
    from cor_asv_ann_tpu_torch.utils.data import gen_line_batches
    data = os.path.join(tmp, 'train.tsv')
    write_corpus(data, 768)
    trainer = Sequence2Sequence(device=dev)
    trainer.width, trainer.depth, trainer.batch_size = width, 2, batch_size
    trainer.keras_padding = True
    trainer.map_files([data])
    trainer.configure()
    sources, confs, targets, _ = next(gen_line_batches(
        [data], batch_size, repeat=False))
    batch = T._vectorize(trainer.mapping, sources, targets, confs,
                         trainer.logger)
    config, params = trainer.config, trainer.params
    computes = ('float32', 'bfloat16')
    # launches of one step: the two directions of encoder layer 1,
    # encoder layer 2 and the lower decoder layer through K4/K5, the top
    # layer through K6/K7
    per_step = {'lstm_scan_fwd': 4, 'lstm_scan_bwd': 4, 'teacher_fwd': 1,
                'teacher_bwd': 1}
    if dev.type != 'cuda':  # a rehearsal on the CPU launches no kernel
        per_step = dict.fromkeys(per_step, 0)
    single = {c: MW.card_step(config, params, batch, c, dev, timed_steps=3)
              for c in computes}
    lines = goldens['inputs']
    served = MW.serve_file(FLAGSHIP, lines, dev)
    check(served['greedy'] == goldens['greedy']
          and served['beam'] == goldens['beamed'],
          'mesh_path: serving without a mesh differs from the goldens')
    report = {'shape': 'd2/w%d B=%d T=%d Td=%d, dropout %.1f' % (
        width, *batch[0].shape, batch[1].shape[1], config.dropout)}
    report['single_step_ms'] = {c: min(single[c]['ms']) for c in computes}

    # (b) 2 ranks on the card through gloo
    torch.cuda.empty_cache()
    rank_dev = 'cuda:%d' % (dev.index or 0) if dev.type == 'cuda' else 'cpu'
    ranks = MW.spawn(2, 'card_world', os.path.join(tmp, 'ranks'), config,
                     params, batch, computes, 3, (FLAGSHIP, lines), rank_dev)
    for rank, r in enumerate(ranks):
        check(r['backend'] == 'gloo' and r['shape'] == {'data': 2,
                                                        'model': 1},
              'mesh_path (b): rank %d: %s mesh %s' % (rank, r['backend'],
                                                      r['shape']))
        for c in computes:
            ok, detail = MW.steps_agree(r['steps'][c], single[c], c)
            check(ok, 'mesh_path (b): rank %d %s step differs from one '
                  'process\'s: %s' % (rank, c, detail))
            check(r['steps'][c]['launches'] == per_step,
                  'mesh_path (b): rank %d %s launches %s, expected %s'
                  % (rank, c, r['steps'][c]['launches'], per_step))
            report['gloo2_%s_rank%d' % (c, rank)] = dict(
                detail, step_ms=min(r['steps'][c]['ms']),
                launches=r['steps'][c]['launches'])
        ok, detail = MW.serving_agrees(r['serving'], served)
        check(ok, 'mesh_path (b): rank %d serving differs from one '
              'process\'s: %s' % (rank, detail))
        report['gloo2_serving_rank%d' % rank] = detail
    print('mesh_path (b): 2 ranks through gloo on %s, f32 and bf16 '
          'train_step equal to one process\'s, K4-K7 launches per rank %s, '
          'greedy and beam serving of %d lines equal'
          % (rank_dev, per_step, len(lines)))

    # (a) a world of 1 on NCCL in this process
    mesh = M.make_mesh(device=dev)
    check(mesh.shape == {'data': 1, 'model': 1},
          'mesh_path (a): mesh %s' % mesh.shape)
    report['world1_backend'] = dist.get_backend()
    meshed = MW.serve_file(FLAGSHIP, lines, dev, mesh)
    ok, detail = MW.serving_agrees(meshed, served)
    check(ok and meshed['greedy'] == goldens['greedy']
          and meshed['beam'] == goldens['beamed'],
          'mesh_path (a): use_mesh() serving differs from serving without '
          'a mesh or from the goldens: %s' % detail)
    report['world1_serving'] = detail
    one = MW.card_step(config, params, batch, 'bfloat16', dev, mesh,
                       timed_steps=3)
    ok, detail = MW.steps_agree(one, single['bfloat16'], 'bfloat16')
    check(ok and one['loss'] == single['bfloat16']['loss'],
          'mesh_path (a): the bf16 mesh step differs from the unmeshed '
          'one: %s' % detail)
    check(one['launches'] == per_step, 'mesh_path (a): launches %s, '
          'expected %s' % (one['launches'], per_step))
    report['world1_bfloat16'] = dict(detail, step_ms=min(one['ms']),
                                     launches=one['launches'])
    src = os.path.join(tmp, 'golden.txt')
    with open(src, 'w', encoding='utf-8') as f:
        f.write(''.join(lines))
    outputs = []
    for suffix, extra in (('.plain.txt', []), ('.mesh.txt', ['--mesh',
                                                             '-1'])):
        run = subprocess.run(
            [sys.executable, '-m', 'cor_asv_ann_tpu_torch.scripts.proc',
             '-m', FLAGSHIP, '-s', suffix, '--device', str(dev)] + extra
            + [src], cwd=tmp, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=300)
        check(run.returncode == 0, 'mesh_path (a): proc %s exited with '
              '%d:\n%s' % (extra, run.returncode, run.stderr[-2000:]))
        with open(os.path.join(tmp, 'golden' + suffix),
                  encoding='utf-8') as f:
            outputs.append(f.read())
    check(outputs[0] == outputs[1] and 'serving over mesh' in run.stderr,
          'mesh_path (a): proc --mesh -1 wrote other lines than proc')
    dist.destroy_process_group()
    print('mesh_path (a): a world of 1 on %s: use_mesh() greedy and beam '
          'byte-equal to the goldens, the bf16 mesh step\'s loss equal to '
          'the unmeshed one (%.6f), launches %s; proc --mesh -1 equal to '
          'proc' % (report['world1_backend'], one['loss'], one['launches']))
    return report


def beam_batch_launches(torch, s2s, lines):
    """All kernel launches of one beam batch under torch.profiler, and
    the beam's iterations in it."""
    from torch.profiler import ProfilerActivity, profile
    beam_lines(s2s, lines)
    torch.cuda.synchronize()
    with StepCounter() as steps, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        beam_lines(s2s, lines)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0)
    return launches, steps.calls


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, 'cor_asv_ann_tpu_torch')):
        print('chip_smoke: run from the root of a checkout',
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cor_asv_ann_tpu_torch.ops import _build
    from cor_asv_ann_tpu_torch.models import beam
    from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    from cor_asv_ann_tpu_torch.ops import lstm_step_kernel as k2
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    from cor_asv_ann_tpu_torch.ops.lstm import lstm_step
    dev = torch.device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print('torch %s, CUDA %s' % (torch.__version__, torch.version.cuda))

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print('kernels built in %.1f s' % (time.perf_counter() - t0))
    for line in _build.build_log.splitlines():
        if 'registers' in line or line.startswith('=='):
            print('  ' + line.strip())
    scan_plans(torch)

    goldens = load_json('tests', 'golden_decodes.json')
    golden_corpus = load_json('tests', 'golden_corpus.json')
    corpus = golden_corpus['inputs']['plain']

    # 2. K2 against its plain version
    k2_errs = phase_k2(torch, dev)
    # 3. K1 against the plain bf16 decode and its plain twin
    k1_err, k1_args = phase_k1(torch, dev, goldens, corpus)
    # K4 and K5 against their plain versions
    k4_errs = phase_k4(torch, dev)
    k5_errs = phase_k5(torch, dev)
    # K6 and K7 against their plain versions
    k6_errs = phase_k6(torch, dev)
    k7_errs = phase_k7(torch, dev)
    # K3 against its plain version
    k3_errs = phase_k3(torch, dev)
    # the serving encoder on K4 against the step-by-step scan
    serving_scan_report = serving_scan(torch, dev, corpus)

    # 4 + 5. the main paths, each with every launch count set to 0 just
    # before it and read just after it
    wrappers = {'decode_loop': dlk.decode_loop,
                'lstm_step': k2.lstm_step_fused,
                'lstm_scan_fwd': lsk.lstm_scan_fwd,
                'lstm_scan_bwd': lsk.lstm_scan_bwd,
                'teacher_fwd': tk.teacher_fwd,
                'teacher_bwd': tk.teacher_bwd,
                'decode_step': dsk.fused_decode_step,
                'decode_step_indexed': dsk.fused_decode_step_indexed}
    train_kernels = ('lstm_scan_fwd', 'lstm_scan_bwd', 'teacher_fwd',
                     'teacher_bwd')

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    reset_counts()
    main_path(torch, dev, goldens, corpus)
    launches = {k: wrappers[k].launches for k in ('decode_loop',
                                                  'lstm_step')}
    # the serving encoder's K4 launches, added to training's below
    serving_k4 = lsk.lstm_scan_fwd.launches
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        train_report = train_path(
            torch, dev, tmp,
            lambda: {k: wrappers[k].launches for k in train_kernels})
    launches.update({k: wrappers[k].launches for k in train_kernels})
    launches['lstm_scan_fwd'] += serving_k4
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        beam_report = beam_path(
            torch, dev, goldens, golden_corpus, tmp,
            lambda: {'decode_step': dsk.fused_decode_step.launches
                     + dsk.fused_decode_step_indexed.launches,
                     'decode_step_gathered': dsk.fused_decode_step.launches})
    # K3 in either form: the beam takes the indexed one
    def k3_launches():
        return dsk.fused_decode_step.launches \
            + dsk.fused_decode_step_indexed.launches

    launches['decode_step'] = k3_launches()
    launches['lstm_scan_fwd'] += lsk.lstm_scan_fwd.launches
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        processor_report = processor_path(torch, tmp, k3_launches)
    # the processor serves through the beam: K3 in bf16, and K4 for its
    # encoder's scans in either dtype
    check(lsk.lstm_scan_fwd.launches > 0
          and all(fn.launches == 0 for key, fn in wrappers.items()
                  if not key.startswith('decode_step')
                  and key != 'lstm_scan_fwd'),
          'the processor launched another kernel than K3 and K4, or no '
          'K4: %s' % {k: fn.launches for k, fn in wrappers.items()})
    launches['decode_step'] += k3_launches()
    launches['lstm_scan_fwd'] += lsk.lstm_scan_fwd.launches
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tuning_report = tuning_path(torch, dev, corpus, tmp)
    launches['decode_loop'] += dlk.decode_loop.launches
    launches['lstm_scan_fwd'] += lsk.lstm_scan_fwd.launches
    reset_counts()
    long_beam_report = long_beam_path(torch, dev, corpus, smi, k3_launches)
    launches['decode_step'] += long_beam_report['main_path_k3_launches']
    launches['lstm_scan_fwd'] += lsk.lstm_scan_fwd.launches
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_report = mesh_path(torch, dev, goldens, tmp)
    # this process's launches and those of the two ranks' first steps
    for k in train_kernels:
        launches[k] += wrappers[k].launches + sum(
            v['launches'][k] for key, v in mesh_report.items()
            if key.startswith('gloo2_') and 'launches' in v)
    print('main-path launches: %s' % launches)
    check(all(n > 0 for n in launches.values()),
          'a kernel of the main paths was not launched: %s' % launches)
    print('serving_scan: %s' % json.dumps(serving_scan_report))
    print('train_path: %s' % json.dumps(train_report))
    print('beam_path: %s' % json.dumps(beam_report))
    print('processor_path: %s' % json.dumps(processor_report))
    print('tuning_path: %s' % json.dumps(tuning_report))
    print('long_beam_path: %s' % json.dumps(long_beam_report))
    print('mesh_path: %s' % json.dumps(mesh_report))
    print('mesh_path step ms (%s; the two gloo ranks share this one card, '
          'so their times are no scaling figure): one process f32 %.1f, '
          'bf16 %.1f; world of 1 on NCCL bf16 %.1f; 2 ranks through gloo '
          'f32 %.1f / %.1f, bf16 %.1f / %.1f'
          % (smi, mesh_report['single_step_ms']['float32'],
             mesh_report['single_step_ms']['bfloat16'],
             mesh_report['world1_bfloat16']['step_ms'],
             *(mesh_report['gloo2_%s_rank%d' % (c, r)]['step_ms']
               for c in ('float32', 'bfloat16') for r in (0, 1))))

    # 6. times
    # K1 at B=16, T=64 (the serving regime it is dispatched for)
    idx, _, length, _ = dlk.decode_loop(*k1_args)
    steps = int(length.sum())
    k1_ms = cuda_time_ms(lambda: dlk.decode_loop(*k1_args), 10)
    k1_plain_ms = cuda_time_ms(lambda: dlk.decode_loop_reference(*k1_args),
                               2)
    attended, u = k1_args[0], k1_args[1]
    B, T, W = u.shape
    A = attended.shape[2]
    V = k1_args[5]['E'].shape[0]
    S = k1_args[7]
    wbytes = sum(t.numel() * t.element_size()
                 for t in k1_args[5].values())
    k1_bytes = (attended.numel() + u.numel() + 4 * B * W) * 2 \
        + 2 * B * T * 4 + wbytes + 2 * B * S * 4 + 2 * B * 4
    win = 2 * k1_args[8] + 1
    # per line-step: x, LSTM 1 (2 products), W_a, the visible energies,
    # ctx, the top cell (2 products) and the readout
    flops_step = 2 * (V * W + 2 * W * 4 * W + W * W + win * W + win * A
                      + (W + A) * 4 * W + W * 4 * W + V * W)
    k1_bound, k1_by = bound(k1_bytes, flops_step * steps, 'bfloat16')
    # the launch runs until its longest line is done: its steps set the time
    k1_steps = int(length.max())
    k1_plan = dlk.decode_loop_plan(W, A, V, k1_args[8], lines=B)
    print('K1 B=%d T=%d: kernel %.3f ms, plain twin %.3f ms, bound %.4f ms '
          '(%s; %d line-steps)' % (B, T, k1_ms, k1_plain_ms, k1_bound,
                                   k1_by, steps))
    print('K1 grid: %d unit blocks of %d units, %d attention and %d readout '
          'blocks, %d bytes of shared memory a block; longest line %d '
          'steps, %.2f us a step'
          % (k1_plan['unit_blocks'], k1_plan['units_per_block'],
             k1_plan['line_blocks'], k1_plan['line_blocks'],
             k1_plan['smem_bytes'], k1_steps, 1e3 * k1_ms / max(k1_steps, 1)))

    # K2 at D=1024, W=512 (the top cell's input): B=256 in float32 (the
    # dtype the f32 serving path launches it with) goes into the kernels
    # line; bfloat16, and B=16 (greedy serving's small batches) beside it.
    # torch.lstm_cell computes the same function (gate order i, f, g, o)
    # with the kernels transposed; timed in turns with the kernel as the
    # library yardstick only
    k2_t = {}
    for B2 in (256, 16):
        gen = torch.Generator().manual_seed(1)
        D2, W2 = 1024, 512
        base = [(torch.rand(B2, D2, generator=gen) * 2 - 1),
                (torch.rand(B2, W2, generator=gen) * 2 - 1),
                (torch.rand(B2, W2, generator=gen) * 2 - 1),
                (torch.randn(D2, 4 * W2, generator=gen) * 0.05),
                (torch.randn(W2, 4 * W2, generator=gen) * 0.05),
                (torch.randn(4 * W2, generator=gen) * 0.5)]
        k2_bytes = 4 * (B2 * D2 + 2 * B2 * W2 + D2 * 4 * W2 + W2 * 4 * W2
                        + 4 * W2 + 2 * B2 * W2)
        k2_flops = 2 * B2 * (D2 + W2) * 4 * W2
        for dt in (torch.float32, torch.bfloat16):
            x, h, c, K, R, bias = (t.to(dt).to(dev) for t in base)
            w = {'kernel': K, 'recurrent_kernel': R, 'bias': bias}
            Kt, Rt = K.t().contiguous(), R.t().contiguous()
            zero = torch.zeros_like(bias)
            name = _dtype_name(dt)
            t = {}
            for key, fn in (('ms', lambda: k2.lstm_step_fused(x, h, c, K, R,
                                                              bias)),
                            ('library_ms', lambda: torch.lstm_cell(
                                x, (h, c), Kt, Rt, bias, zero)),
                            ('ms2', lambda: k2.lstm_step_fused(x, h, c, K, R,
                                                               bias)),
                            ('library_ms2', lambda: torch.lstm_cell(
                                x, (h, c), Kt, Rt, bias, zero))):
                t[key] = cuda_time_ms(fn, 200)
            t['plain_ms'] = cuda_time_ms(lambda: lstm_step(x, h, c, w), 100)
            t['bound_ms'], t['bound_by'] = bound(
                k2_bytes * dt.itemsize // 4, k2_flops, name)
            # the kernel and the library call, each the mean of its two turns
            t['ms'] = (t['ms'] + t.pop('ms2')) / 2
            t['library_ms'] = (t['library_ms'] + t.pop('library_ms2')) / 2
            k2_t[(name, B2)] = t
            print('K2 %-8s B=%-3d D=%d: kernel %.4f ms, plain %.4f ms, '
                  'torch.lstm_cell %.4f ms, bound %.4f ms (%s)'
                  % (name, B2, D2, t['ms'], t['plain_ms'], t['library_ms'],
                     t['bound_ms'], t['bound_by']))

    # K4 and K5 at T=128, B=256, N=512, the shape the flagship's training
    # batch gives them; bfloat16 goes into the kernels line
    scan_f32 = scan_times(torch, dev, torch.float32)
    scan_bf16 = scan_times(torch, dev, torch.bfloat16)
    # K6 and K7 at B=256, Td=T=128, W=A=512, likewise
    teacher_f32 = teacher_times(torch, dev, torch.float32)
    teacher_bf16 = teacher_times(torch, dev, torch.bfloat16)
    # K3 at the rows of a beam step (STEP_ROWS); bfloat16 at the rows of
    # the B=256 batch that `beam_path` served goes into the kernels line
    step_t = {(name, N): step_times(torch, dev, dt, N)
              for name, dt in (('float32', torch.float32),
                               ('bfloat16', torch.bfloat16))
              for N in sorted(STEP_ROWS.values())}
    # and at the rows and bucket of `long_beam_path`
    step_t[('bfloat16_T%d' % LONG_T, LONG_ROWS)] = step_times(
        torch, dev, torch.bfloat16, LONG_ROWS, LONG_T)

    # serving throughput through correct_lines
    lines256 = (corpus * 3)[:256]
    f32 = load_model(dev)
    bf = load_model(dev, 'bfloat16')
    lps = {'f32_B256': lines_per_s(torch, f32, lines256),
           'bf16_B256': lines_per_s(torch, bf, lines256),
           'bf16_B16_fused': lines_per_s(torch, bf, corpus[:16])}
    bf.fused_decode = False
    lps['bf16_B16_plain'] = lines_per_s(torch, bf, corpus[:16])
    print('correct_lines lines/s: %s' % json.dumps(
        {k: round(v, 1) for k, v in lps.items()}))

    # beam throughput through correct_lines (rejection 0.3, auto bounds
    # R=32, K=48), and all launches of a B=16 batch on each route
    for s2s in (f32, bf):
        s2s.rejection_threshold = 0.3
    blps = {'f32_B256_per_op': lines_per_s(torch, f32, lines256, greedy=False),
            'bf16_B256_K3': lines_per_s(torch, bf, lines256, greedy=False)}
    bf.batch_size = 16
    blps['bf16_B16_K3'] = lines_per_s(torch, bf, corpus[:16], greedy=False)
    k3_batch = beam_batch_launches(torch, bf, corpus[:16])
    beam._BEAM_STEP_KERNEL = 'off'
    try:
        blps['bf16_B16_per_op'] = lines_per_s(torch, bf, corpus[:16],
                                              greedy=False)
        per_op_batch = beam_batch_launches(torch, bf, corpus[:16])
        bf.batch_size = 256
        blps['bf16_B256_per_op'] = lines_per_s(torch, bf, lines256,
                                               greedy=False)
    finally:
        beam._BEAM_STEP_KERNEL = 'auto'
    print('beam correct_lines lines/s: %s' % json.dumps(
        {k: round(v, 1) for k, v in blps.items()}))
    print('beam bf16 B=16 batch, all kernel launches / iterations: K3 route '
          '%d / %d (%.1f per iteration), per-op route %d / %d (%.1f per '
          'iteration)' % (*k3_batch, k3_batch[0] / k3_batch[1],
                          *per_op_batch, per_op_batch[0] / per_op_batch[1]))

    kernels = [
        dict(name='decode_loop', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/decode_loop.cu',
             design='one cooperative launch per tile of 16 lines: unit '
                    'blocks with their gate columns resident in shared '
                    'memory and the products on mma.sync, attention and '
                    'readout blocks for the lines, the readout of a step '
                    'beside the attention of the next',
             replaces='cor_asv_ann_tpu/ops/pallas_decode_loop.py:112',
             launches=launches['decode_loop'], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
             bound_by=k1_by, library_ms=None),
        dict(name='lstm_step', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/lstm_step.cu',
             replaces='cor_asv_ann_tpu/ops/pallas_lstm.py:27',
             launches=launches['lstm_step'],
             max_abs_err=max(v for k, v in k2_errs.items()
                             if k[0] == 'float32'),
             **k2_t[('float32', 256)]),
        dict(name='lstm_scan_fwd', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/lstm_scan.cu',
             replaces='cor_asv_ann_tpu/ops/pallas_lstm_train.py:55',
             launches=launches['lstm_scan_fwd'],
             max_abs_err=max(v for k, v in k4_errs.items()
                             if k[0] == 'bfloat16'),
             ms=scan_bf16['fwd_ms'], plain_ms=scan_bf16['fwd_plain_ms'],
             bound_ms=scan_bf16['fwd_bound_ms'],
             bound_by=scan_bf16['fwd_bound_by'],
             library_ms=scan_bf16['fwd_library_ms']),
        dict(name='lstm_scan_bwd', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/lstm_scan.cu',
             replaces='cor_asv_ann_tpu/ops/pallas_lstm_train.py:91',
             launches=launches['lstm_scan_bwd'],
             max_abs_err=max(v for k, v in k5_errs.items()
                             if k[0] == 'bfloat16'),
             ms=scan_bf16['bwd_ms'], plain_ms=scan_bf16['bwd_plain_ms'],
             bound_ms=scan_bf16['bwd_bound_ms'],
             bound_by=scan_bf16['bwd_bound_by'],
             library_ms=scan_bf16['bwd_library_ms']),
        dict(name='teacher_fwd', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/teacher_scan.cu',
             design='stage kernels: per step the products h.[W_a | R], '
                    'the attention a block a row, and the gate products '
                    'cg.Kc with the cell in their epilogue',
             replaces='cor_asv_ann_tpu/ops/pallas_teacher.py:131',
             launches=launches['teacher_fwd'],
             max_abs_err=max(v for k, v in k6_errs.items()
                             if k[0] == 'bfloat16'),
             ms=teacher_bf16['fwd_ms'],
             plain_ms=teacher_bf16['fwd_plain_ms'],
             bound_ms=teacher_bf16['fwd_bound_ms'],
             bound_by=teacher_bf16['fwd_bound_by'], library_ms=None),
        dict(name='teacher_bwd', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/teacher_bwd.cu',
             design='stage kernels: wvec of every step in one product, '
                    'then per step the gate products, the attention '
                    'backward and the carry',
             replaces='cor_asv_ann_tpu/ops/pallas_teacher.py:195',
             launches=launches['teacher_bwd'],
             max_abs_err=max(v for k, v in k7_errs.items()
                             if k[0] == 'bfloat16'),
             ms=teacher_bf16['bwd_ms'],
             plain_ms=teacher_bf16['bwd_plain_ms'],
             bound_ms=teacher_bf16['bwd_bound_ms'],
             bound_by=teacher_bf16['bwd_bound_by'], library_ms=None),
        dict(name='decode_step', route='cuda',
             source='cor_asv_ann_tpu_torch/csrc/decode_step.cu',
             replaces='cor_asv_ann_tpu/ops/pallas_decode.py:43',
             launches=launches['decode_step'],
             max_abs_err=max(v for k, v in k3_errs.items()
                             if k[0] == 'bfloat16'),
             library_ms=None,
             **{k: step_t[('bfloat16', STEP_ROWS['B256_r03'])][k]
                for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by')}),
    ]
    print('scan kernels float32: %s' % json.dumps(scan_f32))
    print('teacher kernels float32: %s' % json.dumps(teacher_f32))
    print('LSTM step kernel: %s' % json.dumps(
        {'%s_B%d' % k: v for k, v in k2_t.items()}))
    print('decode step kernel: %s' % json.dumps(
        {'%s_N%d' % k: v for k, v in step_t.items()}))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
