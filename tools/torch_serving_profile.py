#!/usr/bin/env python3
"""Where the time of greedy serving, of beam serving, or of a training
step, goes on the GPU (PyTorch port).

Run from the repo root on a machine with a CUDA GPU:

    python3 tools/torch_serving_profile.py [--train | --beam] [--out DIR]

Without ``--train`` or ``--beam`` it serves the golden-corpus lines of
the d2/w512 flagship through ``Sequence2Sequence.correct_lines`` in two
regimes, float32 at B=256 (``decode_greedy``) and bfloat16 at B=16 (the
whole-loop kernel). With ``--train`` it takes one ``train_step`` of a
randomly initialised d2/w512 model at B=256, T=Td=128 on synthetic
lines, without masked padding (all four LSTM scans through the scan
kernels, the top decoder layer through the fused teacher kernels), in
float32 and bfloat16, in bfloat16 with the teacher kernels switched off
(the dense per-step body under autograd), and with the scan kernels
switched off as well. With ``--beam`` it serves the same lines through
``correct_lines(greedy=False)`` (rejection 0.3, automatic bounds R=32,
K=48): float32 at B=256 on the per-op route, bfloat16 at B=256 and at
B=16 through the fused decode-step kernel and with it switched off; it
adds the beam's iterations, the launches per iteration, the
decode-step kernel's share of the device time and the launches and time
of advanced-indexing kernels (the per-op route gathers the window rows
with two of them an iteration; the K3 route reads them by index). For each regime it
prints the wall time under the profiler, the device busy time summed
over kernels (so the idle share of the device), the kernel launch count
and the top kernels by device time, from ``torch.profiler``. Writes each trace as a chrome
trace under --out (default build/profile). Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, 'testmodels', 'flagship.d2.w512.synthetic.h5')
# the CUDA kernels of the fused decode step (csrc/decode_step.cu: one
# launch of each per step)
K3_KERNELS = ('step_prep_kernel', 'step_xw_kernel', 'step_lstm_kernel',
              'step_attention_kernel', 'step_readout_kernel')


def profile(torch, run, n_lines, name, out_dir, beam_steps=None):
    """Profile one call of `run()` after a warm-up call. `beam_steps`: a
    callable giving the beam iterations made so far (`count_beam_steps`)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    run()                                                     # warm-up
    torch.cuda.synchronize()
    steps_before = beam_steps() if beam_steps else 0
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's self device time is that of
    # the kernels it launched, which are listed themselves
    kernels = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        key=lambda k: -k[2])
    busy_ms = sum(k[2] for k in kernels)
    launches = sum(k[1] for k in kernels)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, name + '.json'))
    summary = {'regime': name, 'lines': n_lines,
               'wall_ms': wall * 1e3, 'device_busy_ms': busy_ms,
               'device_idle_share': 1.0 - busy_ms / (wall * 1e3),
               'kernel_launches': launches,
               'top': [{'name': k[0][:60], 'count': k[1], 'ms': k[2]}
                       for k in kernels[:8]]}
    if beam_steps:
        steps = beam_steps() - steps_before
        summary.update(
            beam_iterations=steps,
            launches_per_iteration=launches / max(steps, 1),
            decode_step_kernel_share=sum(
                k[2] for k in kernels if any(n in k[0] for n in K3_KERNELS))
            / max(busy_ms, 1e-9),
            # advanced indexing (the per-op route's window gathers are
            # two of these an iteration)
            index_kernel_launches=sum(
                k[1] for k in kernels if 'index_elementwise' in k[0]),
            index_kernel_ms=sum(
                k[2] for k in kernels if 'index_elementwise' in k[0]))
    print(json.dumps(summary))
    return summary


def count_beam_steps():
    """Wrap the beam's decoder step with a counter; returns a callable
    that gives the steps (one per iteration of the search) made so far."""
    from cor_asv_ann_tpu_torch.models import beam
    step, calls = beam.beam_decoder_step, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return step(*args, **kw)

    beam.beam_decoder_step = counted
    return lambda: calls[0]


def profile_beam(torch, s2s, corpus, out_dir):
    from cor_asv_ann_tpu_torch.models import beam
    s2s.rejection_threshold = 0.3
    lines256 = (corpus * 3)[:256]
    steps = count_beam_steps()

    def serve(lines):
        return lambda: s2s.correct_lines(list(lines), fast=False,
                                         greedy=False,
                                         return_alignments=False)

    profile(torch, serve(lines256), 256, 'beam_f32_B256_per_op', out_dir,
            steps)
    s2s.compute = 'bfloat16'
    for batch_size, lines in ((256, lines256), (16, corpus[:16])):
        s2s.batch_size = batch_size
        for route, flag in (('K3', 'auto'), ('per_op', 'off')):
            beam._BEAM_STEP_KERNEL = flag
            try:
                profile(torch, serve(lines), len(lines),
                        'beam_bf16_B%d_%s' % (batch_size, route), out_dir,
                        steps)
            finally:
                beam._BEAM_STEP_KERNEL = 'auto'


def profile_training(torch, out_dir):
    from cor_asv_ann_tpu_torch.models import seq2seq
    from cor_asv_ann_tpu_torch.models import train as T
    from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
    from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                     tree_map)
    from cor_asv_ann_tpu_torch.utils.data import (CharMapping,
                                                  vectorize_lines_indices)
    from cor_asv_ann_tpu_torch.utils.synthdata import make_pairs
    pairs = make_pairs(256, seed=7)
    sources = [a + '\n' for a, _ in pairs]
    targets = [b + '\n' for _, b in pairs]
    mapping = CharMapping.from_texts(sources + targets)
    config = Seq2SeqConfig(width=512, depth=2, voc_size=mapping.voc_size,
                           mask_padding=False)
    enc, dec_in, dec_out, w = vectorize_lines_indices(mapping, sources,
                                                      targets)
    # pad to the T = Td = 128 bucket of long lines
    pad = ((0, 0), (0, 128 - enc.shape[1]))
    enc, dec_in, dec_out = (np.pad(a, pad, constant_values=-1)
                            for a in (enc, dec_in, dec_out))
    batch = (enc, dec_in, dec_out, np.pad(w, pad))
    for name, compute, scan, teacher in (
            ('train_f32', None, 'auto', 'auto'),
            ('train_bf16', 'bfloat16', 'auto', 'auto'),
            ('train_bf16_dense_teacher', 'bfloat16', 'auto', 'off'),
            ('train_bf16_dense_teacher_plain_scan', 'bfloat16', 'off',
             'off')):
        params = tree_map(lambda t: t.requires_grad_(),
                          params_from_numpy(init_params(config, seed=1),
                                            'cuda'))
        opt = T.make_optimizer(params)
        gen = torch.Generator().manual_seed(0)
        seq2seq._FUSED_SCAN = scan
        seq2seq._TEACHER_KERNEL = teacher
        try:
            profile(torch,
                    lambda: T.train_step(params, opt, config, *batch, gen,
                                         compute_dtype=compute),
                    256, name, out_dir)
        finally:
            seq2seq._FUSED_SCAN = 'auto'
            seq2seq._TEACHER_KERNEL = 'auto'


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build', 'profile'),
                    help='directory for the chrome traces')
    ap.add_argument('--train', action='store_true',
                    help='profile training steps instead of serving')
    ap.add_argument('--beam', action='store_true',
                    help='profile beam serving instead of greedy serving')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.train:
        profile_training(torch, args.out)
        return 0
    with open(os.path.join(ROOT, 'tests', 'golden_corpus.json')) as f:
        corpus = json.load(f)['inputs']['plain']
    s2s = Sequence2Sequence(device='cuda')
    s2s.load_config(FLAGSHIP)
    s2s.configure()
    s2s.load_weights(FLAGSHIP)
    if args.beam:
        profile_beam(torch, s2s, corpus, args.out)
        return 0

    def serve(lines):
        return lambda: s2s.correct_lines(list(lines),
                                         return_alignments=False)

    profile(torch, serve((corpus * 3)[:256]), 256, 'f32_B256', args.out)
    s2s.compute = 'bfloat16'
    profile(torch, serve(corpus[:16]), 16, 'bf16_B16_fused', args.out)
    s2s.fused_decode = False
    profile(torch, serve(corpus[:16]), 16, 'bf16_B16_plain', args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
