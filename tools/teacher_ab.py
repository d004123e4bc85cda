#!/usr/bin/env python3
"""K6/K7 and the T=128 training step of two checkouts of the port, in
turns on one GPU.

    python3 tools/teacher_ab.py ROOT_A ROOT_B [--rounds 2]

Runs a fresh process for each checkout in the order A, B, B, A (with
``--rounds 2``), each importing ``cor_asv_ann_tpu_torch`` from its own
root and building its own kernels there. Each process times
``teacher_bwd`` (K7) and ``teacher_fwd`` (K6) at B=256, Td=T=128,
W=A=512 with dropout masks in bfloat16 and float32 (CUDA events, mean of
5 calls after a warm-up; the inputs of ``chip_smoke.py:teacher_times``),
and the device time of each kernel that a K6 or a K7 call launches, by
name, from ``torch.profiler`` (the stage kernels ``teacher_fwd_<stage>``
and ``teacher_bwd_<stage>`` where the checkout has them). Then six
``train_step``s of a randomly initialised d2/w512 model at B=256,
T=Td=128, bfloat16, without masked padding (the best step after the
first, host clock around a synchronised step; the host's share of a step
moves between runs) and its peak device memory. Prints the card's name
and power limit and one JSON line per process. Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, re, sys, time
import numpy as np
import torch
sys.path.insert(0, ROOT)
from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
from cor_asv_ann_tpu_torch.models import train as T
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models.params import params_from_numpy, tree_map
from cor_asv_ann_tpu_torch.utils.data import CharMapping, vectorize_lines_indices
from cor_asv_ann_tpu_torch.utils.synthdata import make_pairs


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, kind):
    """Device ms of each CUDA kernel of one fn() call whose name starts
    with teacher_<kind>, by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r'teacher_%s\w*' % kind, e.key)
        us = e.self_device_time_total
        if found and us > 0:
            name = found.group(0)
            ms_, n = out.get(name, (0.0, 0))
            out[name] = (ms_ + us / 1e3, n + e.count)
    return out


def inputs(dt, B, Td, Tn, W, A, seed):
    gen = torch.Generator().manual_seed(seed)

    def mk(shape, scale, dtype=dt):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).cuda()

    zx = mk((Td, B, 4 * W), 1.0, torch.float32)
    u, att = mk((B, Tn, W), 0.5), mk((B, Tn, A), 0.5)
    Kc, R = mk((A, 4 * W), A ** -0.5), mk((W, 4 * W), W ** -0.5)
    W_a, v = mk((W, W), W ** -0.5), mk((1, W), 2 * W ** -0.5)
    b_UW, b_v = mk((1, W), 0.1), mk((1, 1), 0.1, torch.float32)
    bias = mk((1, 4 * W), 0.1)
    maskc = ((torch.rand(4, B, A, generator=gen) < 0.8) / 0.8).to(dt).cuda()
    h0, c0 = mk((B, W), 0.2), mk((B, W), 0.2)
    return [zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0]


out = {'root': ROOT}
B, Td, Tn, W, A, ww = 256, 128, 128, 512, 512, 5
for dt in (torch.bfloat16, torch.float32):
    name = str(dt).split('.')[-1]
    ins = inputs(dt, B, Td, Tn, W, A, 11)
    zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0 = ins
    hs, cs, aa, zs = tk.teacher_fwd(*ins, ww)
    g = torch.full_like(hs, 1e-3)
    bwd = (zs, g, torch.cat([h0[None], hs[:-1]]),
           torch.cat([c0[None], cs[:-1]]), cs, aa, u, att, Kc, R, W_a, v,
           b_UW, maskc, ww)
    out['K7_%s_ms' % name] = ms(lambda: tk.teacher_bwd(*bwd))
    out['K6_%s_ms' % name] = ms(lambda: tk.teacher_fwd(*ins, ww))
    out['K7_%s_kernels_ms' % name] = kernel_ms(lambda: tk.teacher_bwd(*bwd),
                                               'bwd')
    out['K6_%s_kernels_ms' % name] = kernel_ms(
        lambda: tk.teacher_fwd(*ins, ww), 'fwd')
    del ins, hs, cs, aa, zs, g, bwd
pairs = make_pairs(256, seed=7)
sources = [a + '\n' for a, _ in pairs]
targets = [b + '\n' for _, b in pairs]
mapping = CharMapping.from_texts(sources + targets)
config = Seq2SeqConfig(width=512, depth=2, voc_size=mapping.voc_size,
                       mask_padding=False)
enc, dec_in, dec_out, w = vectorize_lines_indices(mapping, sources, targets)
pad = ((0, 0), (0, 128 - enc.shape[1]))
enc, dec_in, dec_out = (np.pad(a, pad, constant_values=-1)
                        for a in (enc, dec_in, dec_out))
batch = (enc, dec_in, dec_out, np.pad(w, pad))
params = tree_map(lambda t: t.requires_grad_(),
                  params_from_numpy(init_params(config, seed=1), 'cuda'))
opt = T.make_optimizer(params)
gen = torch.Generator().manual_seed(0)
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
times = []
for _ in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = T.train_step(params, opt, config, *batch, gen,
                        compute_dtype='bfloat16')
    float(loss)
    times.append((time.perf_counter() - t0) * 1e3)
out['train_bf16_T128_step_ms'] = min(times[1:])
out['train_bf16_T128_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
print(json.dumps(out))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('roots', nargs=2, help='two checkouts of the repo')
    ap.add_argument('--rounds', type=int, default=2,
                    help='A,B then B,A per two rounds')
    args = ap.parse_args()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    order = []
    for r in range(args.rounds):
        order += list(args.roots) if r % 2 == 0 else list(args.roots)[::-1]
    for root in order:
        root = os.path.abspath(root)
        code = 'ROOT = %r\n' % root + CHILD
        proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == '__main__':
    sys.exit(main())
