#!/usr/bin/env python3
"""K4/K5 and the T=128 training step of two checkouts of the port, in
turns on one GPU.

    python3 tools/scan_ab.py ROOT_A ROOT_B [--rounds 2]

Runs a fresh process for each checkout in the order A, B, B, A (with
``--rounds 2``), each importing ``cor_asv_ann_tpu_torch`` from its own
root and building its own kernels there. Each process times
``lstm_scan_fwd`` and ``lstm_scan_bwd`` at T=128, B=256, N=512 in
bfloat16 and float32 (CUDA events, mean of 5 launches after a warm-up),
then three ``train_step``s of a randomly initialised d2/w512 model at
B=256, T=Td=128, bfloat16, without masked padding (the best step after
the first, host clock around a synchronised step) and its peak device
memory. Prints one JSON line per process and the card's name and power
limit. Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ROOT)
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
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


out = {'root': ROOT}
dev = torch.device('cuda')
Tn, B, N = 128, 256, 512
for dt in (torch.bfloat16, torch.float32):
    gen = torch.Generator().manual_seed(6)
    zx = torch.randn(Tn, B, 4 * N, generator=gen).to(dt).to(dev)
    R = (torch.randn(N, 4 * N, generator=gen) / N ** 0.5).to(dt).to(dev)
    h0 = (torch.randn(B, N, generator=gen) * 0.2).to(dt).to(dev)
    c0 = (torch.randn(B, N, generator=gen) * 0.2).to(dt).to(dev)
    hs, cs, _, _ = lsk.lstm_scan_fwd(zx, R, h0, c0)
    hprev = torch.cat([h0[None], hs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    g = torch.full_like(hs, 1e-3)
    name = str(dt).split('.')[-1]
    out['K4_%s_ms' % name] = ms(lambda: lsk.lstm_scan_fwd(zx, R, h0, c0))
    out['K5_%s_ms' % name] = ms(
        lambda: lsk.lstm_scan_bwd(g, g[0], g[0], zx, R, hprev, cprev, cs))
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
torch.cuda.reset_peak_memory_stats()
times = []
for _ in range(3):
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
