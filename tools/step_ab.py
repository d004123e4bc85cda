#!/usr/bin/env python3
"""K2 (the LSTM step) and K3 (the fused decode step) of two checkouts of
the port, in turns on one GPU.

    python3 tools/step_ab.py ROOT_A ROOT_B [--rounds 2]

Runs a fresh process for each checkout in the order A, B, B, A (with
``--rounds 2``), each importing ``cor_asv_ann_tpu_torch`` from its own
root and building its own kernels there. Each process times, with CUDA
events (mean over many launches after a warm-up): ``lstm_step_fused`` at
B = 16 and 256, D = 1024, W = 512 in float32 and bfloat16, with
``torch.lstm_cell`` on the same inputs beside it; ``fused_decode_step``
on gathered windows at the flagship's widths (V = 45, W = A = 512, WIN =
12) at the rows of every beam step (512 to 12,288), bfloat16 and
float32; and, where the checkout has it, ``fused_decode_step_indexed``
on the same rows. Prints the card's name and power limit and one JSON
line per process. Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
from cor_asv_ann_tpu_torch.ops.lstm_step_kernel import lstm_step_fused


def ms(fn, reps):
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
gen = torch.Generator().manual_seed(1)
D, W = 1024, 512
for B in (16, 256):
    x = (torch.rand(B, D, generator=gen) * 2 - 1).to(dev)
    h = (torch.rand(B, W, generator=gen) * 2 - 1).to(dev)
    c = (torch.rand(B, W, generator=gen) * 2 - 1).to(dev)
    K = (torch.randn(D, 4 * W, generator=gen) * 0.05).to(dev)
    R = (torch.randn(W, 4 * W, generator=gen) * 0.05).to(dev)
    b = (torch.randn(4 * W, generator=gen) * 0.5).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in (x, h, c, K, R, b)]
        Kt, Rt = args[3].t().contiguous(), args[4].t().contiguous()
        zero = torch.zeros_like(args[5])
        name = '%s_B%d' % (str(dt).split('.')[-1], B)
        out['K2_' + name + '_ms'] = ms(lambda: lstm_step_fused(*args), 200)
        out['lstm_cell_' + name + '_ms'] = ms(
            lambda: torch.lstm_cell(args[0], (args[1], args[2]), Kt, Rt,
                                    args[5], zero), 200)
V, A, WIN, T = 45, 512, 12, 64
for dt in (torch.bfloat16, torch.float32):
    for N, per_line in ((512, 32), (768, 48), (4096, 32), (8192, 32),
                        (12288, 48)):
        g = torch.Generator().manual_seed(N)

        def mk(shape, scale, dtype=torch.float32):
            return (torch.randn(*shape, generator=g) * scale).to(dtype).to(dev)

        fb = torch.softmax(mk((N, V), 3.0), dim=-1)
        states = [mk((N, W), 0.5) for _ in range(4)]
        lines = N // per_line
        u, att = mk((lines, T, W), 0.5, dt), mk((lines, T, A), 0.5, dt)
        start = torch.randint(0, T - WIN // 2, (N,), generator=g,
                              dtype=torch.int32).to(dev)
        visible = (torch.rand(N, WIN, generator=g) < 0.8).to(dev)
        line = torch.arange(N, device=dev)[:, None] // per_line
        ix = torch.clamp(start.long()[:, None]
                         + torch.arange(WIN, device=dev), max=T - 1)
        u_w, att_w = u[line, ix], att[line, ix]
        shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W), b1=(4 * W,),
                      k2=(W + A, 4 * W), r2=(W, 4 * W), b2=(4 * W,),
                      W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,))
        weights = {k: mk(s, s[0] ** -0.5 if len(s) > 1 else 0.1,
                         torch.float32 if k in dsk._BIASES else dt)
                   for k, s in shapes.items()}
        if hasattr(dsk, 'kernel_layouts'):
            weights.update(dsk.kernel_layouts(weights))
        name = '%s_N%d' % (str(dt).split('.')[-1], N)
        reps = 10 if N > 4096 else 40
        out['K3_' + name + '_ms'] = ms(
            lambda: dsk.fused_decode_step(fb, *states, u_w, att_w, visible,
                                          weights), reps)
        if hasattr(dsk, 'fused_decode_step_indexed'):
            out['K3_indexed_' + name + '_ms'] = ms(
                lambda: dsk.fused_decode_step_indexed(
                    fb, *states, u, att, per_line, start, visible, weights),
                reps)
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
