#!/usr/bin/env python3
"""Where a step of the K4/K5 scan kernels goes, on the GPU.

    python3 tools/scan_ablation.py [--out DIR]

Builds variants of ``csrc/lstm_scan.cu`` with one phase of the step taken
out (textual edits of a copy of the sources under --out, default
build/ablation; the results of a variant are wrong by design, only its
time counts), each with ``nvcc`` into its own shared library, and times
``lstm_scan_fwd_launch``/``lstm_scan_bwd_launch`` of each at T=128 and
T=32, B=256, N=512, bfloat16 and float32 (CUDA events, mean of 5 launches
after a warm-up), and the unchanged kernels under imposed row groups and
unit slices. The difference between two T gives the time per step. Prints
the card's name and power limit and one JSON line per measurement.
Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# variant -> (file, text, replacement) edits
VARIANTS = {
    'as_is': [],
    'no_wait': [('scan_grid.cuh',
                 'while (ld_acquire(counter) < target) {\n    }', ';')],
    'no_stage_a': [('scan_grid.cuh',
                    'stage_rows<T>(buf(c), ld, a_src, lda, M, mvalid, c * KC, '
                    'min(KC, Kp - c * KC), K);', 'cp_async_commit();')],
    'no_mma': [('scan_grid.cuh', 'acc.chunk(buf(c), ld, bres + k0, ldb, kc);',
                ';')],
    'no_gates': [('lstm_scan.cu',
                  'for (int e0 = threadIdx.x; e0 < pl.nr * US; e0 += EPT * NT) {',
                  'for (int e0 = threadIdx.x; e0 < 0; e0 += EPT * NT) {')],
}


def build(out_dir, name, edits, nvcc, flags):
    from cor_asv_ann_tpu_torch.ops import _build
    src = os.path.join(out_dir, name)
    os.makedirs(src, exist_ok=True)
    for f in ('lstm_scan.cu',) + _build.HEADERS:
        shutil.copy(os.path.join(_build.CSRC_DIR, f), src)
    for f, old, new in edits:
        path = os.path.join(src, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise RuntimeError('%s: edit not found in %s' % (name, f))
        with open(path, 'w') as fh:
            fh.write(text.replace(old, new))
    lib = os.path.join(src, 'lib.so')
    return lib, subprocess.Popen(
        [nvcc, *flags, '-shared', os.path.join(src, 'lstm_scan.cu'), '-o',
         lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build', 'ablation'))
    args = ap.parse_args()
    import torch
    from cor_asv_ann_tpu_torch.ops import _build
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    flags = list(_build.NVCC_FLAGS)
    procs = {name: build(args.out, name, edits, _build._nvcc(), flags)
             for name, edits in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('%s failed:\n%s' % (name, log))
        # registers and spills of the kernels
        print(name + ': ' + ' | '.join(
            line.strip() for line in log.splitlines()
            if 'spill' in line or 'Used' in line))
        lib = ctypes.CDLL(path)
        for fn in ('lstm_scan_fwd_launch', 'lstm_scan_bwd_launch'):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn][1]
        libs[name] = lib
    dev = torch.device('cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    B, N = 256, 512
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for T in (128, 32):
            gen = torch.Generator().manual_seed(6)
            zx = torch.randn(T, B, 4 * N, generator=gen).to(dt).to(dev)
            R = (torch.randn(N, 4 * N, generator=gen) / N ** 0.5).to(dt).to(dev)
            h0 = (torch.randn(B, N, generator=gen) * .2).to(dt).to(dev)
            c0 = (torch.randn(B, N, generator=gen) * .2).to(dt).to(dev)
            outs = [torch.empty((T, B, N), dtype=dt, device=dev)
                    for _ in range(2)] + [torch.empty((B, N), dtype=dt,
                                                      device=dev)
                                          for _ in range(2)]
            g = torch.full((T, B, N), 1e-3, dtype=dt, device=dev)
            dzx = torch.empty((T, B, 4 * N), dtype=dt, device=dev)
            d0 = [torch.empty((B, N), device=dev) for _ in range(2)]
            bar = torch.zeros(B // 16, dtype=torch.int32, device=dev)
            # no padding mask (None) between the inputs and the outputs
            fwd_ptrs = [t.data_ptr() for t in (zx, R, h0, c0)] + [None] + \
                [t.data_ptr() for t in outs]
            bwd_ptrs = [t.data_ptr() for t in
                        (g, g[0], g[0], zx, R, outs[0], outs[1], outs[1])] + \
                [None] + [t.data_ptr() for t in (dzx, *d0)]

            def run(lib, kind, br=0, us=0):
                bar.zero_()
                if kind == 'fwd':
                    err = lib.lstm_scan_fwd_launch(
                        code, *fwd_ptrs, bar.data_ptr(), T, B, N, 0, br, us,
                        stream)
                else:
                    err = lib.lstm_scan_bwd_launch(
                        code, *bwd_ptrs, bar.data_ptr(), T, B, N, 0, br, us,
                        stream)
                _build.check(err, 'ablation %s' % kind)

            for kind in ('fwd', 'bwd'):
                for name, lib in libs.items():
                    t = ms(lambda: run(lib, kind))
                    print(json.dumps(dict(dtype=str(dt), T=T, kernel=kind,
                                          variant=name, ms=t)))
                for br, us in ((16, 16), (32, 8), (32, 16), (32, 32),
                               (64, 8), (64, 16), (128, 8)):
                    try:
                        p = lsk.scan_plan(kind, dt, B, N, br, us)
                        t = ms(lambda: run(libs['as_is'], kind, br, us))
                    except RuntimeError as e:
                        t, p = None, str(e)[:80]
                    print(json.dumps(dict(dtype=str(dt), T=T, kernel=kind,
                                          variant='plan br=%d us=%d'
                                          % (br, us), ms=t, plan=p)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
