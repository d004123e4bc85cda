#!/usr/bin/env python3
"""What bounds K2 (the LSTM step) and K3 (the fused decode step), on the GPU.

    python3 tools/step_ablation.py [--out DIR]

Builds variants of ``csrc/lstm_step.cu`` and ``csrc/decode_step.cu`` by
textual edits of a copy of the sources under --out (default
build/step_ablation), each with ``nvcc`` into its own shared library: the
kernels as they are; K2 with the bf16 B fragments of its large tiles
assembled from 16-bit shared loads instead of ``ldmatrix.x4.trans`` (a
result that is right too); and, with one phase taken out (results wrong
by design, only the time counts), the products' arithmetic (``mma.sync``
/ FMA), the operands' copies into shared memory, K3's attention kernel
and its gate epilogues.
Other variants change one parameter: K2 with two chunk buffers instead of
three, or chunks of 128 or 256 bytes a row instead of 512. Times each launcher
with CUDA events (mean of 20 launches after a warm-up): K2 at B = 16 and
256, D = 1024, W = 512 with the launcher's tile, and at B = 256 with each
tile of 32 or 64 rows x 16 or 32 units imposed, ``torch.lstm_cell`` on
the same inputs beside it; K3 on gathered windows
at N = 512 and 8,192 (V = 45, W = A = 512, WIN = 12); bfloat16 and
float32. Prints the card's name and power limit and one JSON line per
variant. Imports nothing of JAX.
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

# the B fragments of two n8 tiles of a [k][c] chunk from 16-bit shared
# loads (lane l: k = 2*(l%4) (+1, +8, +9), column l/4 of the tile), in
# place of ldmatrix.x4.trans in WarpTile::chunk (K2 builds it with BT only)
LDS16_B_FRAGMENTS = '''{
          const int g_ = (threadIdx.x % 32) / 4, q_ = threadIdx.x % 4;
          const uint16_t* p_ = reinterpret_cast<const uint16_t*>(
              b + (size_t)ks * ldb + ((int)threadIdx.x / 32 / WM) * TN + j * 16)
              + (size_t)(2 * q_) * ldb + g_;
          r[0] = p_[0] | (uint32_t)p_[ldb] << 16;
          r[1] = p_[8 * ldb] | (uint32_t)p_[9 * ldb] << 16;
          r[2] = p_[8] | (uint32_t)p_[ldb + 8] << 16;
          r[3] = p_[8 * ldb + 8] | (uint32_t)p_[9 * ldb + 8] << 16;
        }'''
NO_COPIES = [('step_tile.cuh', 'if (c < chunks) issue(c, c);', ';'), (
    'step_tile.cuh',
    'if (c + NS - 1 < chunks) issue(c + NS - 1, (c + NS - 1) % NS);', ';')]
# variant -> (source, [(file, text, replacement)], extra nvcc flags)
VARIANTS = {
    'K2_as_is': ('lstm_step.cu', [], []),
    'K2_lds16_b_fragments': ('lstm_step.cu', [(
        'step_tile.cuh', 'ldmatrix_x4<BT>(r, b + bo[j] + (BT ? ks * ldb : ks));',
        LDS16_B_FRAGMENTS)], []),
    'K2_no_products': ('lstm_step.cu', [(
        'lstm_step.cu', '''      if (c < cx)
        chunk_of<KC>(ax, ab, bb);
      else
        chunk_of<KC>(ah, ab, bb);''', '(void)ab, (void)bb;')], []),
    'K2_no_copies': ('lstm_step.cu', NO_COPIES, []),
    'K2_two_buffers': ('lstm_step.cu', [(
        'lstm_step.cu', 'constexpr int NS = 3;', 'constexpr int NS = 2;')],
        []),
    'K2_chunks_of_128_bytes': ('lstm_step.cu', [(
        'lstm_step.cu', 'return 512 / (int)sizeof(T);',
        'return 128 / (int)sizeof(T);')], []),
    'K2_chunks_of_256_bytes': ('lstm_step.cu', [(
        'lstm_step.cu', 'return 512 / (int)sizeof(T);',
        'return 256 / (int)sizeof(T);')], []),
    'K3_as_is': ('decode_step.cu', [], []),
    'K3_no_products': ('decode_step.cu', [(
        'decode_step.cu',
        'acc.template chunk<KC>(abuf + (size_t)buf * BR * ld, bbuf + '
        '(size_t)buf * NCOL * ld);', ';')], []),
    'K3_no_copies': ('decode_step.cu', NO_COPIES, []),
    'K3_no_attention': ('decode_step.cu', [(
        'decode_step.cu', '  if (n >= d.N) return;\n', '  return;\n')], []),
    'K3_no_gates': ('decode_step.cu', [(
        'decode_step.cu', 'for (int i = threadIdx.x; i < nr * US; i += NT) {',
        'for (int i = threadIdx.x; i < 0; i += NT) {')], []),
}


def build(out_dir, name, source, edits, nvcc, flags):
    """Start nvcc on an edited copy of `source`; (library path, process)."""
    from cor_asv_ann_tpu_torch.ops import _build
    src = os.path.join(out_dir, name)
    os.makedirs(src, exist_ok=True)
    for f in (source,) + _build.HEADERS:
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
        [nvcc, *flags, '-shared', os.path.join(src, source), '-o', lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build',
                                                  'step_ablation'))
    args = ap.parse_args()
    import torch
    from cor_asv_ann_tpu_torch.ops import _build
    from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    procs = {name: build(args.out, name, src, edits, _build._nvcc(),
                         list(_build.NVCC_FLAGS) + extra)
             for name, (src, edits, extra) in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('%s: nvcc failed\n%s' % (name, log))
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    dev = torch.device('cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, reps=20):
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

    gen = torch.Generator().manual_seed(3)
    D, W = 1024, 512
    k2_inputs = {}
    for B in (16, 256):
        for dt in (torch.float32, torch.bfloat16):
            t = [torch.randn(*s, generator=gen) * sc for s, sc in (
                ((B, D), 1.0), ((B, W), 1.0), ((B, W), 1.0),
                ((D, 4 * W), .05), ((W, 4 * W), .05), ((4 * W,), .5))]
            t = [x.to(dt).to(dev) for x in t]
            k2_inputs[(dt, B)] = t + [torch.empty((B, W), dtype=dt,
                                                  device=dev)
                                      for _ in range(2)]
    V, A, WIN = 45, 512, 12
    k3_inputs = {}
    for N in (512, 8192):
        for dt in (torch.float32, torch.bfloat16):
            def mk(shape, scale, dtype=torch.float32):
                return (torch.randn(*shape, generator=gen) * scale).to(
                    dtype).to(dev)
            shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W),
                          b1=(4 * W,), k2=(W + A, 4 * W), r2=(W, 4 * W),
                          b2=(4 * W,), W_a=(W, W), v_a=(W, 1), b_UW=(W,),
                          b_v=(1,))
            weights = {k: mk(s, s[0] ** -0.5 if len(s) > 1 else .1,
                             torch.float32 if k in dsk._BIASES else dt)
                       for k, s in shapes.items()}
            weights.update(dsk.kernel_layouts(weights))
            ins = [torch.softmax(mk((N, V), 3.0), -1)] \
                + [mk((N, W), .5) for _ in range(4)] \
                + [mk((N, WIN, W), .5, dt), mk((N, WIN, A), .5, dt),
                   (torch.rand(N, WIN, generator=gen) < .8).to(torch.uint8)
                   .to(dev), torch.zeros(1, dtype=torch.int32, device=dev)] \
                + [weights[k] for k in dsk._KERNEL_ORDER]
            Vp = -(-V // 16) * 16
            outs = [torch.empty(s, device=dev) for s in
                    ((N, V), (N, W), (N, W), (N, W), (N, W), (N, WIN))] \
                + [torch.empty((N, Vp + 5 * W + A), dtype=dt, device=dev),
                   torch.empty((N, W), device=dev)]
            k3_inputs[(dt, N)] = (
                (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins)),
                (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs)),
                ins, outs)
    code = {torch.float32: 0, torch.bfloat16: 1}
    for (dt, B), t in k2_inputs.items():
        x, h, c, K, R, b = t[:6]
        Kt, Rt, zero = K.t().contiguous(), R.t().contiguous(), \
            torch.zeros_like(b)
        print(json.dumps({'torch.lstm_cell_%s_B%d_ms' % (
            str(dt).split('.')[-1], B): ms(
                lambda: torch.lstm_cell(x, (h, c), Kt, Rt, b, zero))}))
    for name, lib in libs.items():
        row = {'variant': name}
        if name.startswith('K2'):
            for (dt, B), t in k2_inputs.items():
                def run():
                    err = lib.lstm_step_launch(
                        code[dt], *(x.data_ptr() for x in t), B, D, W, 0, 0,
                        stream)
                    assert err == 0, err
                row['%s_B%d_ms' % (str(dt).split('.')[-1], B)] = ms(run)
                if B != 256:
                    continue
                for br, us in ((64, 16), (64, 32), (32, 16), (32, 32)):
                    def run_tile():
                        return lib.lstm_step_launch(
                            code[dt], *(x.data_ptr() for x in t), B, D, W,
                            br, us, stream)
                    # a tile the variant's shared memory refuses: None
                    row['%s_B%d_tile%dx%d_ms' % (
                        str(dt).split('.')[-1], B, br, us)] = (
                            ms(run_tile) if run_tile() == 0 else None)
        else:
            for (dt, N), (ip, op, _, _) in k3_inputs.items():
                def run():
                    err = lib.decode_step_launch(
                        code[dt], code[dt], ip, op, N, V, W, A, WIN, 0, 0,
                        0, stream)
                    assert err == 0, err
                row['%s_N%d_ms' % (str(dt).split('.')[-1], N)] = ms(
                    run, 20 if N < 4096 else 5)
        print(json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
