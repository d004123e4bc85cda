#!/usr/bin/env python3
"""What bounds K6 and K7 (the teacher layer's sweeps), on the GPU.

    python3 tools/teacher_ablation.py [--kernels K6 K7] [--out DIR]

Builds variants of ``csrc/teacher_scan.cu`` (K6) and ``csrc/teacher_bwd.cu``
(K7) by textual edits of a copy of the sources under --out (default
build/teacher_ablation), each with ``nvcc`` into its own shared library:
the kernels as they are; variants that change one parameter (results
right); and variants with one phase taken out (results wrong by design,
only the time counts).

K6: gates tiles of 32 rows instead of 64, three chunk buffers instead of
four, product tiles of 128 rows or 128 columns instead of 64 x 64,
attention blocks of 256 threads instead of 512, the stage kernels launched
to start while the one before drains (``K6_DEPENDENT_LAUNCH``, as K7's);
without the product stage's arithmetic (``mma.sync`` / FMA, step_tile.cuh's
``tile_product``), without the gates stage's arithmetic, without the
energies (tanh and the dot with v), without the gate epilogue's copies of
zx, h.R and the previous c, without its cell.

K7: attention blocks of 256 columns instead of 512, window loads issued in
batches of 16 positions instead of 8, chunks of 256 bytes a row in the
product kernels instead of 128, four chunk buffers instead of three,
product tiles of 128 rows or 128 columns instead of 64 x 64, the stage
kernels launched to start while the one before drains
(``DEPENDENT_LAUNCH``); without the product stage's arithmetic, the
read-modify-write of du and datt, the carry's cell backward.

Times each launcher at B=256, Td=T=128, W=A=512 with dropout masks (the
inputs of ``chip_smoke.py:teacher_times``) with CUDA events (mean of 5
sweeps after a warm-up), in bfloat16 and float32, with the device time of
each stage kernel from ``torch.profiler``
(``chip_smoke.py:kernel_device_ms``).
Prints the card's name and power limit and one JSON line per variant.
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

SOURCES = ('teacher_scan.cu', 'teacher_bwd.cu')
K6, K7 = 'teacher_scan.cu', 'teacher_bwd.cu'
TILE = 'step_tile.cuh'
# programmatic dependent launch (sm_90): every stage kernel after the first
# launched with cudaLaunchKernelEx so that its blocks may be scheduled while
# the kernel before it drains; each kernel waits for that kernel's completion
# (griddepcontrol.wait) before it reads anything, then lets its successor be
# scheduled. Kernels then overlap, so the profiler's per-kernel times include
# their waiting and only the launcher's total counts.
FOLLOW = """__device__ __forceinline__ void follow_predecessor() {
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
}

// what the cell backward of step t at (row, n) reads"""
LAUNCH_AFTER = """template <typename... P, typename... Args>
cudaError_t launch_after(void (*kernel)(P...), int grid, size_t smem, cudaStream_t s,
                         Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T> cudaError_t launch(const Bwd<T>& a, cudaStream_t s) {"""
DEPENDENT_LAUNCH = [
    (K7, '// what the cell backward of step t at (row, n) reads', FOLLOW),
    (K7, 'template <typename T> cudaError_t launch(const Bwd<T>& a, cudaStream_t s) {',
     LAUNCH_AFTER),
    (K7, 'teacher_bwd_prologue<T><<<cell_blocks, NT, 0, s>>>(a);',
     'launch_after(teacher_bwd_prologue<T>, cell_blocks, 0, s, a);'),
    (K7, 'teacher_bwd_product<T><<<product_blocks, NT, psmem, s>>>(a, t);',
     'launch_after(teacher_bwd_product<T>, product_blocks, psmem, s, a, t);'),
    (K7, 'teacher_bwd_attention<T><<<att_blocks, NT, asmem, s>>>(a, t);',
     'launch_after(teacher_bwd_attention<T>, att_blocks, asmem, s, a, t);'),
    (K7, 'teacher_bwd_carry<T><<<carry_blocks, NT, csmem, s>>>(a, t);',
     'launch_after(teacher_bwd_carry<T>, carry_blocks, csmem, s, a, t);'),
] + [(K7, head, head + '  follow_predecessor();\n') for head in (
    'teacher_bwd_wvec(const Bwd<T> a) {\n  extern __shared__ float4 smem4[];\n',
    'teacher_bwd_prologue(const Bwd<T> a) {\n',
    'teacher_bwd_product(const Bwd<T> a, int t) {\n'
    '  extern __shared__ float4 smem4[];\n',
    'teacher_bwd_attention(const Bwd<T> a, int t) {\n'
    '  extern __shared__ float4 smem4[];\n',
    'teacher_bwd_carry(const Bwd<T> a, int t) {\n'
    '  extern __shared__ float4 smem4[];\n')]
# variant -> [(file, text, replacement)]
K7_VARIANTS = {
    'as_is': [],
    'attention_256_columns': [(K7, 'constexpr int ACOL = 512;',
                               'constexpr int ACOL = 256;')],
    'window_batches_of_16': [(K7, 'constexpr int JB = 8;',
                              'constexpr int JB = 16;')],
    'chunks_of_256_bytes': [
        (TILE, 'constexpr int chunk_ld() { return kc<T>() + pad<T>(); }',
         'constexpr int chunk_ld() { return 2 * kc<T>() + pad<T>(); }'),
        (TILE, '''                                             int K) {
  constexpr int KC = kc<T>(), ld = chunk_ld<T>();''',
         '''                                             int K) {
  constexpr int KC = 2 * kc<T>(), ld = chunk_ld<T>();''')],
    'four_buffers': [(K7, 'constexpr int NS = 3;', 'constexpr int NS = 4;')],
    'dependent_launch': DEPENDENT_LAUNCH,
    'product_rows_128': [(K7, 'constexpr int BR = 64;',
                          'constexpr int BR = 128;')],
    'product_columns_128': [(K7, 'constexpr int NCOL = 64;',
                             'constexpr int NCOL = 128;')],
    'no_product_arithmetic': [(
        TILE, 'acc.template chunk<KC>(abuf + (size_t)buf * M * ld, bbuf + '
        '(size_t)buf * NC * ld);', '(void)abuf;')],
    'no_du_datt_rmw': [
        (K7, 'dd[q] = a.du[p];', 'dd[q] = 0.0f;'),
        (K7, 'a.du[p0 + (size_t)(j0 + q) * W] = dd[q] + dpre;',
         'dw += dd[q];'),
        (K7, 'for (int q = 0; q < JB; ++q) x[q] = p0[(size_t)min(j0 + q, cnt - '
         '1) * A];', 'for (int q = 0; q < JB; ++q) x[q] = 0.0f;'),
        (K7, 'if (j0 + q < cnt && ok_s[j0 + q]) p0[(size_t)(j0 + q) * A] = '
         'x[q] + aw_s[j0 + q] * d;',
         'if (j0 + q < cnt && x[q] != 0.0f) p0[0] = d;')],
    'no_cell_backward': [(
        K7, 'a.dc0[(size_t)row * W + n] = cell_bwd<T>(a, t - 1, row, n, x[e], '
        'dh[e], dc[e]);', 'a.dc0[(size_t)row * W + n] = dh[e] + dc[e];')],
}
K6_ANCHOR = "// step t's h.[W_a | R]: a block for each row tile"
K6_LAUNCH = ('template <typename T> cudaError_t launch(const Fwd<T>& a, '
             'cudaStream_t s) {')
K6_DEPENDENT_LAUNCH = [
    (K6, K6_ANCHOR, FOLLOW.replace(
        '// what the cell backward of step t at (row, n) reads', K6_ANCHOR)),
    (K6, K6_LAUNCH, LAUNCH_AFTER.replace(
        'template <typename T> cudaError_t launch(const Bwd<T>& a, '
        'cudaStream_t s) {', K6_LAUNCH).replace(
        'int grid, size_t smem', 'int grid, int threads, size_t smem').replace(
        'cfg.blockDim = dim3(NT);', 'cfg.blockDim = dim3(threads);')),
] + [(K6, 'teacher_fwd_%s<T><<<%s, %s, %s, s>>>(a, t);' % (k, grid, nt, smem),
      'launch_after(teacher_fwd_%s<T>, %s, %s, %s, s, a, t);'
      % (k, grid, nt, smem))
     for k, grid, nt, smem in (('product', 'product_blocks', 'NT', 'psmem'),
                               ('attention', 'a.B', 'NTA', 'asmem'),
                               ('gates', 'gates_blocks', 'NT', 'gsmem'))] + [
    (K6, head, head + '  follow_predecessor();\n') for head in (
        'teacher_fwd_%s(const Fwd<T> a, int t) {\n'
        '  extern __shared__ float4 smem4[];\n' % k
        for k in ('product', 'attention', 'gates'))]
K6_VARIANTS = {
    'as_is': [],
    'gates_rows_32': [(K6, 'constexpr int GR = 64;', 'constexpr int GR = 32;')],
    'three_buffers': [(K6, 'constexpr int NS = 4;', 'constexpr int NS = 3;')],
    'product_rows_128': [(K6, 'constexpr int BR = 64;',
                          'constexpr int BR = 128;')],
    'product_columns_128': [(K6, 'constexpr int NCOL = 64;',
                             'constexpr int NCOL = 128;')],
    'attention_256_threads': [(K6, 'constexpr int NTA = 512;',
                               'constexpr int NTA = 256;')],
    'dependent_launch': K6_DEPENDENT_LAUNCH,
    'no_product_arithmetic': K7_VARIANTS['no_product_arithmetic'],
    'no_gate_arithmetic': [(
        K6, '''acc.template chunk<KC>(abuf + (size_t)(buf * 4 + gate) * GR * ld,
                               bbuf + (size_t)buf * KC * ldb);''',
        '(void)gate;')],
    'no_energies': [(
        K6, 'warp_sum(g < a.W / CG ? lane_energy<T>(wv_row, u_row, a.v, g) : '
        '0.0f);', '(float)(u_row == wv_row);')],
    'no_gate_inputs': [
        (K6, '''    cp_async16(zx_s + at, valid ? a.zx + (size_t)t * B * W4 + col : a.zx, valid);
    cp_async16(zr_s + at, valid ? a.zr + col : a.zr, valid);''', '    (void)at;'),
        (K6, '    cp_async16(cp_s + r * US + j, valid ? c_in + (size_t)(r0 + r) * W + u0 + j '
         ': c_in, valid);', '    (void)valid;')],
    'no_cell': [(
        K6, '''    const float ig = sig<T>(z[0]), fg = sig<T>(z[1]), gg = rnd<T>(tanhf(z[2])), og = sig<T>(z[3]);
    const float cn = rnd<T>(rnd<T>(fg * to_f<T>(cp_s[r * US + j])) + rnd<T>(ig * gg));
    const float hn = rnd<T>(og * rnd<T>(tanhf(cn)));''',
        '    const float cn = z[1] + to_f<T>(cp_s[r * US + j]), hn = z[0];')],
}
VARIANTS = {'K6': K6_VARIANTS, 'K7': K7_VARIANTS}


def build(out_dir, name, edits, nvcc, flags):
    """Start nvcc on edited copies of the sources; (library path,
    process)."""
    from cor_asv_ann_tpu_torch.ops import _build
    src = os.path.join(out_dir, name)
    os.makedirs(src, exist_ok=True)
    for f in SOURCES + _build.HEADERS:
        shutil.copy(os.path.join(_build.CSRC_DIR, f), src)
    for f, old, new in edits:
        path = os.path.join(src, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise RuntimeError('%s: edit not found in %s: %s'
                               % (name, f, old[:60]))
        with open(path, 'w') as fh:
            fh.write(text.replace(old, new))
    lib = os.path.join(src, 'lib.so')
    return lib, subprocess.Popen(
        [nvcc, *flags, '-shared', *(os.path.join(src, f) for f in SOURCES),
         '-o', lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def inputs(torch, dt, B, Td, T, W, A, ww):
    """The launchers' arguments at this shape: (K6 ins, K6 outs, K7 ins,
    K7 outs), outputs and scratch included."""
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(11)

    def mk(shape, scale, dtype=dt):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    zx = mk((Td, B, 4 * W), 1.0, torch.float32)
    u, att = mk((B, T, W), 0.5), mk((B, T, A), 0.5)
    Kc, R = mk((A, 4 * W), A ** -0.5), mk((W, 4 * W), W ** -0.5)
    W_a, v = mk((W, W), W ** -0.5), mk((1, W), 2 * W ** -0.5)
    b_UW, b_v = mk((1, W), 0.1), mk((1, 1), 0.1, torch.float32)
    bias = mk((1, 4 * W), 0.1)
    maskc = ((torch.rand(4, B, A, generator=gen) < 0.8) / 0.8).to(dt).to(dev)
    h0, c0 = mk((B, W), 0.2), mk((B, W), 0.2)
    hs, cs, aa, zs = tk.teacher_fwd(zx, u, att, Kc, R, W_a, v, b_UW, b_v,
                                    bias, maskc, h0, c0, ww)
    fwd_ins = [zx, u, att, Kc, torch.cat([W_a, R], dim=1).t().contiguous(),
               v, b_UW, b_v, bias, maskc, h0, c0]
    fwd_outs = [torch.empty_like(x) for x in (hs, cs, aa, zs)] + [
        torch.empty((B, W), dtype=dt, device=dev),
        torch.empty((B, 4 * W), device=dev),
        torch.empty((4, B, A), dtype=dt, device=dev),
        torch.empty((B,), device=dev)]
    g = torch.full_like(hs, 1e-3)
    bwd_ins = [zs, g, torch.cat([h0[None], hs[:-1]]),
               torch.cat([c0[None], cs[:-1]]), cs, aa, u, att, Kc, R, W_a,
               W_a.t().contiguous(), v, b_UW, maskc]
    bwd_outs = [torch.empty(s, dtype=dt, device=dev) for s in
                ((Td, B, 4 * W), (Td, B, T), (Td, B, A), (Td, B, W))] \
        + [torch.empty((B, W), device=dev) for _ in range(3)] \
        + [torch.zeros((B, T, W), device=dev),
           torch.zeros((B, T, A), device=dev),
           torch.empty((Td, B, W), dtype=dt, device=dev),
           torch.empty((4, B, A + W), device=dev)]
    return fwd_ins, fwd_outs, bwd_ins, bwd_outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--kernels', nargs='+', choices=sorted(VARIANTS),
                    default=sorted(VARIANTS))
    ap.add_argument('--out', default=os.path.join(ROOT, 'build',
                                                  'teacher_ablation'))
    args = ap.parse_args()
    import torch
    from chip_smoke import kernel_device_ms
    from cor_asv_ann_tpu_torch.ops import _build
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    for k in args.kernels:
        for name, edits in VARIANTS[k].items():
            for f, old, _ in edits:
                with open(os.path.join(_build.CSRC_DIR, f)) as fh:
                    if old not in fh.read():
                        raise RuntimeError('%s %s: edit not found in %s: %s'
                                           % (k, name, f, old[:60]))
    procs = {(k, name): build(args.out, '%s_%s' % (k, name), edits,
                              _build._nvcc(), list(_build.NVCC_FLAGS))
             for k in args.kernels for name, edits in VARIANTS[k].items()}
    libs = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('%s: nvcc failed\n%s' % (key, log))
        lib = ctypes.CDLL(path)
        for fn in ('teacher_fwd_launch', 'teacher_bwd_launch'):
            restype, argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[key] = lib
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

    B, Td, T, W, A, ww = 256, 128, 128, 512, 512, 5
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        fi, fo, bi, bo = inputs(torch, dt, B, Td, T, W, A, ww)
        runs[dt] = {k: ((ctypes.c_void_p * len(i))(*(t.data_ptr() for t in i)),
                        (ctypes.c_void_p * len(o))(*(t.data_ptr() for t in o)))
                    for k, i, o in (('K6', fi, fo), ('K7', bi, bo))}
        runs[dt]['tensors'] = (fi, fo, bi, bo)
    code = {torch.float32: 0, torch.bfloat16: 1}
    for (k, name), lib in libs.items():
        row = {'kernel': k, 'variant': name}
        kind = 'fwd' if k == 'K6' else 'bwd'
        launcher = getattr(lib, 'teacher_%s_launch' % kind)
        for dt, ptrs in runs.items():
            ip, op = ptrs[k]

            def run():
                err = launcher(code[dt], ip, op, None, Td, B, T, W, A, ww,
                               stream)
                assert err == 0, err
            key = str(dt).split('.')[-1]
            row[key + '_ms'] = ms(run)
            prefix = 'teacher_%s_' % kind
            row[key + '_stages_ms'] = {
                s[len(prefix):]: v[0] for s, v in
                kernel_device_ms(torch, run, prefix + r'\w+').items()}
        print(json.dumps(row))
    return 0

if __name__ == '__main__':
    sys.exit(main())
