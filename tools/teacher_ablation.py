#!/usr/bin/env python3
"""What bounds K7 (the teacher layer's reverse sweep), on the GPU.

    python3 tools/teacher_ablation.py [--out DIR]

Builds variants of ``csrc/teacher_bwd.cu`` by textual edits of a copy of
the sources under --out (default build/teacher_ablation), each with
``nvcc`` into its own shared library: the kernel as it is; variants that
change one parameter (results right): attention blocks of 256 columns
instead of 512, window loads issued in batches of 16 positions instead of
8, chunks of 256 bytes a row in the product kernels instead of 128, four
chunk buffers instead of three, product tiles of 128 rows or 128 columns
instead of 64 x 64, the stage kernels launched to start while the one
before drains (``DEPENDENT_LAUNCH``); and variants with one phase taken out
(results wrong by design, only the time counts): the product stage's
arithmetic (``mma.sync`` / FMA), the read-modify-write of du and datt, the
carry's cell backward. Times each launcher at B=256, Td=T=128, W=A=512
with dropout masks (the inputs of ``chip_smoke.py:teacher_times``) with
CUDA events (mean of 5 sweeps after a warm-up), in bfloat16 and float32,
with the device time of each stage kernel from ``torch.profiler``
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

SRC = 'teacher_bwd.cu'
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
    ('// what the cell backward of step t at (row, n) reads', FOLLOW),
    ('template <typename T> cudaError_t launch(const Bwd<T>& a, cudaStream_t s) {',
     LAUNCH_AFTER),
    ('teacher_bwd_prologue<T><<<cell_blocks, NT, 0, s>>>(a);',
     'launch_after(teacher_bwd_prologue<T>, cell_blocks, 0, s, a);'),
    ('teacher_bwd_product<T><<<product_blocks, NT, psmem, s>>>(a, t);',
     'launch_after(teacher_bwd_product<T>, product_blocks, psmem, s, a, t);'),
    ('teacher_bwd_attention<T><<<att_blocks, NT, asmem, s>>>(a, t);',
     'launch_after(teacher_bwd_attention<T>, att_blocks, asmem, s, a, t);'),
    ('teacher_bwd_carry<T><<<carry_blocks, NT, csmem, s>>>(a, t);',
     'launch_after(teacher_bwd_carry<T>, carry_blocks, csmem, s, a, t);'),
] + [(head, head + '  follow_predecessor();\n') for head in (
    'teacher_bwd_wvec(const Bwd<T> a) {\n  extern __shared__ float4 smem4[];\n',
    'teacher_bwd_prologue(const Bwd<T> a) {\n',
    'teacher_bwd_product(const Bwd<T> a, int t) {\n'
    '  extern __shared__ float4 smem4[];\n',
    'teacher_bwd_attention(const Bwd<T> a, int t) {\n'
    '  extern __shared__ float4 smem4[];\n',
    'teacher_bwd_carry(const Bwd<T> a, int t) {\n'
    '  extern __shared__ float4 smem4[];\n')]
# variant -> [(text, replacement)] in teacher_bwd.cu
VARIANTS = {
    'as_is': [],
    'attention_256_columns': [('constexpr int ACOL = 512;',
                               'constexpr int ACOL = 256;')],
    'window_batches_of_16': [('constexpr int JB = 8;',
                              'constexpr int JB = 16;')],
    'chunks_of_256_bytes': [
        ('constexpr int chunk_ld() { return kc<T>() + pad<T>(); }',
         'constexpr int chunk_ld() { return 2 * kc<T>() + pad<T>(); }'),
        ('''                                             int K) {
  constexpr int KC = kc<T>(), ld = chunk_ld<T>();''',
         '''                                             int K) {
  constexpr int KC = 2 * kc<T>(), ld = chunk_ld<T>();''')],
    'four_buffers': [('constexpr int NS = 3;', 'constexpr int NS = 4;')],
    'dependent_launch': DEPENDENT_LAUNCH,
    'product_rows_128': [('constexpr int BR = 64;', 'constexpr int BR = 128;')],
    'product_columns_128': [('constexpr int NCOL = 64;',
                             'constexpr int NCOL = 128;')],
    'no_product_arithmetic': [(
        'acc.template chunk<KC>(abuf + (size_t)buf * BR * ld, bbuf + '
        '(size_t)buf * NCOL * ld);', '(void)abuf;')],
    'no_du_datt_rmw': [
        ('dd[q] = a.du[p];', 'dd[q] = 0.0f;'),
        ('a.du[p0 + (size_t)(j0 + q) * W] = dd[q] + dpre;', 'dw += dd[q];'),
        ('for (int q = 0; q < JB; ++q) x[q] = p0[(size_t)min(j0 + q, cnt - 1) * A];',
         'for (int q = 0; q < JB; ++q) x[q] = 0.0f;'),
        ('if (j0 + q < cnt) p0[(size_t)(j0 + q) * A] = x[q] + aw_s[j0 + q] * d;',
         'if (j0 + q < cnt && x[q] != 0.0f) p0[0] = d;')],
    'no_cell_backward': [(
        'a.dc0[(size_t)row * W + n] = cell_bwd<T>(a, t - 1, row, n, x[e], '
        'dh[e], dc[e]);', 'a.dc0[(size_t)row * W + n] = dh[e] + dc[e];')],
}


def build(out_dir, name, edits, nvcc, flags):
    """Start nvcc on an edited copy of the source; (library path, process)."""
    from cor_asv_ann_tpu_torch.ops import _build
    src = os.path.join(out_dir, name)
    os.makedirs(src, exist_ok=True)
    for f in (SRC,) + _build.HEADERS:
        shutil.copy(os.path.join(_build.CSRC_DIR, f), src)
    path = os.path.join(src, SRC)
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError('%s: edit not found: %s' % (name, old[:60]))
        text = text.replace(old, new)
    with open(path, 'w') as fh:
        fh.write(text)
    lib = os.path.join(src, 'lib.so')
    return lib, subprocess.Popen(
        [nvcc, *flags, '-shared', path, '-o', lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'build',
                                                  'teacher_ablation'))
    args = ap.parse_args()
    import torch
    from chip_smoke import kernel_device_ms
    from cor_asv_ann_tpu_torch.ops import _build
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    procs = {name: build(args.out, name, edits, _build._nvcc(),
                         list(_build.NVCC_FLAGS))
             for name, edits in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('%s: nvcc failed\n%s' % (name, log))
        lib = ctypes.CDLL(path)
        restype, argtypes = _build.SIGNATURES['teacher_bwd_launch']
        lib.teacher_bwd_launch.restype = restype
        lib.teacher_bwd_launch.argtypes = argtypes
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

    def stage_ms(fn):
        split = kernel_device_ms(torch, fn, r'teacher_bwd_\w+')
        return {k[len('teacher_bwd_'):]: v[0] for k, v in split.items()}

    B, Td, T, W, A, ww = 256, 128, 128, 512, 512, 5
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(11)

        def mk(shape, scale, dtype=dt):
            return (torch.randn(*shape, generator=gen) * scale).to(dtype) \
                .to(dev)

        zx = mk((Td, B, 4 * W), 1.0, torch.float32)
        u, att = mk((B, T, W), 0.5), mk((B, T, A), 0.5)
        Kc, R = mk((A, 4 * W), A ** -0.5), mk((W, 4 * W), W ** -0.5)
        W_a, v = mk((W, W), W ** -0.5), mk((1, W), 2 * W ** -0.5)
        b_UW, b_v = mk((1, W), 0.1), mk((1, 1), 0.1, torch.float32)
        bias = mk((1, 4 * W), 0.1)
        maskc = ((torch.rand(4, B, A, generator=gen) < 0.8) / 0.8).to(dt) \
            .to(dev)
        h0, c0 = mk((B, W), 0.2), mk((B, W), 0.2)
        hs, cs, aa, zs = tk.teacher_fwd(zx, u, att, Kc, R, W_a, v, b_UW, b_v,
                                        bias, maskc, h0, c0, ww)
        g = torch.full_like(hs, 1e-3)
        ins = [zs, g, torch.cat([h0[None], hs[:-1]]),
               torch.cat([c0[None], cs[:-1]]), cs, aa, u, att, Kc, R, W_a,
               W_a.t().contiguous(), v, b_UW, maskc]
        outs = [torch.empty(s, dtype=dt, device=dev) for s in
                ((Td, B, 4 * W), (Td, B, T), (Td, B, A), (Td, B, W))] \
            + [torch.empty((B, W), device=dev) for _ in range(3)] \
            + [torch.zeros((B, T, W), device=dev),
               torch.zeros((B, T, A), device=dev),
               torch.empty((Td, B, W), dtype=dt, device=dev),
               torch.empty((4, B, A + W), device=dev)]
        runs[dt] = ((ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins)),
                    (ctypes.c_void_p * len(outs))(
                        *(t.data_ptr() for t in outs)), ins, outs)
    code = {torch.float32: 0, torch.bfloat16: 1}
    for name, lib in libs.items():
        row = {'variant': name}
        for dt, (ip, op, _, _) in runs.items():
            def run():
                err = lib.teacher_bwd_launch(code[dt], ip, op, Td, B, T, W,
                                             A, ww, stream)
                assert err == 0, err
            key = str(dt).split('.')[-1]
            row[key + '_ms'] = ms(run)
            row[key + '_stages_ms'] = stage_ms(run)
        print(json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
