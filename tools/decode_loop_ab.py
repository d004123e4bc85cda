#!/usr/bin/env python3
"""K1 (the whole greedy decode loop) of two checkouts of the port, in
turns on one GPU, and what bounds K1, by variants of its source.

    python3 tools/decode_loop_ab.py ROOT_A ROOT_B [--rounds 2]
    python3 tools/decode_loop_ab.py --ablation ROOT [--out DIR]

In turns: a fresh process for each checkout in the order A, B, B, A
(``--rounds 2``), each importing ``cor_asv_ann_tpu_torch`` from its own
root and building its own kernels there. Each process serves the bundled
flagship (``testmodels/flagship.d2.w512.synthetic.h5``) in bfloat16 and
times ``decode_loop`` (K1) on the encoded golden-corpus lines at T = 64,
B = 16 and B = 1, with CUDA events (mean of 10 calls after a warm-up),
beside the longest line's step count and the microseconds a step; then
``correct_lines`` on the 16 lines (lines/s, the best of 3 timed rounds of
2 batches after a warm-up; K1 is half the device's busy time there, the
encoder's per-step launches most of the rest).

``--ablation``: builds variants of ROOT's ``csrc/decode_loop.cu`` by
textual edits of a copy under --out (default ROOT/build/k1_ablation),
each with ``nvcc`` into its own shared library, and times each at B = 16,
T = 64 with a newline index that no line picks, so that every variant
runs all 2T = 128 steps: the kernel as it is; the blocks' waits at the
counters taken out (only the arrivals stay); without the line blocks'
attention; without their readout; without the unit blocks' products
(their loads and mma); without the launch's gather of the weights into
shared memory; and the kernel as it is with 4 and 5 units a unit
block imposed. Without a phase the results are wrong by design; only the
time counts.

Prints the card's name and power limit and one JSON line per process or
variant. Imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

COMMON = r'''
import ctypes, json, sys, time
import torch
sys.path.insert(0, ROOT)
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.models.seq2seq import encode, ensure_onehot
from cor_asv_ann_tpu_torch.ops import _build
from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
from cor_asv_ann_tpu_torch.utils.data import lines_to_index_batch

FLAGSHIP = ROOT + '/testmodels/flagship.d2.w512.synthetic.h5'


def ms(fn, reps=10):
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


def load():
    s2s = Sequence2Sequence(device='cuda')
    s2s.load_config(FLAGSHIP)
    s2s.configure()
    s2s.load_weights(FLAGSHIP)
    s2s.compute = 'bfloat16'
    return s2s


def k1_args(s2s, lines, newline=None):
    """decode_loop's arguments for `lines` (T = 64), as chip_smoke.py's
    phase_k1 builds them."""
    params, config = s2s._infer_params(), s2s.config
    enc = torch.from_numpy(lines_to_index_batch(
        s2s.mapping, lines, pad_to=64)).to('cuda')
    enc = ensure_onehot(enc, config, params)
    attended, states, u = encode(params, config, enc)
    B = len(lines)
    live = enc.reshape(B, -1).ne(0).any(dim=1).to(torch.int32)
    mask = enc.ne(0).any(dim=2).to(torch.int32)
    nl = s2s.mapping.get('\n') if newline is None else newline
    return (attended, u, states, live, mask, dlk.decoder_weights(params),
            nl, 128, config.window_width)


with open(ROOT + '/tests/golden_corpus.json') as f:
    CORPUS = json.load(f)['inputs']['plain']
'''

CHILD = COMMON + r'''
out = {'root': ROOT}
s2s = load()
for B in (16, 1):
    args = k1_args(s2s, CORPUS[:B])
    idx, prob, length, score = dlk.decode_loop(*args)
    steps = int(length.max())
    t = ms(lambda: dlk.decode_loop(*args))
    out['K1_B%d_ms' % B] = t
    out['K1_B%d_longest_steps' % B] = steps
    out['K1_B%d_us_per_step' % B] = 1e3 * t / steps
    if hasattr(dlk, 'decode_loop_plan'):
        out['K1_B%d_plan' % B] = dlk.decode_loop_plan(
            512, 512, args[5]['E'].shape[0], args[8], lines=B)
lines = list(CORPUS[:16])
run = lambda: s2s.correct_lines(lines, return_alignments=False)
run()
best = 0.0
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    run()
    torch.cuda.synchronize()
    best = max(best, 2 * len(lines) / (time.perf_counter() - t0))
out['correct_lines_bf16_B16_lines_per_s'] = best
print(json.dumps(out))
'''

ABLATION = COMMON + r'''
out_dir = OUT
s2s = load()
args = k1_args(s2s, CORPUS[:16], newline=-1)    # no line stops: 128 steps
main = _build.library()


def variant_lib(path):
    lib = ctypes.CDLL(path)
    for name in ('decode_loop_plan', 'decode_loop_launch'):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = _build.SIGNATURES[name]
    lib.cor_kernels_error_string = main.cor_kernels_error_string
    return lib


stream = _build.stream_of(args[1])


def timeline(lib):
    """Mean microseconds of each phase and meeting over steps 1 .. S-2 of
    one launch, from the timeline variant's stamps: a phase from its
    start to its end in a block (mean over the blocks); a meeting from
    the last arrival to a block's departure (mean over the blocks that
    wait there)."""
    import numpy as np
    run()
    torch.cuda.synchronize()
    n = TL_BLOCKS * (TL_STEPS + 1) * 8
    buf = (ctypes.c_ulonglong * n)()
    lib.k1_timeline.restype = ctypes.c_int
    assert lib.k1_timeline(buf, n) == 0
    t = np.frombuffer(buf, dtype=np.uint64).reshape(TL_BLOCKS, TL_STEPS + 1,
                                                    8)
    t = t.astype(np.float64) / 1e3
    plan = dlk.decode_loop_plan(512, 512, args[5]['E'].shape[0], args[8],
                                lines=16)
    U, LB = plan['unit_blocks'], plan['line_blocks']
    S = args[7]
    unit, att, ro = t[:U, 1:S - 1], t[U:U + LB, 1:S - 1], t[U + LB:U + 2 * LB, 1:S - 1]
    mean = lambda x: float(np.mean(x))
    last = lambda x, k: x[..., k].max(axis=0)
    return {
        'tl_weights_us': mean(t[:U, TL_STEPS, 1] - t[:U, TL_STEPS, 0]),
        'tl_first_step_us': mean(t[:U, 0, 0] - t[:U, TL_STEPS, 0]),
        'tl_step_us': mean(np.diff(t[:U, 1:S - 1, 0], axis=1)),
        'tl_unit_a_us': mean(unit[..., 1] - unit[..., 0]),
        'tl_unit_b_us': mean(unit[..., 3] - unit[..., 2]),
        'tl_unit_c_wvec_us': mean(unit[..., 5] - unit[..., 4]),
        'tl_unit_c_h2r2_us': mean(unit[..., 6] - unit[..., 5]),
        'tl_attention_us': mean(att[..., 1] - att[..., 0]),
        'tl_readout_us': mean(ro[..., 5] - ro[..., 4]),
        'tl_meet1_us': mean(unit[..., 2] - np.maximum(last(unit, 1),
                                                      last(att, 1))),
        'tl_meet2_us': mean(np.concatenate([unit[..., 4], ro[..., 4]])
                            - last(unit, 3)),
        'tl_meet3_unit_us': mean(t[U:U + LB, 2:S, 0] - last(unit, 5)),
        'tl_meet3_readout_us': mean(t[:U, 2:S, 0] - last(ro, 5)),
        'tl_last_at_meet1': 'attention' if mean(last(att, 1)
                                                - last(unit, 1)) > 0
                            else 'unit'}
for name, path, us in VARIANTS:
    lib = variant_lib(path) if path else main
    run = lambda: dlk.run_kernel(lib, *args, units_per_block=us,
                                 stream=stream)
    t = ms(run)
    steps = args[7]
    res = {'variant': name, 'units_per_block': us, 'ms': t, 'steps': steps,
           'us_per_step': 1e3 * t / steps}
    if name == 'timeline':
        res.update(timeline(lib))
    print(json.dumps(res))
'''

# the timeline variant: thread 0 of each block writes the global timer (ns)
# at points of each step: 0 at the start of (a) (unit blocks: after the
# readouts' meeting of the step before, attention blocks: after the unit
# blocks' (c) of the step before); 1 at the end of (a) (LSTM 1, the
# attention); 2 after meeting 1 (unit blocks); 3 at the end of (b); 4 after
# meeting 2 (unit and readout blocks); 5 at the end of (c) (the unit
# blocks' wvec, the readout); 6 after the unit blocks' h2.r2; and, in a row
# after the steps', 0 at a unit block's start and 1 once its weights are
# in shared memory
TL_BLOCKS, TL_STEPS = 160, 128
TIMELINE = r"""__device__ unsigned long long k1_tl[%d * %d * 8];
__device__ __forceinline__ unsigned long long k1_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(n) \
  if (threadIdx.x == 0 && s < %d && blockIdx.x < %d) \
    k1_tl[((size_t)blockIdx.x * %d + s) * 8 + (n)] = k1_now();
#define STAMP0(n) \
  if (threadIdx.x == 0 && blockIdx.x < %d) \
    k1_tl[((size_t)blockIdx.x * %d + %d) * 8 + (n)] = k1_now();
""" % (TL_BLOCKS, TL_STEPS + 1, TL_STEPS, TL_BLOCKS, TL_STEPS + 1,
       TL_BLOCKS, TL_STEPS + 1, TL_STEPS)
TIMELINE_END = """
extern "C" int k1_timeline(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k1_tl, (size_t)n * 8);
}
"""

# variant -> [(old, new), ...] edits of csrc/decode_loop.cu
EDITS = {
    'no_meetings': [
        ('group_wait(', 'skip_wait('),
        ('namespace {\n', 'namespace {\n\n__device__ __forceinline__ void '
         'skip_wait(const int*, int) { __syncthreads(); }\n')],
    'no_attention': [('FOR_LINES(l, i) attention(a, m, l, i);', '')],
    'no_readout': [('FOR_LINES(l, i) readout(a, m, l, i, s);', '')],
    'no_products': [
        ('          ldmatrix_x4<true>(b, brow_k + 8 * t);\n', ''),
        ('          mma_bf16_16816(acc[o][t], a0, b0);\n', ''),
        ('          mma_bf16_16816(acc[o][t], a1, b1);\n', '')],
    'no_weight_load': [
        ('  constexpr int U = 16;  // loads in flight a thread\n',
         '  return;\n  constexpr int U = 16;  // loads in flight a thread\n')],
    'timeline': [
        ('namespace {\n', 'namespace {\n\n' + TIMELINE),
        ('    if (!__syncthreads_or(running(a, s))) break;\n    bf16* h1n',
         '    if (!__syncthreads_or(running(a, s))) break;\n    STAMP(0)\n'
         '    bf16* h1n'),
        ('    group_arrive(a.bar + 0);\n    group_wait(a.bar + 0, (s + 1) * '
         '(p.units + p.LB));\n',
         '    STAMP(1)\n    group_arrive(a.bar + 0);\n    group_wait('
         'a.bar + 0, (s + 1) * (p.units + p.LB));\n    STAMP(2)\n'),
        ('    group_arrive(a.bar + 1);\n'
         '    group_wait(a.bar + 1, (s + 1) * p.units);\n'
         '    wvec_product(a.h2x);  // (c)\n',
         '    STAMP(3)\n    group_arrive(a.bar + 1);\n'
         '    group_wait(a.bar + 1, (s + 1) * p.units);\n    STAMP(4)\n'
         '    wvec_product(a.h2x);  // (c)\n    STAMP(5)\n'),
        ('    zh2_product(a.h2x);\n  }\n', '    zh2_product(a.h2x);\n'
         '    STAMP(6)\n  }\n'),
        ('// wvec of step s\n', '// wvec of step s\n    STAMP(0)\n'),
        ('FOR_LINES(l, i) attention(a, m, l, i);     // (a)\n',
         'FOR_LINES(l, i) attention(a, m, l, i);     // (a)\n    STAMP(1)\n'),
        ('// h2n of step s\n', '// h2n of step s\n    STAMP(4)\n'),
        ('FOR_LINES(l, i) readout(a, m, l, i, s);     // (c)\n',
         'FOR_LINES(l, i) readout(a, m, l, i, s);     // (c)\n    STAMP(5)\n'),
        ('nu = min(US, W - u0), nt = NC / 8;\n',
         'nu = min(US, W - u0), nt = NC / 8;\n  STAMP0(0)\n'),
        ('  __syncthreads();\n\n  // (c), first',
         '  __syncthreads();\n  STAMP0(1)\n\n  // (c), first')],
}


def build_variants(root, out):
    """One shared library per edited copy of decode_loop.cu, nvcc
    processes all started together; {name: path}."""
    sys.path.insert(0, root)
    from cor_asv_ann_tpu_torch.ops import _build
    src = os.path.join(_build.CSRC_DIR, 'decode_loop.cu')
    with open(src) as f:
        text = f.read()
    procs, paths = [], {}
    for name, edits in EDITS.items():
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        edited = text
        for old, new in edits:
            if old not in edited:
                raise RuntimeError('%s: %r not in decode_loop.cu'
                                   % (name, old))
            edited = edited.replace(old, new)
        if name == 'timeline':
            edited += TIMELINE_END
        with open(os.path.join(d, 'decode_loop.cu'), 'w') as f:
            f.write(edited)
        paths[name] = os.path.join(d, 'libk1_%s.so' % name)
        procs.append((name, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
             os.path.join(d, 'decode_loop.cu'), '-o', paths[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, log))
    return paths


def smi():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('roots', nargs='*', help='two checkouts of the repo')
    ap.add_argument('--rounds', type=int, default=2,
                    help='A,B then B,A per two rounds')
    ap.add_argument('--ablation', metavar='ROOT',
                    help='time variants of ROOT\'s K1 instead')
    ap.add_argument('--out', help='where the variants are built')
    args = ap.parse_args()
    print(smi())
    if args.ablation:
        root = os.path.abspath(args.ablation)
        out = os.path.abspath(args.out or os.path.join(root, 'build',
                                                       'k1_ablation'))
        paths = build_variants(root, out)
        variants = [('as_is', None, 0)] \
            + [(n, paths[n], 0) for n in EDITS] \
            + [('as_is', None, us) for us in (4, 5)]
        code = 'ROOT = %r\nOUT = %r\nVARIANTS = %r\n' % (root, out,
                                                          variants) \
            + 'TL_BLOCKS, TL_STEPS = %d, %d\n' % (TL_BLOCKS, TL_STEPS) \
            + ABLATION
        proc = subprocess.run([sys.executable, '-c', code], cwd=root)
        return proc.returncode
    if len(args.roots) != 2:
        ap.error('two checkouts, or --ablation ROOT')
    order = []
    for r in range(args.rounds):
        order += list(args.roots) if r % 2 == 0 else list(args.roots)[::-1]
    for root in order:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, '-c',
                               'ROOT = %r\n' % root + CHILD], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == '__main__':
    sys.exit(main())
