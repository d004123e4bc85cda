"""PyTorch port: the CUDA sources of the decode loop, the LSTM step, the
scan kernels and the fused decode step, run on the CPU.

There is no GPU and no ``nvcc`` where these tests run, but the kernels
K1-K7 (``csrc/decode_loop.cu``, ``csrc/lstm_step.cu``,
``csrc/decode_step.cu``, ``csrc/lstm_scan.cu``, ``csrc/teacher_scan.cu``,
``csrc/teacher_bwd.cu`` over ``csrc/scan_common.cuh``,
``csrc/scan_grid.cuh``, ``csrc/step_tile.cuh``) use few CUDA constructs:
blocks of threads, a block barrier, warp shuffles, dynamic shared memory,
bf16 conversions, ``mma.sync``, ``ldmatrix``, ``cp.async``, counters in
global memory that the blocks of a cooperative grid meet at.
``tests/cuda_emulation/`` holds stand-ins for ``cuda_runtime.h`` and
``cuda_bf16.h`` that give a host compiler exactly those (one OS thread
per CUDA thread, blocks one after another). With the launch syntax
rewritten, ``g++ -std=c++20`` builds the very sources the GPU build
compiles, and the exported launchers run on CPU tensors against the
kernels' plain versions: indexing, shared-memory layout, barriers,
window logic and rounding points are checked here; what ``nvcc`` makes of
the sources, and their speed, only on a card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: float32 2e-5 (summation order, libm against PyTorch's
exp/tanh); bfloat16 3e-2 (an ulp of a gate carried along the sweep;
gradients relative to their scale); K1's greedy picks equal up to a near
tie, its probabilities within 2e-2 up to there. Skipped where no C++20 ``g++`` is
installed.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cor_asv_ann_tpu_torch.ops import _build
from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
from padding_masks import kernel_mask, teacher_mask
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'cuda_emulation')
# source -> (<<<...>>> launches, kernels declaring dynamic shared memory);
# lstm_scan.cu and decode_loop.cu launch their kernels through
# cudaLaunchCooperativeKernel
SOURCES = {'lstm_scan.cu': (0, 2), 'teacher_scan.cu': (3, 3),
           'teacher_bwd.cu': (5, 4), 'decode_step.cu': (5, 4),
           'lstm_step.cu': (1, 1), 'decode_loop.cu': (0, 1)}
CODE = {torch.float32: 0, torch.bfloat16: 1}
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DTYPES = pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                                 ids=['float32', 'bfloat16'])


def _compile(gxx, args, cwd):
    return subprocess.run([gxx, '-std=c++20', '-pthread', *args], cwd=cwd,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """The scan kernels' launchers, built for the CPU."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    tmp = tmp_path_factory.mktemp('cuda_emulation')
    probe = tmp / 'probe.cpp'
    probe.write_text('#include <barrier>\nint main() { std::barrier<> b(1); '
                     'b.arrive_and_wait(); return 0; }\n')
    if _compile(gxx, [str(probe), '-o', str(tmp / 'probe')],
                tmp).returncode != 0:
        pytest.skip('needs a g++ with C++20 <barrier>')
    rewritten = []
    for name, counts in SOURCES.items():
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src = f.read()
        src, n_launch = re.subn(
            r'(\w+<[\w, ]+>)<<<(.*?), (\w+), (\w+), (\w+)>>>\(',
            r'emu::launch(\2, \3, \4, \1, ', src)
        src, n_smem = re.subn(r'extern __shared__ float4 smem4\[\];',
                              'float4* smem4 = emu::smem();', src)
        assert (n_launch, n_smem) == counts, (name, n_launch, n_smem)
        path = tmp / name.replace('.cu', '.cpp')
        path.write_text(src)
        rewritten.append(str(path))
    out = tmp / 'libemulated.so'
    built = _compile(gxx, ['-O1', '-fPIC', '-shared', '-Wno-unknown-pragmas',
                           '-I' + HERE, '-I' + _build.CSRC_DIR,
                           os.path.join(HERE, 'emu.cpp'), *rewritten,
                           '-o', str(out)], tmp)
    assert built.returncode == 0, built.stdout
    library = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in _build.SIGNATURES.items():
        if name.startswith(('lstm_scan', 'lstm_step', 'teacher',
                            'decode_step', 'decode_loop', 'cor_kernels')):
            fn = getattr(library, name)
            fn.restype, fn.argtypes = restype, argtypes
    return library


def _mk(rng, shape, scale, dtype):
    return (torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
            .to(dtype).contiguous())


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _assert_close(got, want, tol, names, relative=False):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        assert not bool(torch.isnan(g).any()), name
        scale = max(1.0, float(w.abs().max())) if relative else 1.0
        assert float((g - w).abs().max()) / scale <= tol, name


def _plan(lib, kind, dtype, B, N, br, us):
    out = (ctypes.c_int * len(lsk._PLAN_KEYS))()
    assert lib.lstm_scan_plan(kind, CODE[dtype], B, N, br, us, out) == 0
    return dict(zip(lsk._PLAN_KEYS, out))


# (T, B, N, rows per group, units per slice; 0: the launcher's plan) on an
# emulated card of 6 SMs: one block; two row groups with a ragged second
# and three unit slices with a ragged third, N = 40 padded to 48 along the
# reduction; N = 520, whose 5 slices of 128 units end in one of 8 and
# whose weights do not stay resident (staged per chunk)
SCAN_SHAPES = [(3, 5, 16, 0, 0), (4, 21, 40, 16, 16), (2, 3, 520, 0, 0)]


@DTYPES
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('T,B,N,br,us', SCAN_SHAPES)
def test_emulated_lstm_scan(lib, dtype, reverse, T, B, N, br, us):
    """K4 and K5: blocks of one cooperative grid meeting at their row
    group's counter once a step."""
    _emulated_scan(lib, dtype, reverse, T, B, N, br, us, masked=False)


# every shape in float32, the two small ones in bfloat16 (N = 520 in
# bfloat16 takes ~40 s a case here)
MASKED_SCAN_CASES = [(dt,) + shape for shape in SCAN_SHAPES
                     for dt in (torch.float32, torch.bfloat16)
                     if dt == torch.float32 or shape[2] <= 256]


@pytest.mark.parametrize(
    'dtype,T,B,N,br,us', MASKED_SCAN_CASES,
    ids=['%s-%d-%d-%d' % (str(c[0])[6:], *c[1:4]) for c in MASKED_SCAN_CASES])
@pytest.mark.parametrize('reverse', [False, True])
def test_emulated_lstm_scan_masked(lib, dtype, reverse, T, B, N, br, us):
    """K4 and K5 with a padding mask: carries that pass masked steps by
    (K5 parks dh in dh0 across the product), dzx zero there."""
    _emulated_scan(lib, dtype, reverse, T, B, N, br, us, masked=True)


def _emulated_scan(lib, dtype, reverse, T, B, N, br, us, masked):
    rng = np.random.default_rng(1)
    zx, R = _mk(rng, (T, B, 4 * N), 1.0, dtype), \
        _mk(rng, (N, 4 * N), N ** -0.5, dtype)
    h0, c0 = _mk(rng, (B, N), .2, dtype), _mk(rng, (B, N), .2, dtype)
    mask = kernel_mask(T, B, 2) if masked else None
    mask_ptr = None if mask is None else mask.data_ptr()
    want = lsk.lstm_scan_fwd_reference(zx, R, h0, c0, reverse, mask)
    got = [torch.full_like(w, float('nan')) for w in want]
    bar = lsk._group_counters(B, 'cpu')
    err = lib.lstm_scan_fwd_launch(CODE[dtype], *_ptrs([zx, R, h0, c0]),
                                   mask_ptr, *_ptrs(got), bar.data_ptr(), T,
                                   B, N, int(reverse), br, us, None)
    assert err == 0
    _assert_close(got, want, TOL[dtype], ('hs', 'cs', 'hT', 'cT'))
    plan = _plan(lib, 0, dtype, B, N, br, us)
    # every block of a group arrived after each step but the last
    groups = -(-B // plan['rows_per_group'])
    assert bar.tolist()[:groups] == [(T - 1) * plan['slices']] * groups
    hs, cs = want[:2]
    if reverse:
        hprev, cprev = torch.cat([hs[1:], h0[None]]), \
            torch.cat([cs[1:], c0[None]])
    else:
        hprev, cprev = torch.cat([h0[None], hs[:-1]]), \
            torch.cat([c0[None], cs[:-1]])
    cots = [_mk(rng, s, .1, dtype) for s in ((T, B, N), (B, N), (B, N))]
    want = lsk.lstm_scan_bwd_reference(*cots, zx, R, hprev, cprev, cs,
                                       reverse, mask)
    got = [torch.full_like(w, float('nan')) for w in want]
    ins = cots + [zx, R, hprev, cprev, cs]
    bar.zero_()
    err = lib.lstm_scan_bwd_launch(CODE[dtype], *_ptrs(ins), mask_ptr,
                                   *_ptrs(got), bar.data_ptr(), T, B, N,
                                   int(reverse), br, us, None)
    assert err == 0
    _assert_close(got, want, TOL[dtype], ('dzx', 'dh0', 'dc0'),
                  relative=True)
    if masked:
        assert not bool(got[0][mask == 0].any())


@DTYPES
def test_emulated_lstm_scan_plans(lib, dtype):
    """What the launcher picks on 6 SMs, and what it refuses."""
    # R's gate columns resident (K5: and its rows), every SM a block
    assert _plan(lib, 0, dtype, 21, 40, 16, 16) == dict(
        _plan(lib, 0, dtype, 21, 40, 16, 16), groups=2, slices=3,
        rows_per_group=16, units_per_slice=16, resident=1, launches=1)
    assert _plan(lib, 1, dtype, 21, 40, 16, 16)['resident'] == 3
    # 5 slices of 128 units and one group of 16 rows hold 8,192 outputs,
    # the most a block's product holds, so 40 rows take three launches
    p = _plan(lib, 0, dtype, 40, 520, 0, 0)
    assert (p['groups'], p['slices'], p['rows_per_group'],
            p['units_per_slice'], p['resident'], p['launches']) \
        == (1, 5, 16, 128, 0, 3)
    # more blocks (3 groups x 3 slices) than SMs: the launch is refused,
    # nothing runs
    T, B, N = 2, 40, 24
    zeros = [torch.zeros(s, dtype=dtype) for s in
             ((T, B, 4 * N), (N, 4 * N), (B, N), (B, N), (T, B, N),
              (T, B, N), (B, N), (B, N))]
    bar = lsk._group_counters(B, 'cpu')
    err = lib.lstm_scan_fwd_launch(CODE[dtype], *_ptrs(zeros[:4]), None,
                                   *_ptrs(zeros[4:]), bar.data_ptr(), T, B, N,
                                   0, 16, 8, None)
    assert err == 720     # cudaErrorCooperativeLaunchTooLarge
    assert float(zeros[4].abs().sum()) == 0.0
    # imposed sizes that no product holds, or that break the tiles
    out = (ctypes.c_int * len(lsk._PLAN_KEYS))()
    assert lib.lstm_scan_plan(0, CODE[dtype], 40, 16, 12, 8, out) != 0
    assert lib.lstm_scan_plan(0, CODE[dtype], 512, 512, 512, 128, out) != 0


def _teacher_inputs(dtype, B, Td, T, W, A, with_masks, seed):
    rng = np.random.default_rng(seed)
    sc = 0.3
    zx = _mk(rng, (Td, B, 4 * W), 1.0, torch.float32)
    u, att = _mk(rng, (B, T, W), sc, dtype), _mk(rng, (B, T, A), sc, dtype)
    Kc, R = _mk(rng, (A, 4 * W), sc, dtype), _mk(rng, (W, 4 * W), sc, dtype)
    W_a, v = _mk(rng, (W, W), sc, dtype), _mk(rng, (1, W), sc, dtype)
    b_UW, b_v = _mk(rng, (1, W), sc, dtype), \
        _mk(rng, (1, 1), sc, torch.float32)
    bias = _mk(rng, (1, 4 * W), sc, dtype)
    if with_masks:
        maskc = torch.from_numpy(((rng.random((4, B, A)) < 0.8) / 0.8)
                                 .astype(np.float32)).to(dtype)
    else:
        maskc = torch.ones((4, B, A), dtype=dtype)
    h0, c0 = _mk(rng, (B, W), sc, dtype), _mk(rng, (B, W), sc, dtype)
    return [zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0]


def _launch_teacher_fwd(lib, code, ins, outs, Td, B, T, W, A, ww,
                        enc_mask=None):
    """K6's launcher on `ins` in `teacher_fwd`'s order, with [W_a | R]^T
    in place of R and W_a and its scratch poisoned with NaN."""
    zx, u, att, Kc, R, W_a, *rest = ins
    kins = [zx, u, att, Kc, torch.cat([W_a, R], dim=1).t().contiguous(),
            *rest]
    dt = R.dtype
    scratch = [torch.full((B, W), float('nan')).to(dt),
               torch.full((B, 4 * W), float('nan')),
               torch.full((4, B, A), float('nan')).to(dt),
               torch.full((B,), float('nan'))]
    in_ptrs = (ctypes.c_void_p * len(kins))(*_ptrs(kins))
    out_ptrs = (ctypes.c_void_p * (len(outs) + 4))(*_ptrs(outs + scratch))
    return lib.teacher_fwd_launch(
        code, in_ptrs, out_ptrs,
        None if enc_mask is None else enc_mask.data_ptr(), Td, B, T, W, A, ww,
        None)


# (B, Td, T, W, A, ww): ragged row blocks, T != Td, windows clipped at both
# ends of the line, widths that leave threads to split a product's reduction;
# K7's row tiles ragged (B = 19) with widths that are multiples of 8 but not
# of 16 (a bf16 mma tile's reduction); A = 520, more context columns than
# K6's attention block covers in one pass and K7's in one block
TEACHER_SHAPES = [(5, 7, 16, 16, 24, 5), (3, 6, 9, 40, 8, 2),
                  (2, 4, 30, 8, 16, 1), (19, 5, 12, 24, 40, 2),
                  (2, 3, 6, 8, 520, 1)]
# with the encoder's padding mask (`teacher_mask`, rows of every kind) and
# dropout masks: the first shape, and a decoder of 10 steps over lines of
# at most 8 positions, so that every right-padded row runs past its
# line's end (few cases: this file's run sets the suite's length)
MASKED_TEACHER_SHAPES = [TEACHER_SHAPES[0], (4, 10, 8, 8, 16, 2)]


@DTYPES
@pytest.mark.parametrize('with_masks', [False, True])
@pytest.mark.parametrize('B,Td,T,W,A,ww', TEACHER_SHAPES)
def test_emulated_teacher_kernels(lib, dtype, with_masks, B, Td, T, W, A, ww):
    """K6 against its plain version, then K7 on the plain K6's residuals."""
    _emulated_teacher(lib, dtype, with_masks, B, Td, T, W, A, ww, False)


@DTYPES
@pytest.mark.parametrize('B,Td,T,W,A,ww', MASKED_TEACHER_SHAPES)
def test_emulated_teacher_kernels_padded(lib, dtype, B, Td, T, W, A, ww):
    """K6 and K7 with the encoder's padding mask: padded positions and
    rows whose window never holds a valid position (zero alignment, the
    window centre held at 1) against the plain versions."""
    _emulated_teacher(lib, dtype, True, B, Td, T, W, A, ww, True)


def _emulated_teacher(lib, dtype, with_masks, B, Td, T, W, A, ww, padded):
    ins = _teacher_inputs(dtype, B, Td, T, W, A, with_masks, seed=B)
    zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0 = ins
    enc_mask = teacher_mask(B, T, B + Td, ww) if padded else None
    want = tk.teacher_fwd_reference(*ins, ww, enc_mask)
    got = [torch.full_like(w, float('nan')) for w in want]
    err = _launch_teacher_fwd(lib, CODE[dtype], ins, got, Td, B, T, W, A, ww,
                              enc_mask)
    assert err == 0
    _assert_close(got, want, TOL[dtype], ('hs', 'cs', 'aa', 'zs'))
    if padded:
        # no alignment on a padded position; rows 1 and 3 (where there is
        # one) never see a valid position
        assert not bool(got[2][:, enc_mask == 0].any())
        assert not bool(got[2][:, 1:4:2].any())
    hs, cs, aa, zs = want
    hprev = torch.cat([h0[None], hs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    g = _mk(np.random.default_rng(9), hs.shape, 0.1, dtype)
    want = tk.teacher_bwd_reference(zs, g, hprev, cprev, cs, aa, u, att, Kc,
                                    R, W_a, v, b_UW, maskc, ww, enc_mask)
    got = [torch.full_like(w, float('nan')) for w in want[:7]] \
        + [torch.zeros_like(w) for w in want[7:]]
    scratch = [torch.full((Td, B, W), float('nan')).to(dtype),
               torch.full((4, B, A + W), float('nan'))]
    kins = [zs, g, hprev, cprev, cs, aa, u, att, Kc, R, W_a,
            W_a.t().contiguous(), v, b_UW, maskc]
    in_ptrs = (ctypes.c_void_p * len(kins))(*_ptrs(kins))
    out_ptrs = (ctypes.c_void_p * (len(got) + 2))(*_ptrs(got + scratch))
    err = lib.teacher_bwd_launch(
        CODE[dtype], in_ptrs, out_ptrs,
        None if enc_mask is None else enc_mask.data_ptr(), Td, B, T, W, A, ww,
        None)
    assert err == 0
    _assert_close(got, want, TOL[dtype],
                  ('dz', 'ds', 'dctx', 'dwvec', 'dh0', 'dc0', 'dva', 'du',
                   'datt'), relative=True)
    if padded:
        # nothing reaches a padded position or a row without a valid one
        ds, du, datt = got[1], got[7], got[8]
        assert not bool(ds[:, enc_mask == 0].any())
        assert not bool(du[enc_mask == 0].any())
        assert not bool(datt[enc_mask == 0].any())
        assert not bool(got[3][:, 1:4:2].any())         # dwvec


def _step_inputs(dtype, udtype, N, V, W, A, WIN, seed):
    """K3's activations and packed weights; row 1 has no visible position,
    the others a ragged visible stretch."""
    rng = np.random.default_rng(seed)
    fb = torch.from_numpy(rng.uniform(0, 1, (N, V)).astype(np.float32))
    states = [_mk(rng, (N, W), .5, torch.float32) for _ in range(4)]
    u_w = _mk(rng, (N, WIN, W), .5, udtype)
    att_w = _mk(rng, (N, WIN, A), .5, udtype)
    visible = torch.from_numpy(rng.random((N, WIN)) < 0.7)
    visible[:, 0] = True
    visible[1:2] = False
    shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W), b1=(4 * W,),
                  k2=(W + A, 4 * W), r2=(W, 4 * W), b2=(4 * W,),
                  W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,))
    weights = {k: _mk(rng, shape, .3,
                      torch.float32 if k in dsk._BIASES else dtype)
               for k, shape in shapes.items()}
    weights.update(dsk.kernel_layouts(weights))
    return [fb, *states, u_w, att_w, visible], weights


def _launch_step(lib, dtype, acts, weights, win_start=None, rows_per_line=0,
                 br=0):
    """One emulated launch of K3 (gathered windows where `rows_per_line`
    is 0, else by index); its six outputs, NaN where it wrote nothing."""
    fb, h1, _, _, _, u, att, visible = acts
    N, V = fb.shape
    W, A, WIN = h1.shape[1], att.shape[-1], visible.shape[1]
    T = u.shape[1] if rows_per_line else 0
    starts = (torch.zeros(1, dtype=torch.int32) if win_start is None
              else win_start.to(torch.int32).contiguous())
    ins = list(acts[:7]) + [visible.to(torch.uint8), starts] \
        + [weights[k] for k in dsk._KERNEL_ORDER]
    got = [torch.full(s, float('nan')) for s in
           ((N, V), (N, W), (N, W), (N, W), (N, W), (N, WIN))]
    Vp = -(-V // 16) * 16
    scratch = [torch.full((N, Vp + 5 * W + A), float('nan')).to(dtype),
               torch.full((N, W), float('nan'))]
    in_ptrs = (ctypes.c_void_p * len(ins))(*_ptrs(ins))
    out_ptrs = (ctypes.c_void_p * (len(got) + 2))(*_ptrs(got + scratch))
    err = lib.decode_step_launch(CODE[dtype], CODE[u.dtype], in_ptrs,
                                 out_ptrs, N, V, W, A, WIN, rows_per_line, T,
                                 br, None)
    assert err == 0
    return got


# (N, V, W, A, WIN, rows of a product tile; 0: the launcher's pick): N no
# multiple of the row tile (and two tiles of 64 rows), V above and below W
# (two readout slices at V = 150), W no whole slice of 32 units and below a
# product's 128 columns, WIN of 1
STEP_SHAPES = [(6, 150, 16, 24, 12, 0), (70, 45, 40, 8, 4, 64),
               (1, 7, 8, 16, 1, 0)]


@DTYPES
@pytest.mark.parametrize('udtype', [torch.float32, torch.bfloat16],
                         ids=['windows32', 'windows16'])
@pytest.mark.parametrize('N,V,W,A,WIN,br', STEP_SHAPES)
def test_emulated_decode_step(lib, dtype, udtype, N, V, W, A, WIN, br):
    """K3 on gathered windows against its plain version. bfloat16: an
    operand that rounds the other way (tanhf against torch.tanh) moves a
    sum by an ulp of bf16."""
    acts, weights = _step_inputs(dtype, udtype, N, V, W, A, WIN, seed=N)
    want = dsk.fused_decode_step_reference(*acts, weights)
    got = _launch_step(lib, dtype, acts, weights, br=br)
    _assert_close(got, want, TOL[dtype],
                  ('probs', 'h1', 'c1', 'h2', 'c2', 'align'))
    if N > 1:
        assert float(got[5][1].abs().max()) == 0.0    # the all-masked row


@DTYPES
@pytest.mark.parametrize('rows_per_line,br', [(1, 0), (5, 128)])
def test_emulated_decode_step_indexed(lib, dtype, rows_per_line, br):
    """K3 reading the window rows by index: equal to the gathered form on
    the gathered rows, bit for bit, and close to the plain version; 21
    rows (a 128-row product tile where imposed: bfloat16 only), windows
    that run off both ends of a line of T = 9 encoder rows and clamp at
    T - 1."""
    if br == 128 and dtype == torch.float32:
        br = 64       # float32 products take 64-row tiles only
    N, V, W, A, WIN, T = 21, 13, 16, 24, 12, 9
    acts, weights = _step_inputs(dtype, torch.bfloat16, N, V, W, A, WIN,
                                 seed=3)
    rng = np.random.default_rng(4)
    lines = -(-N // rows_per_line)
    u = _mk(rng, (lines, T, W), .5, torch.bfloat16)
    att = _mk(rng, (lines, T, A), .5, torch.bfloat16)
    win_start = torch.from_numpy(rng.integers(0, T, N).astype(np.int32))
    win_start[0] = 0
    u_w, att_w = dsk.gather_windows(u, att, rows_per_line, win_start, WIN)
    acts_g = acts[:5] + [u_w, att_w] + acts[7:]
    want = dsk.fused_decode_step_reference(*acts_g, weights)
    got = _launch_step(lib, dtype, acts[:5] + [u, att] + acts[7:], weights,
                       win_start, rows_per_line, br)
    gathered = _launch_step(lib, dtype, acts_g, weights, br=br)
    for g, w in zip(got, gathered):
        assert torch.equal(g, w)
    _assert_close(got, want, TOL[dtype],
                  ('probs', 'h1', 'c1', 'h2', 'c2', 'align'))
    # the indexed plain version is the gather and the plain version
    plain = dsk.fused_decode_step_indexed(*acts[:5], u, att, rows_per_line,
                                          win_start, acts[7], weights)
    for p, w in zip(plain, want):
        assert torch.equal(p, w)


def _plan_k2(lib, dtype, B, D, W, br=0, us=0):
    out = (ctypes.c_int * 4)()
    err = lib.lstm_step_plan(CODE[dtype], B, D, W, br, us, out)
    return None if err else tuple(out)


@DTYPES
@pytest.mark.parametrize('B', [1, 16, 40])
@pytest.mark.parametrize('D,W,br,us', [(24, 40, 0, 0), (24, 40, 16, 8),
                                       (136, 16, 32, 16)])
def test_emulated_lstm_step(lib, dtype, B, D, W, br, us):
    """K2 against ops/lstm.py:lstm_step: the launcher's tile and imposed
    ones (row tiles of 16 and 32, ragged at B = 40; a ragged unit slice
    at W = 40; x.K over several chunks at D = 136). float32 differs in
    summation order; bfloat16 by an ulp where a float32 sum rounds the
    other way."""
    from cor_asv_ann_tpu_torch.ops.lstm import lstm_step
    rng = np.random.default_rng(B + D)
    x, h, c = (_mk(rng, s, .7, dtype) for s in ((B, D), (B, W), (B, W)))
    K, R = _mk(rng, (D, 4 * W), .3, dtype), _mk(rng, (W, 4 * W), .3, dtype)
    b = _mk(rng, (4 * W,), .5, dtype)
    want = lstm_step(x, h, c, {'kernel': K, 'recurrent_kernel': R,
                               'bias': b})
    got = [torch.full_like(w, float('nan')) for w in want]
    err = lib.lstm_step_launch(CODE[dtype], *_ptrs([x, h, c, K, R, b] + got),
                               B, D, W, br, us, None)
    assert err == 0
    _assert_close(got, want, 1e-5 if dtype == torch.float32 else 1e-2,
                  ('h', 'c'))
    plan = _plan_k2(lib, dtype, B, D, W, br, us)
    assert plan[2] == -(-B // plan[0]) and plan[3] == -(-W // plan[1])


def test_emulated_lstm_step_plans(lib):
    """The tiles the launcher picks on 6 SMs, and what it refuses."""
    # B = 256, D = 1024, W = 512 (the decoder's top cell): 64 rows x 16
    # units in float32 (64 x 32 needs more shared memory than a block has
    # with 512-byte chunks)
    assert _plan_k2(lib, torch.float32, 256, 1024, 512) == (64, 16, 4, 32)
    # greedy serving's batches: one tile of 16 rows
    assert _plan_k2(lib, torch.bfloat16, 16, 1024, 512)[0] == 16
    assert _plan_k2(lib, torch.float32, 1, 512, 512)[0] == 16
    # no tile of rows that are not whole mma tiles, or of more outputs
    # than the accumulators hold; bf16 slices of whole 16-byte pieces
    assert _plan_k2(lib, torch.float32, 40, 24, 40, 24, 8) is None
    assert _plan_k2(lib, torch.float32, 40, 24, 40, 64, 64) is None
    assert _plan_k2(lib, torch.float32, 40, 24, 40, 64, 32) is None
    assert _plan_k2(lib, torch.bfloat16, 40, 24, 40, 16, 4) is None


def test_emulated_launchers_refuse_what_the_kernels_cannot_take(lib):
    assert lib.decode_step_supported(45, 512, 512, 12) == 1
    assert lib.decode_step_supported(45, 2048, 2048, 12) == 1
    # 64 rows' logits beyond a block's shared memory, ragged widths
    assert lib.decode_step_supported(4096, 512, 512, 12) == 0
    assert lib.decode_step_supported(45, 12, 16, 12) == 0
    # 128-row product tiles in bf16 where the LSTM stages' 16 slices of
    # W = 512 in ceil(N / 128) row tiles still cover the 6 SMs here
    assert lib.decode_step_rows_per_tile(1, 5000, 512, 0) == 128
    assert lib.decode_step_rows_per_tile(1, 40, 40, 0) == 64
    assert lib.decode_step_rows_per_tile(0, 5000, 512, 0) == 64
    assert lib.decode_step_rows_per_tile(0, 50, 512, 128) == 0
    assert lib.decode_step_rows_per_tile(1, 50, 512, 32) == 0
    assert lib.teacher_scan_supported(512, 512, 5) == 1
    assert lib.teacher_scan_supported(768, 768, 5) == 1
    assert lib.teacher_scan_supported(1024, 1024, 5) == 1
    assert lib.teacher_bwd_supported(4096, 4096, 5) == 1
    # K6's stage kernels keep no width in shared memory (a K6 that kept
    # its rows' state there refused this width)
    assert lib.teacher_scan_supported(1280, 1280, 5) == 1
    # no window, ragged widths
    assert lib.teacher_bwd_supported(512, 512, 0) == 0
    assert lib.teacher_bwd_supported(12, 16, 5) == 0
    assert lib.teacher_scan_supported(512, 512, 0) == 0
    assert lib.teacher_scan_supported(12, 16, 5) == 0
    ins = _teacher_inputs(torch.float32, 2, 2, 4, 16, 16, False, seed=0)
    outs = [torch.zeros(1) for _ in range(4)]
    assert _launch_teacher_fwd(lib, 0, ins, outs, 2, 2, 4, 12, 16, 2) != 0
    assert _launch_teacher_fwd(lib, 7, ins, outs, 2, 2, 4, 16, 16, 2) != 0
    assert _launch_teacher_fwd(lib, 0, ins, outs, 2, 2, 4, 16, 16, 0) != 0


def _loop_inputs(B, T, W, A, V, ww, masked, seed):
    """K1's inputs: random bf16 states, encoder rows and weights, E
    sharpened so that the readout's picks have margins; line 2 (where B >
    2) is empty, and with `masked` the lines have ragged lengths."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    att, u = _mk(rng, (B, T, A), .5, bf), _mk(rng, (B, T, W), .5, bf)
    states = [(_mk(rng, (B, W), .5, bf), _mk(rng, (B, W), .5, bf))
              for _ in range(2)]
    shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W), b1=(4 * W,),
                  k2=(W + A, 4 * W), r2=(W, 4 * W), b2=(4 * W,),
                  W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,))
    weights = {k: _mk(rng, shape, .3, bf) for k, shape in shapes.items()}
    weights['E'] = _mk(rng, (V, W), 3.0, bf)
    lengths = rng.integers(1, T + 1, B) if masked else np.full(B, T)
    live = torch.ones(B, dtype=torch.int32)
    if B > 2:
        live[2], lengths[2] = 0, 0
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32))
    return att, u, states, live, mask, weights


def _assert_decodes_agree(got, want):
    """Indices and lengths equal, or, where summation order flips a near
    tie, the chosen probabilities equal within 2e-2 up to the first
    divergence; scores within 1e-2 a step where the line agrees."""
    idx_k, prob_k, len_k, sc_k = got
    idx_r, prob_r, len_r, sc_r = want
    for b in range(idx_r.shape[0]):
        L = int(len_r[b])
        if int(len_k[b]) == L and torch.equal(idx_k[b], idx_r[b]):
            assert float((prob_k[b] - prob_r[b]).abs().max()) <= 2e-2
            assert abs(float(sc_k[b] - sc_r[b])) <= 1e-2 * max(L, 1)
            continue
        d = int(torch.nonzero(idx_k[b] != idx_r[b])[0])
        assert float((prob_k[b, :d + 1] - prob_r[b, :d + 1]).abs().max()) \
            <= 2e-2


# (B, T, W, A, V, ww, units a unit block (0: the launcher's plan), masked):
# a ragged tile of 5 lines with an empty one, W = 40 (a multiple of 8, not
# of 16: the reduction padded to 32), the launcher's 3 unit blocks of 14
# units (seven n8 tiles) and one attention and one readout block for all
# five lines, unmasked and masked; imposed 8 units at W = 16 (2 unit
# blocks of four n8 tiles), launched twice; 17 lines: a tile of 16 (one
# unit block, 2 + 2 line blocks of 8 lines), then a tile of one
LOOP_SHAPES = [(5, 7, 40, 24, 13, 2, 0, False), (5, 7, 40, 24, 13, 2, 0, True),
               (5, 5, 16, 24, 11, 1, 8, True), (17, 4, 16, 32, 7, 1, 0, False)]


@pytest.mark.parametrize('B,T,W,A,V,ww,us,masked', LOOP_SHAPES)
def test_emulated_decode_loop(lib, B, T, W, A, V, ww, us, masked):
    """K1's cooperative grid on the 6-SM stand-in against
    decode_loop_reference: unit blocks and line blocks meeting at their
    counters three times a step until every line of the tile is done."""
    att, u, states, live, mask, weights = _loop_inputs(
        B, T, W, A, V, ww, masked, seed=B + W)
    args = (att, u, states, live, mask, weights, 3, 2 * T, ww)
    *got, tiles = dlk.run_kernel(lib, *args, units_per_block=us)
    assert tiles == -(-B // 16)
    want = dlk.decode_loop_reference(*args)
    if B > 2:
        assert int(got[2][2]) == 0 and float(got[3][2]) == 0.0
        assert float(got[0][2].abs().sum()) == 0.0
    _assert_decodes_agree(got, want)
    if us:    # two launches give the same bits
        *again, _ = dlk.run_kernel(lib, *args, units_per_block=us)
        assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_emulated_decode_loop_plans(lib):
    """The grids K1's launcher picks on 6 SMs, and what it refuses."""
    plan = lambda *a, **k: dlk.decode_loop_plan(*a, lib=lib, **k)
    # the most line blocks the SMs left over allow, then the fewest unit
    # blocks, then the fewest n8 tiles
    assert plan(40, 24, 13, 2, lines=5) == dict(
        plan(40, 24, 13, 2, lines=5), unit_blocks=3, line_blocks=1,
        units_per_block=14, gate_columns=56, tiles_per_pass=14)
    p = plan(16, 32, 7, 1, lines=16)
    assert (p['unit_blocks'], p['line_blocks'], p['gate_columns']) \
        == (1, 2, 64)
    p = plan(16, 24, 11, 1, lines=5, units_per_block=8)
    assert (p['unit_blocks'], p['line_blocks'], p['gate_columns']) \
        == (2, 2, 32)
    assert plan(16, 32, 7, 1, lines=1)['line_blocks'] == 1
    assert plan(512, 512, 45, 5) is None            # 128 unit blocks at least
    assert plan(12, 16, 7, 1) is None                # not a multiple of 8
    assert plan(40, 24, 13, 0) is None               # no window
    assert plan(40, 24, 13, 2, units_per_block=8) is None  # 5 + 2 blocks
    assert plan(40, 24, 13, 2, lines=17) is None
