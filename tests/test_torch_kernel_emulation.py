"""PyTorch port: the CUDA sources of the scan kernels, run on the CPU.

There is no GPU and no ``nvcc`` where these tests run, but the kernels
K4-K7 (``csrc/lstm_scan.cu``, ``csrc/teacher_scan.cu`` over
``csrc/scan_common.cuh``) use few CUDA constructs: blocks of threads, a
block barrier, warp shuffles, dynamic shared memory, bf16 conversions.
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
gradients relative to their scale). Skipped where no C++20 ``g++`` is
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
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'cuda_emulation')
SOURCES = ('lstm_scan.cu', 'teacher_scan.cu')
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
    for name in SOURCES:
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src = f.read()
        src, n_launch = re.subn(
            r'(\w+<T>)<<<(.*?), (\w+), (\w+), (\w+)>>>\(',
            r'emu::launch(\2, \3, \4, \1, ', src)
        src, n_smem = re.subn(r'extern __shared__ float4 smem4\[\];',
                              'float4* smem4 = emu::smem();', src)
        assert (n_launch, n_smem) == (2, 2), (name, n_launch, n_smem)
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
        if name.startswith(('lstm_scan', 'teacher')):
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


@DTYPES
@pytest.mark.parametrize('reverse', [False, True])
def test_emulated_lstm_scan(lib, dtype, reverse):
    """K4 and K5 (T=3, a ragged second block of rows)."""
    T, B, N = 3, 5, 16
    rng = np.random.default_rng(1)
    zx, R = _mk(rng, (T, B, 4 * N), 1.0, dtype), \
        _mk(rng, (N, 4 * N), N ** -0.5, dtype)
    h0, c0 = _mk(rng, (B, N), .2, dtype), _mk(rng, (B, N), .2, dtype)
    want = lsk.lstm_scan_fwd_reference(zx, R, h0, c0, reverse)
    got = [torch.full_like(w, float('nan')) for w in want]
    err = lib.lstm_scan_fwd_launch(CODE[dtype], *_ptrs([zx, R, h0, c0] + got),
                                   T, B, N, int(reverse), None)
    assert err == 0
    _assert_close(got, want, TOL[dtype], ('hs', 'cs', 'hT', 'cT'))
    hs, cs = want[:2]
    if reverse:
        hprev, cprev = torch.cat([hs[1:], h0[None]]), \
            torch.cat([cs[1:], c0[None]])
    else:
        hprev, cprev = torch.cat([h0[None], hs[:-1]]), \
            torch.cat([c0[None], cs[:-1]])
    cots = [_mk(rng, s, .1, dtype) for s in ((T, B, N), (B, N), (B, N))]
    want = lsk.lstm_scan_bwd_reference(*cots, zx, R, hprev, cprev, cs,
                                       reverse)
    got = [torch.full_like(w, float('nan')) for w in want]
    ins = cots + [zx, R, R.t().contiguous(), hprev, cprev, cs]
    err = lib.lstm_scan_bwd_launch(CODE[dtype], *_ptrs(ins + got), T, B, N,
                                   int(reverse), None)
    assert err == 0
    _assert_close(got, want, TOL[dtype], ('dzx', 'dh0', 'dc0'),
                  relative=True)


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


# (B, Td, T, W, A, ww): ragged row blocks, T != Td, windows clipped at both
# ends of the line, widths that leave threads to split a product's reduction
TEACHER_SHAPES = [(5, 7, 16, 16, 24, 5), (3, 6, 9, 40, 8, 2),
                  (2, 4, 30, 8, 16, 1)]


@DTYPES
@pytest.mark.parametrize('with_masks', [False, True])
@pytest.mark.parametrize('B,Td,T,W,A,ww', TEACHER_SHAPES)
def test_emulated_teacher_kernels(lib, dtype, with_masks, B, Td, T, W, A, ww):
    """K6 against its plain version, then K7 on the plain K6's residuals."""
    ins = _teacher_inputs(dtype, B, Td, T, W, A, with_masks, seed=B)
    zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0 = ins
    want = tk.teacher_fwd_reference(*ins, ww)
    got = [torch.full_like(w, float('nan')) for w in want]
    err = lib.teacher_fwd_launch(CODE[dtype], *_ptrs(ins + got), Td, B, T, W,
                                 A, ww, None)
    assert err == 0
    _assert_close(got, want, TOL[dtype], ('hs', 'cs', 'aa', 'zs'))
    hs, cs, aa, zs = want
    hprev = torch.cat([h0[None], hs[:-1]])
    cprev = torch.cat([c0[None], cs[:-1]])
    g = _mk(np.random.default_rng(9), hs.shape, 0.1, dtype)
    want = tk.teacher_bwd_reference(zs, g, hprev, cprev, cs, aa, u, att, Kc,
                                    R, W_a, v, b_UW, maskc, ww)
    got = [torch.full_like(w, float('nan')) for w in want[:7]] \
        + [torch.zeros_like(w) for w in want[7:]]
    KcT, RT, W_aT = (m.t().contiguous() for m in (Kc, R, W_a))
    kins = [zs, g, hprev, cprev, cs, aa, u, att, KcT, RT, W_a, W_aT, v, b_UW,
            maskc]
    err = lib.teacher_bwd_launch(CODE[dtype], *_ptrs(kins + got), Td, B, T,
                                 W, A, ww, None)
    assert err == 0
    _assert_close(got, want, TOL[dtype],
                  ('dz', 'ds', 'dctx', 'dwvec', 'dh0', 'dc0', 'dva', 'du',
                   'datt'), relative=True)


def test_emulated_launchers_refuse_what_the_kernels_cannot_take(lib):
    assert lib.teacher_scan_supported(512, 512, 5) == 1
    assert lib.teacher_scan_supported(768, 768, 5) == 1
    # scratch beyond a block's shared memory, no window, ragged widths
    assert lib.teacher_scan_supported(1024, 1024, 5) == 0
    assert lib.teacher_scan_supported(512, 512, 0) == 0
    assert lib.teacher_scan_supported(12, 16, 5) == 0
    ins = _teacher_inputs(torch.float32, 2, 2, 4, 12, 16, False, seed=0)
    outs = [torch.zeros(1) for _ in range(4)]
    assert lib.teacher_fwd_launch(0, *_ptrs(ins + outs), 2, 2, 4, 12, 16, 2,
                                  None) != 0
    assert lib.teacher_fwd_launch(7, *_ptrs(ins + outs), 2, 2, 4, 16, 16, 2,
                                  None) != 0
