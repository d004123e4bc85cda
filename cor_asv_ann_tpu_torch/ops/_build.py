"""Build and load the port's CUDA kernels.

Every source named in ``SOURCES`` (``csrc/lstm_step.cu``: K2,
``csrc/decode_loop.cu``: K1, ``csrc/lstm_scan.cu``: K4 and K5,
``csrc/teacher_scan.cu``: K6, ``csrc/teacher_bwd.cu``: K7,
``csrc/decode_step.cu``: K3; all share ``csrc/scan_common.cuh``, K4
and K5 also use ``csrc/scan_grid.cuh``, K1, K2, K3, K6 and K7
``csrc/step_tile.cuh`` over it) is
compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into
one shared library with a plain C interface under ``build/kernels/`` at
the repo root, and loaded with ``ctypes``. The library's name carries a hash of
the sources and headers, so an edited source is rebuilt and an unchanged
one is reused. Nothing is built when a module is imported: the first
launch builds. A failed build raises.

Each exported launcher returns ``cudaGetLastError()`` right after its
launch; ``check`` raises on anything but 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), 'build', 'kernels')
SOURCES = ('lstm_step.cu', 'decode_loop.cu', 'lstm_scan.cu',
           'teacher_scan.cu', 'teacher_bwd.cu', 'decode_step.cu')
HEADERS = ('scan_common.cuh', 'scan_grid.cuh', 'step_tile.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

P = ctypes.c_void_p
I = ctypes.c_int
# exported C functions: name -> (restype, argtypes)
SIGNATURES = {
    'cor_kernels_error_string': (ctypes.c_char_p, [I]),
    'lstm_step_plan': (I, [I] * 6 + [P]),
    'lstm_step_launch': (I, [I] + [P] * 8 + [I] * 5 + [P]),
    'decode_loop_plan': (I, [I] * 6 + [P]),
    'decode_loop_launch': (I, [P] * 4 + [I] * 9 + [P]),
    'lstm_scan_max_width': (I, []),
    'lstm_scan_plan': (I, [I] * 6 + [P]),
    'lstm_scan_fwd_launch': (I, [I] + [P] * 10 + [I] * 6 + [P]),
    'lstm_scan_bwd_launch': (I, [I] + [P] * 13 + [I] * 6 + [P]),
    'teacher_scan_supported': (I, [I] * 3),
    'teacher_fwd_launch': (I, [I] + [P] * 3 + [I] * 6 + [P]),
    'teacher_bwd_supported': (I, [I] * 3),
    'teacher_bwd_launch': (I, [I] + [P] * 3 + [I] * 6 + [P]),
    'decode_step_supported': (I, [I] * 4),
    'decode_step_rows_per_tile': (I, [I] * 4),
    'decode_step_launch': (I, [I] * 2 + [P] * 2 + [I] * 8 + [P]),
}

_lock = threading.Lock()
_lib = None
# nvcc's output of the last build (-Xptxas -v: registers, shared memory
# and spills per kernel), for chip_smoke.py and debugging
build_log = ''


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    path = shutil.which('nvcc')
    if path is None:
        raise RuntimeError('nvcc not found (CUDA_HOME=%s); the CUDA '
                           'kernels cannot be built' % cuda_home)
    return path


def _source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build():
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, 'libcor_kernels_%s.so'
                            % _source_hash())
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, name + '.%d.o' % os.getpid())
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-c', os.path.join(CSRC_DIR, name),
             '-o', obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append('== %s\n%s' % (name, out))
        if proc.returncode != 0:
            failed.append(name)
    build_log = '\n'.join(logs)
    if failed:
        raise RuntimeError('nvcc failed on %s:\n%s' % (failed, build_log))
    tmp = lib_path + '.%d.tmp' % os.getpid()
    link = subprocess.run([nvcc, '-shared', '-o', tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError('linking the kernels failed:\n' + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check(err, what, lib=None):
    """Raise if a launcher of `lib` (default: the built library) reported
    a CUDA error."""
    if err != 0:
        msg = (lib or library()).cor_kernels_error_string(err).decode()
        raise RuntimeError('%s failed: CUDA error %d (%s)' % (what, err, msg))


def stream_of(tensor):
    """PyTorch's current CUDA stream on the tensor's device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
