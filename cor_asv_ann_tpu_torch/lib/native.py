"""ctypes binding for the native edit-ops library (lazy build, graceful
fallback).

A copy of the JAX package's ``lib/native.py``, over the port's own
``native/`` sources, kept so the port imports nothing of that
package.

Provides `lev_distance`, `lev_distance_batch` and `nw_align` backed by
cor_asv_ann_tpu_torch/native/libeditops.so. The library is built on first use
via its Makefile if a compiler is available; all callers must handle
`available() == False`.
"""

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')
_LIB_PATH = os.path.join(_NATIVE_DIR, 'libeditops.so')
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(['make', '-C', _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.lev_distance.restype = ctypes.c_int
    lib.lev_distance.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
    lib.lev_distance_batch.restype = None
    lib.lev_distance_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.nw_align.restype = ctypes.c_int
    lib.nw_align.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def _codes(text):
    return np.frombuffer(text.encode('utf-32-le'), dtype=np.uint32)


def _ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def lev_distance(a, b):
    lib = _load()
    ca, cb = _codes(a), _codes(b)
    if lib is None:
        raise RuntimeError('native editops library unavailable')
    return lib.lev_distance(_ptr(ca, ctypes.c_uint32), len(ca),
                            _ptr(cb, ctypes.c_uint32), len(cb))


def lev_distance_batch(pairs):
    """Distances for a list of (a, b) string pairs."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native editops library unavailable')
    a_all, b_all = [], []
    a_off, b_off = [0], [0]
    for a, b in pairs:
        ca, cb = _codes(a), _codes(b)
        a_all.append(ca)
        b_all.append(cb)
        a_off.append(a_off[-1] + len(ca))
        b_off.append(b_off[-1] + len(cb))
    a_cat = np.concatenate(a_all) if a_all else np.zeros(0, np.uint32)
    b_cat = np.concatenate(b_all) if b_all else np.zeros(0, np.uint32)
    a_off = np.asarray(a_off, np.int32)
    b_off = np.asarray(b_off, np.int32)
    out = np.zeros(len(pairs), np.int32)
    lib.lev_distance_batch(_ptr(a_cat, ctypes.c_uint32),
                           _ptr(a_off, ctypes.c_int),
                           _ptr(b_cat, ctypes.c_uint32),
                           _ptr(b_off, ctypes.c_int),
                           len(pairs), _ptr(out, ctypes.c_int))
    return out.tolist()


def nw_align(a, b, gap=0):
    """Minimal-edit per-symbol pair alignment [(sym_or_gap, sym_or_gap)]."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native editops library unavailable')
    ca, cb = _codes(a), _codes(b)
    max_steps = len(ca) + len(cb) + 1
    out_src = np.zeros(max_steps, np.int32)
    out_tgt = np.zeros(max_steps, np.int32)
    n = lib.nw_align(_ptr(ca, ctypes.c_uint32), len(ca),
                     _ptr(cb, ctypes.c_uint32), len(cb),
                     _ptr(out_src, ctypes.c_int),
                     _ptr(out_tgt, ctypes.c_int), max_steps)
    if n < 0:
        raise RuntimeError('nw_align buffer too small')
    pairs = []
    for k in range(n):
        si, ti = int(out_src[k]), int(out_tgt[k])
        pairs.append((a[si] if si >= 0 else gap,
                      b[ti] if ti >= 0 else gap))
    return pairs
