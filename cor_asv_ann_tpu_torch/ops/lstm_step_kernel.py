"""K2: the fused LSTM step as a CUDA kernel (``csrc/lstm_step.cu``).

Replaces the JAX package's Pallas kernel ``ops/pallas_lstm.py:
_lstm_step_kernel`` (``lstm_step_fused`` / ``lstm_step_auto``):
``z = r(x.K) + r(h.R) + b`` with Keras gates (i, f, c~, o), where r()
rounds a float32-accumulated product to the weight dtype. Float32 and
bfloat16 weights are supported; outputs follow the weight dtype. A block
of the kernel owns a tile of rows and a slice of units (their four gate
columns); the launcher picks the tile from the shapes (`step_plan`).

The plain twin is ``ops/lstm.py:lstm_step``. The wrapper takes it for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
"""

import ctypes

import torch

from . import _build
from .lstm import lstm_step

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


_PLAN_KEYS = ('rows_per_tile', 'units_per_slice', 'row_tiles',
              'unit_slices')


def step_plan(dtype, B, D, W, rows_per_tile=0, units_per_slice=0):
    """The tile a launch on the current CUDA device takes (the launcher's
    pick, or the imposed one) as a dict of `_PLAN_KEYS`; raises where it
    is refused."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _build.library().lstm_step_plan(_DTYPE_CODES[dtype], B, D, W,
                                          rows_per_tile, units_per_slice, out)
    _build.check(err, 'lstm_step plan')
    return dict(zip(_PLAN_KEYS, out))


def lstm_step_fused(x, h, c, kernel, recurrent_kernel, bias, *,
                    rows_per_tile=0, units_per_slice=0):
    """Fused LSTM step: x (B, D), h/c (B, W) -> (h', c') in the weight
    dtype. Same semantics as ``ops.lstm.lstm_step``. `rows_per_tile` and
    `units_per_slice` impose the kernel's tile (tests; 0: the
    launcher's pick)."""
    dt = kernel.dtype
    x, h, c = (t.to(dt).contiguous() for t in (x, h, c))
    tensors = (x, h, c, kernel, recurrent_kernel, bias)
    if all(t.device.type == 'cpu' for t in tensors):
        return lstm_step(x, h, c, {'kernel': kernel,
                                   'recurrent_kernel': recurrent_kernel,
                                   'bias': bias})
    dev = kernel.device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise ValueError('lstm_step_fused: tensors must all be on one '
                         'CUDA device (or all on the CPU)')
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise ValueError('lstm_step_fused: float32 or bfloat16 tensors of '
                         'one dtype expected, got %s'
                         % [t.dtype for t in tensors])
    B, D = x.shape
    W = h.shape[1]
    if (h.shape != (B, W) or c.shape != (B, W)
            or kernel.shape != (D, 4 * W)
            or recurrent_kernel.shape != (W, 4 * W)
            or bias.shape != (4 * W,)):
        raise ValueError('lstm_step_fused: inconsistent shapes')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('lstm_step_fused: weights must be contiguous')
    h_out = torch.empty((B, W), dtype=dt, device=dev)
    c_out = torch.empty((B, W), dtype=dt, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.lstm_step_launch(
            _DTYPE_CODES[dt], *(t.data_ptr() for t in tensors),
            h_out.data_ptr(), c_out.data_ptr(), B, D, W, rows_per_tile,
            units_per_slice, _build.stream_of(x))
    _build.check(err, 'lstm_step kernel (B=%d D=%d W=%d)' % (B, D, W))
    lstm_step_fused.launches += 1
    return h_out, c_out


lstm_step_fused.launches = 0


def lstm_step_auto(x, h, c, w):
    """Drop-in for ``ops.lstm.lstm_step`` through ``lstm_step_fused``;
    leading dims beyond the batch are flattened."""
    lead = x.shape[:-1]
    h2, c2 = lstm_step_fused(
        x.reshape(-1, x.shape[-1]), h.reshape(-1, h.shape[-1]),
        c.reshape(-1, c.shape[-1]), w['kernel'], w['recurrent_kernel'],
        w['bias'])
    return h2.reshape(lead + h2.shape[-1:]), c2.reshape(lead + c2.shape[-1:])
