"""K4 and K5: the whole-sequence LSTM scan and its backward sweep as CUDA
kernels (``csrc/lstm_scan.cu``), joined by ``LstmScan``.

Replace the JAX package's Pallas kernels ``ops/pallas_lstm_train.py:
_fwd_kernel`` (K4) and ``_bwd_kernel`` (K5), their ``custom_vjp``
(``_scan_core``) and ``lstm_scan_fused``. One launch runs all T steps of
the recurrence ``z_t = zx_t + r(h.R)`` (r() rounds the float32 sum to the
weight dtype, gates in the weight dtype, Keras order i, f, c~, o); the
backward launch sweeps time the other way, recomputes the gates from the
saved states, carries dh and dc in float32 and emits the preactivation
gradient. As in the JAX package the input projection ``zx = mm(xs, K) +
b`` and the weight gradient ``dR = hprev^T . dzx`` are plain matrix
products outside the kernels.

The TPU kernels pad the batch to tiles of 16 rows and need ``width %
128 == 0`` and a VMEM budget. The CUDA kernels take any batch, any T >= 1
and a width that is a multiple of 8 up to ``lstm_scan_max_width()``: one
cooperative launch of row groups x unit slices, each block holding its
slice of R in shared memory for the whole sweep; the blocks of a row
group meet at a counter (``_group_counters``, zeroed per launch) once a
step. ``scan_plan`` shows how the launcher splits a sweep over the card.

Both take an optional padding mask (T, B) with the semantics of
``ops.lstm.lstm_scan(mask=)``, which the Pallas kernels lack: at a masked
step the carry passes on unchanged and the output is zero. The kernels'
hs and cs hold the carry there, so that the backward's hprev and cprev
stay views and ``dR`` one product (K5 writes dzx = 0 at a masked step);
`LstmScan` zeroes the outputs of masked steps.

``lstm_scan_fwd_reference`` and ``lstm_scan_bwd_reference`` are the
plain versions: step-by-step PyTorch transcriptions of the two Pallas
bodies with the same rounding points. The wrappers ``lstm_scan_fwd`` and
``lstm_scan_bwd`` take them for CPU tensors only; for CUDA tensors they
launch the kernels or raise.
"""

import ctypes

import torch

from . import _build
from .lstm import mm

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _sig(v):
    """The Pallas kernels' manual logistic: in bfloat16 every
    intermediate is a bfloat16 value (``torch.sigmoid`` would compute in
    float32 and round once)."""
    return 1 / (1 + torch.exp(-v))


def _gates(z):
    n = z.shape[-1] // 4
    return (_sig(z[:, :n]), _sig(z[:, n:2 * n]),
            torch.tanh(z[:, 2 * n:3 * n]), _sig(z[:, 3 * n:]))


def _steps(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def _held(mask, t):
    """(B, 1) bool: the rows whose step t is valid."""
    return mask[t, :, None].bool()


def lstm_scan_fwd_reference(zx, R, h0, c0, reverse=False, mask=None):
    """Plain K4. zx (T, B, 4N) time-major, R (N, 4N), h0/c0 (B, N), all
    in the weight dtype; `mask` None or (T, B), nonzero at valid steps.
    Returns hs, cs (T, B, N) and hT, cT (B, N); `reverse` walks time from
    T-1 down, outputs stay at their own index. At a masked step hs and cs
    hold the carry, which passes on unchanged."""
    T = zx.shape[0]
    h, c = h0, c0
    hs, cs = [None] * T, [None] * T
    for t in _steps(T, reverse):
        i, f, g, o = _gates(zx[t] + torch.matmul(h, R))
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if mask is None:
            h, c = h_new, c_new
        else:
            m = _held(mask, t)
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
        hs[t], cs[t] = h, c
    return torch.stack(hs), torch.stack(cs), h, c


def lstm_scan_bwd_reference(g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs,
                            reverse=False, mask=None):
    """Plain K5. g_hs (T, B, N), g_hT/g_cT (B, N): cotangents of hs, hT,
    cT in the weight dtype; hprev/cprev (T, B, N): the state each step
    started from. Returns dzx (T, B, 4N) in the weight dtype and dh0, dc0
    (B, N) in float32. At a step `mask` marks as padding dzx is zero,
    g_hs does not enter, and the carried dh, dc pass on unchanged."""
    T = zx.shape[0]
    dt, f32 = R.dtype, torch.float32
    dh_c, dc_c = g_hT.to(f32), g_cT.to(f32)
    Rt = R.to(f32).t()
    dzx = [None] * T
    for t in reversed(_steps(T, reverse)):
        i, f, g, o = (v.to(f32) for v in
                      _gates(zx[t] + torch.matmul(hprev[t], R)))
        th = torch.tanh(cs[t].to(f32))
        dh = g_hs[t].to(f32) + dh_c
        dc = dc_c + dh * o * (1.0 - th * th)
        d_o, d_i, d_g = dh * th, dc * g, dc * i
        d_f = dc * cprev[t].to(f32)
        dz = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                        d_g * (1.0 - g * g), d_o * o * (1.0 - o)],
                       dim=-1).to(dt)
        dh_new, dc_new = torch.matmul(dz.to(f32), Rt), dc * f
        if mask is None:
            dh_c, dc_c = dh_new, dc_new
        else:
            m = _held(mask, t)
            dz = torch.where(m, dz, torch.zeros_like(dz))
            dh_c = torch.where(m, dh_new, dh_c)
            dc_c = torch.where(m, dc_new, dc_c)
        dzx[t] = dz
    return torch.stack(dzx), dh_c, dc_c


def _check(name, tensors, dt, dev, f32_tensors=()):
    """Raise unless every tensor is contiguous, 16-byte aligned, on `dev`
    and of dtype `dt` (float32 for `f32_tensors`)."""
    if dt not in _DTYPE_CODES:
        raise ValueError('%s: float32 or bfloat16 expected, got %s'
                         % (name, dt))
    for group, want in ((tensors, dt), (f32_tensors, torch.float32)):
        for t in group:
            if t.device != dev or t.dtype != want \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError('%s: contiguous, 16-byte aligned %s '
                                 'tensors on %s expected'
                                 % (name, want, dev))


def _mask_ptr(name, mask, dev, *shape):
    """The launchers' mask argument: None, or the address of a contiguous
    uint8 tensor of `shape` on `dev`."""
    if mask is None:
        return None
    if mask.device != dev or mask.dtype != torch.uint8 \
            or mask.shape != shape or not mask.is_contiguous():
        raise ValueError('%s: a contiguous uint8 mask of shape %s on %s '
                         'expected' % (name, shape, dev))
    return mask.data_ptr()


def _on_cpu(tensors):
    return all(t.device.type == 'cpu' for t in tensors)


def lstm_scan_max_width():
    """The widest layer the CUDA kernels take."""
    return _build.library().lstm_scan_max_width()


_PLAN_KEYS = ('groups', 'slices', 'rows_per_group', 'units_per_slice',
              'chunk', 'resident', 'smem_bytes', 'launches')


def scan_plan(kind, dtype, B, N, rows_per_group=0, units_per_slice=0):
    """How the launcher splits a sweep over the card (kind 'fwd': K4,
    'bwd': K5): row groups and unit slices of one cooperative launch, their
    sizes, the reduction chunk, what of R stays in shared memory (bit 0:
    the gate columns, bit 1: the rows), shared memory per block and the
    launches over the batch. `rows_per_group`/`units_per_slice` impose
    them, as the tests do."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _build.library().lstm_scan_plan(
        ('fwd', 'bwd').index(kind), _DTYPE_CODES[dtype], B, N,
        rows_per_group, units_per_slice, out)
    _build.check(err, 'lstm_scan plan (B=%d N=%d)' % (B, N))
    return dict(zip(_PLAN_KEYS, out))


def _group_counters(B, dev):
    """The kernels' barrier: one zeroed counter per possible row group
    (a group holds at least 16 rows)."""
    return torch.zeros(-(-B // 16), dtype=torch.int32, device=dev)


def _views(buf, reverse):
    """(hs, hprev) of a (T+1, B, N) buffer that holds a sweep's states and,
    at the end the sweep starts from, its initial state."""
    return (buf[:-1], buf[1:]) if reverse else (buf[1:], buf[:-1])


def _scan_fwd(zx, R, h0, c0, reverse, mask=None, rows_per_group=0,
              units_per_slice=0):
    """K4 with hs and cs written into (T+1, B, N) buffers whose other slot
    holds h0, c0, so that the backward's hprev and cprev are views, not
    copies. Returns hbuf, cbuf, hT, cT."""
    tensors = (zx, R, h0, c0)
    if _on_cpu(tensors):
        hs, cs, hT, cT = lstm_scan_fwd_reference(zx, R, h0, c0, reverse,
                                                 mask)
        ends = (lambda s, s0: torch.cat([s, s0[None]]) if reverse
                else torch.cat([s0[None], s]))
        return ends(hs, h0), ends(cs, c0), hT, cT
    dt, dev = R.dtype, R.device
    if dev.type != 'cuda':
        raise ValueError('lstm_scan_fwd: tensors must all be on one CUDA '
                         'device (or all on the CPU)')
    _check('lstm_scan_fwd', tensors, dt, dev)
    T, B, N4 = zx.shape
    N = N4 // 4
    if R.shape != (N, N4) or h0.shape != (B, N) or c0.shape != (B, N):
        raise ValueError('lstm_scan_fwd: inconsistent shapes')
    hbuf = torch.empty((T + 1, B, N), dtype=dt, device=dev)
    cbuf = torch.empty((T + 1, B, N), dtype=dt, device=dev)
    start = T if reverse else 0
    hbuf[start].copy_(h0)
    cbuf[start].copy_(c0)
    hs, cs = _views(hbuf, reverse)[0], _views(cbuf, reverse)[0]
    hT = torch.empty((B, N), dtype=dt, device=dev)
    cT = torch.empty((B, N), dtype=dt, device=dev)
    err = _build.library().lstm_scan_fwd_launch(
        _DTYPE_CODES[dt], *(t.data_ptr() for t in tensors),
        _mask_ptr('lstm_scan_fwd', mask, dev, T, B), hs.data_ptr(),
        cs.data_ptr(), hT.data_ptr(), cT.data_ptr(),
        _group_counters(B, dev).data_ptr(), T, B, N, int(reverse),
        rows_per_group, units_per_slice, _build.stream_of(zx))
    _build.check(err, 'lstm_scan forward kernel (T=%d B=%d N=%d)'
                 % (T, B, N))
    lstm_scan_fwd.launches += 1
    return hbuf, cbuf, hT, cT


def lstm_scan_fwd(zx, R, h0, c0, reverse=False, mask=None):
    """K4: hs, cs (T, B, N), hT, cT (B, N) from zx (T, B, 4N), R (N, 4N)
    and h0/c0 (B, N) of one dtype on one device; `mask` None or (T, B)
    uint8 (see `lstm_scan_fwd_reference`)."""
    if _on_cpu((zx, R, h0, c0)):
        return lstm_scan_fwd_reference(zx, R, h0, c0, reverse, mask)
    hbuf, cbuf, hT, cT = _scan_fwd(zx, R, h0, c0, reverse, mask)
    return _views(hbuf, reverse)[0], _views(cbuf, reverse)[0], hT, cT


lstm_scan_fwd.launches = 0


def lstm_scan_bwd(g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs, reverse=False,
                  mask=None):
    """K5: dzx (T, B, 4N) in the weight dtype and dh0, dc0 (B, N) in
    float32 (see `lstm_scan_bwd_reference`)."""
    tensors = (g_hs, g_hT, g_cT, zx, R, hprev, cprev, cs)
    if _on_cpu(tensors):
        return lstm_scan_bwd_reference(g_hs, g_hT, g_cT, zx, R, hprev,
                                       cprev, cs, reverse, mask)
    dt, dev = R.dtype, R.device
    if dev.type != 'cuda':
        raise ValueError('lstm_scan_bwd: tensors must all be on one CUDA '
                         'device (or all on the CPU)')
    _check('lstm_scan_bwd', tensors, dt, dev)
    T, B, N4 = zx.shape
    N = N4 // 4
    if R.shape != (N, N4) or any(t.shape != (T, B, N) for t in
                                 (g_hs, hprev, cprev, cs)) \
            or g_hT.shape != (B, N) or g_cT.shape != (B, N):
        raise ValueError('lstm_scan_bwd: inconsistent shapes')
    dzx = torch.empty((T, B, N4), dtype=dt, device=dev)
    dh0 = torch.empty((B, N), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = _build.library().lstm_scan_bwd_launch(
        _DTYPE_CODES[dt], *(t.data_ptr() for t in tensors),
        _mask_ptr('lstm_scan_bwd', mask, dev, T, B), dzx.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), _group_counters(B, dev).data_ptr(),
        T, B, N, int(reverse), 0, 0, _build.stream_of(zx))
    _build.check(err, 'lstm_scan backward kernel (T=%d B=%d N=%d)'
                 % (T, B, N))
    lstm_scan_bwd.launches += 1
    return dzx, dh0, dc0


lstm_scan_bwd.launches = 0


class LstmScan(torch.autograd.Function):
    """(zx, R, h0, c0, reverse, mask) -> (hs, hT, cT), differentiable
    through K4 and K5 (their plain versions for CPU tensors). The cell
    states are saved for the backward and not an output (JAX
    ``_scan_core``); hs and cs are saved with the initial state beside
    them, so that the state each step started from is a view. With a
    (T, B) uint8 `mask` the returned hs is zero at masked steps."""

    @staticmethod
    def forward(ctx, zx, R, h0, c0, reverse, mask):
        hbuf, cbuf, hT, cT = _scan_fwd(zx, R, h0, c0, reverse, mask)
        ctx.save_for_backward(zx, R, hbuf, cbuf, mask)
        ctx.reverse = reverse
        hs = _views(hbuf, reverse)[0]
        if mask is not None:
            hs = hs.masked_fill(mask[..., None] == 0, 0)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, g_hs, g_hT, g_cT):
        zx, R, hbuf, cbuf, mask = ctx.saved_tensors
        reverse = ctx.reverse
        T, B, N4 = zx.shape
        dt = R.dtype
        hs, hprev = _views(hbuf, reverse)
        cs, cprev = _views(cbuf, reverse)

        def cot(g, like):
            return (torch.zeros_like(like) if g is None
                    else g.to(dt).contiguous())

        dzx, dh0, dc0 = lstm_scan_bwd(
            cot(g_hs, hs), cot(g_hT, hs[0]), cot(g_cT, cs[0]), zx, R, hprev,
            cprev, cs, reverse, mask)
        # the weight gradient as one product over all T*B rows, float32
        # accumulation rounded to the weight dtype
        dR = torch.matmul(hprev.reshape(T * B, -1).t(),
                          dzx.reshape(T * B, N4))
        return dzx, dR, dh0.to(dt), dc0.to(dt), None, None


def fused_scan_supported(w, batch=None, mesh=None):
    """Whether `lstm_scan_fused` launches the CUDA kernels for these LSTM
    weights: float32 or bfloat16 on a CUDA device, width a multiple of 8
    within the kernels' shared-memory scratch, and at least one row in
    `batch` where it is given. (CPU tensors run the plain versions, which
    take any shape.)

    Under a `mesh` the launch runs per data shard, as in the JAX package,
    and `batch` counts the rows of the call, which are the rank's own:
    the port's tensors are local, where the JAX package's test divides a
    global batch by the data axis."""
    rk = w['recurrent_kernel']
    if rk.device.type != 'cuda' or rk.dtype not in _DTYPE_CODES:
        return False
    if mesh is not None and rk.device != mesh.device:
        return False
    N = rk.shape[0]
    return (N % 8 == 0 and N <= lstm_scan_max_width()
            and (batch is None or batch >= 1))


def lstm_scan_fused(xs, w, h0=None, c0=None, reverse=False, mask=None,
                    mesh=None):
    """Drop-in for ``ops.lstm.lstm_scan`` through `LstmScan`: xs (B, T, D)
    -> (outputs (B, T, N), hT, cT); `mask` (B, T), true at valid steps,
    as there.

    `mesh` is the JAX package's argument: there the launch runs per data
    shard under ``shard_map``. Here xs, h0 and c0 already are the rank's
    rows and `w` the full weights (`models.train.train_step` gathers
    them over 'model' and sums their gradients over 'data' once a step),
    so the launch is the same with or without it.

    Where no input needs a gradient (serving) it calls K4 outside
    `LstmScan`, saves nothing for a backward and zeroes the outputs of
    masked steps in place."""
    rk = w['recurrent_kernel']
    B = xs.shape[0]
    N, dt = rk.shape[0], rk.dtype
    h = (torch.zeros((B, N), dtype=dt, device=xs.device) if h0 is None
         else h0.to(dt).contiguous())
    c = (torch.zeros((B, N), dtype=dt, device=xs.device) if c0 is None
         else c0.to(dt).contiguous())
    zx = mm(xs, w['kernel']) + w['bias']
    if mask is not None:
        mask = mask.t().to(torch.uint8).contiguous()
    args = (zx.transpose(0, 1).contiguous(), rk.contiguous(), h, c,
            bool(reverse), mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:4]):
        hs, hT, cT = LstmScan.apply(*args)
    else:
        hbuf, _, hT, cT = _scan_fwd(*args)
        hs = _views(hbuf, reverse)[0]
        if mask is not None:
            hs.masked_fill_(mask[..., None] == 0, 0)
    return hs.transpose(0, 1), hT, cT
