"""K6 and K7: the teacher-forced top decoder layer over all decoder steps
and its reverse sweep as CUDA kernels (``csrc/teacher_scan.cu``,
``csrc/teacher_bwd.cu``), joined by ``TeacherTopFused``.

Replace the JAX package's Pallas kernels ``ops/pallas_teacher.py:
_fwd_kernel`` (K6) and ``_b1_kernel`` (K7), their ``custom_vjp``
(``teacher_top_fused``) and ``teacher_fused_supported``. The forward
runs all Td steps of the top layer: additive attention energies against
the precomputed ``u``, masked to the window ``|t0 - i| <= ww`` around
the expected source position of the carried alignment and, where the
model masks padding, to the encoder's valid positions, float32 softmax
and context, the per-gate masked cell product and the Keras gates; one
C call issues its stage kernels (``FWD_STAGES``: per step the products
h.[W_a | R], the attention a block a row, the gate products with the
cell in their epilogue) on the caller's stream. The backward sweeps
time the other way from the small residuals ``hs, cs, aa, zs``, carries
(dh, dc) in float32, accumulates the ``u`` and ``attended`` gradients
and emits the stacks from which every weight gradient is one
contraction; one C call issues its stage kernels (``BWD_STAGES``: the
recomputed attention query of every step in one product, then per step
the products, the attention backward and the carry). As in the JAX
package the hoisted input projection ``zx`` and those contractions are
plain matrix products outside the kernels.

The residual ``aa`` is the dense alignment row per step, as in the JAX
package; the CUDA kernels read and write only its window (at most
``2*ww + 1`` consecutive positions, everything else is exactly 0), and
K7 finds a step's window from the first non-zero entry of ``aa[t]``.
Under a padding mask a row whose window holds no valid position gets an
all-zero ``aa[t]`` and a zero context, and the next step's window centre
is 1, as in the dense step (``ops/attention.py``); the Pallas kernels take
no padding mask, so there the JAX package runs the dense body instead.
K6 sums the window centre in the order in which the dense step's
float32 product sums it on the card (``csrc/teacher_scan.cu:
window_centre``): the window's edge is discontinuous in it.

The TPU kernels pad the batch to tiles, need ``W % 128 == 0``,
``T % 8 == 0`` and a VMEM budget. The CUDA kernels take any B, Td and T
and widths that are multiples of 8 (16-byte loads; a block keeps at most
a few floats a column of one row in shared memory, so only widths in the
tens of thousands are refused), with or without the encoder's (B, T)
padding mask, and no global attention (``ww >= 1``):
`teacher_fused_supported`.

``teacher_fwd_reference`` and ``teacher_bwd_reference`` are the plain
versions: step-by-step PyTorch transcriptions of the two Pallas bodies
(dense over T) with the same rounding points. The wrappers
``teacher_fwd`` and ``teacher_bwd`` take them for CPU tensors only; for
CUDA tensors they launch the kernels or raise.
"""

import ctypes

import torch

from . import _build
from .lstm_scan_kernel import (_DTYPE_CODES, _check, _gates, _mask_ptr,
                               _on_cpu)

F32 = torch.float32
# K6's stage kernels in the order of a step (``teacher_fwd_<stage>`` in
# csrc/teacher_scan.cu), each once a step
FWD_STAGES = ('product', 'attention', 'gates')
# K7's stage kernels in the order of a sweep (``teacher_bwd_<stage>`` in
# csrc/teacher_bwd.cu): wvec and prologue once, the other three each step
BWD_STAGES = ('wvec', 'prologue', 'product', 'attention', 'carry')


def _mm32(a, b):
    """Float32 product of the values as they are stored (exact products
    of the weight dtype's values, float32 sums, no rounding)."""
    return torch.matmul(a.to(F32), b.to(F32))


def _wvec_of(h, W_a, b_UW):
    """w_vec = r(h @ W_a) + b_UW, shared by forward and backward so the
    recomputation agrees."""
    return _mm32(h, W_a).to(h.dtype) + b_UW


def teacher_fwd_reference(zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias,
                          maskc, h0, c0, ww, enc_mask=None):
    """Plain K6. zx (Td, B, 4W) float32; u (B, T, W), att (B, T, A), Kc
    (A, 4W), R (W, 4W), W_a (W, W), v, b_UW (1, W), bias (1, 4W), maskc
    (4, B, A), h0/c0 (B, W) in the weight dtype; b_v (1, 1) float32;
    `enc_mask` None or (B, T), nonzero at the encoder's valid positions
    (a row with none in its window gets a zero alignment). Returns hs, cs
    (Td, B, W), aa (Td, B, T), zs (Td, B, 4W) in the weight dtype."""
    Td = zx.shape[0]
    T, W = u.shape[1], u.shape[2]
    dt = R.dtype
    h, c = h0, c0
    a = torch.zeros((u.shape[0], T), dtype=dt, device=u.device)
    pos = torch.arange(T, dtype=F32, device=u.device)[None]
    v_f, att_f, b_vd = v.to(F32), att.to(F32), b_v[0, 0].to(dt)
    valid = None if enc_mask is None else enc_mask.bool()
    hs, cs, aa, zs = [], [], [], []
    for t in range(Td):
        wvec = _wvec_of(h, W_a, b_UW)
        e = torch.tanh(wvec[:, None, :] + u)
        s = (e.to(F32) * v_f[None]).sum(dim=-1).to(dt) + b_vd
        t0 = (a.to(F32) * pos).sum(dim=-1, keepdim=True) + 1.0
        keep = torch.abs(t0 - pos) <= ww
        if valid is not None:
            keep = keep & valid
        sm = torch.where(keep, s.to(F32), torch.full_like(pos, -1e30))
        p = torch.exp(sm - sm.amax(dim=-1, keepdim=True))
        a = (p / p.sum(dim=-1, keepdim=True)).to(dt)
        if valid is not None:
            a = a * keep.any(dim=-1, keepdim=True).to(dt)
        ctx = (a.to(F32)[:, :, None] * att_f).sum(dim=1).to(dt)
        zc = torch.cat([_mm32((ctx * maskc[g]).to(dt),
                              Kc[:, g * W:(g + 1) * W]) for g in range(4)],
                       dim=-1)
        z = (zx[t] + zc + _mm32(h, R)).to(dt) + bias
        i, f, g_, o = _gates(z)
        c = f * c + i * g_
        h = o * torch.tanh(c)
        for stack, value in zip((hs, cs, aa, zs), (h, c, a, z)):
            stack.append(value)
    return tuple(torch.stack(stack) for stack in (hs, cs, aa, zs))


def teacher_bwd_reference(zs, g, hprev, cprev, cs, aa, u, att, Kc, R, W_a,
                          v, b_UW, maskc, ww, enc_mask=None):
    """Plain K7. g (Td, B, W): cotangent of hs in the weight dtype;
    hprev/cprev (Td, B, W): the state each step started from; the rest as
    in `teacher_fwd_reference` (`ww` only sizes the CUDA kernel's
    window; `enc_mask` zeroes da at padded positions, where aa is 0, so
    that they add nothing). Returns dz (Td, B, 4W), ds (Td, B, T), dctx (Td, B, A),
    dwvec (Td, B, W) in the weight dtype and dh0, dc0, dva (B, W), du
    (B, T, W), datt (B, T, A) in float32."""
    Td, B, W = g.shape
    dt = R.dtype
    dev = u.device
    v_f, att_f, maskc_f = v.to(F32), att.to(F32), maskc.to(F32)
    Kc_f, Rt, W_at = Kc.to(F32), R.to(F32).t(), W_a.to(F32).t()
    dh_c = torch.zeros((B, W), dtype=F32, device=dev)
    dc_c = torch.zeros((B, W), dtype=F32, device=dev)
    dva = torch.zeros((B, W), dtype=F32, device=dev)
    du = torch.zeros(u.shape, dtype=F32, device=dev)
    datt = torch.zeros(att.shape, dtype=F32, device=dev)
    dzs, dss, dctxs, dwvecs = ([None] * Td for _ in range(4))
    for t in range(Td - 1, -1, -1):
        a_f = aa[t].to(F32)
        wvec = _wvec_of(hprev[t], W_a, b_UW)
        i, f, g_, o = (x.to(F32) for x in _gates(zs[t]))
        th = torch.tanh(cs[t].to(F32))
        dh = g[t].to(F32) + dh_c
        dc = dc_c + dh * o * (1.0 - th * th)
        d_o, d_i, d_g = dh * th, dc * g_, dc * i
        d_f = dc * cprev[t].to(F32)
        dz = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                        d_g * (1.0 - g_ * g_), d_o * o * (1.0 - o)],
                       dim=-1).to(dt)
        dzs[t] = dz
        dz_f = dz.to(F32)
        dctx = sum(maskc_f[k] * torch.matmul(
            dz_f[:, k * W:(k + 1) * W], Kc_f[:, k * W:(k + 1) * W].t())
            for k in range(4))
        dctxs[t] = dctx.to(dt)
        dh_n = torch.matmul(dz_f, Rt)
        da = (att_f * dctx[:, None, :]).sum(dim=-1)
        if enc_mask is not None:
            da = da.masked_fill(~enc_mask.bool(), 0.0)
        ds = (a_f * (da - (a_f * da).sum(dim=-1, keepdim=True))).to(dt)
        dss[t] = ds
        ds3 = ds.to(F32)[:, :, None]
        e = torch.tanh(wvec[:, None, :] + u).to(F32)
        dva += (e * ds3).sum(dim=1)
        dpre = ds3 * v_f[None] * (1.0 - e * e)
        dwvec = dpre.sum(dim=1).to(dt)
        dwvecs[t] = dwvec
        du += dpre
        datt += a_f[:, :, None] * dctx[:, None, :]
        dh_c = dh_n + torch.matmul(dwvec.to(F32), W_at)
        dc_c = dc * f
    return (torch.stack(dzs), torch.stack(dss), torch.stack(dctxs),
            torch.stack(dwvecs), dh_c, dc_c, dva, du, datt)


def teacher_fwd_agreement(got, want, atol, rtol, t0_rtol):
    """Hold one K6 result (hs, cs, aa, zs) against another where the two
    can be held against each other. The layer is discontinuous in the
    window centre t0: where t0 lies within rounding of an integer, two
    correct evaluations may see different windows and part ways for the
    rest of that batch row. So every (step, row) is compared within
    `atol`/`rtol` as long as the row's windows (the non-zero patterns of
    ``aa``) have agreed so far, and a row's first disagreement must be
    explained by `want`'s t0 of that step lying within ``t0_rtol * t0``
    of an integer. Raises AssertionError otherwise. Returns (largest
    absolute difference over the compared entries, compared share of all
    (step, row) pairs)."""
    aa_g, aa_w = got[2], want[2]
    Td, B, T = aa_w.shape
    same = ((aa_g != 0) == (aa_w != 0)).all(dim=-1)        # (Td, B)
    agreed = same.to(torch.int32).cumprod(dim=0).bool()
    first = torch.zeros_like(same)
    first[0] = ~same[0]
    first[1:] = agreed[:-1] & ~same[1:]
    pos = torch.arange(T, dtype=F32, device=aa_w.device)
    t0 = torch.zeros((Td, B), dtype=F32, device=aa_w.device)
    t0[1:] = (aa_w[:-1].to(F32) * pos).sum(dim=-1)
    t0 = t0 + 1.0
    off = (t0 - torch.round(t0)).abs()
    unexplained = first & (off > t0_rtol * t0)
    if bool(unexplained.any()):
        t, b = (int(x) for x in unexplained.nonzero()[0])
        raise AssertionError(
            'windows differ at step %d, row %d, where t0 = %r is no '
            'borderline case' % (t, b, float(t0[t, b])))
    worst = 0.0
    for name, g, w in zip(('hs', 'cs', 'aa', 'zs'), got, want):
        g, w = g.to(F32), w.to(F32)
        diff = (g - w).abs() * agreed[:, :, None]
        bad = diff > atol + rtol * w.abs()
        if bool(bad.any()):
            t, b, k = (int(x) for x in bad.nonzero()[0])
            raise AssertionError(
                '%s[%d, %d, %d]: %r against %r (atol %g, rtol %g)'
                % (name, t, b, k, float(g[t, b, k]), float(w[t, b, k]),
                   atol, rtol))
        worst = max(worst, float(diff.max()))
    return worst, float(agreed.to(F32).mean())


def _cuda_device(name, tensors):
    dev = tensors[0].device
    if dev.type != 'cuda':
        raise ValueError('%s: tensors must all be on one CUDA device (or '
                         'all on the CPU)' % name)
    return dev


def teacher_fwd(zx, u, att, Kc, R, W_a, v, b_UW, b_v, bias, maskc, h0, c0,
                ww, enc_mask=None):
    """K6: hs, cs (Td, B, W), aa (Td, B, T), zs (Td, B, 4W) (see
    `teacher_fwd_reference`); on the card `enc_mask` is None or a
    contiguous (B, T) uint8 tensor."""
    low = (u, att, Kc, R, W_a, v, b_UW, bias, maskc, h0, c0)
    if _on_cpu((zx, b_v) + low):
        return teacher_fwd_reference(zx, u, att, Kc, R, W_a, v, b_UW, b_v,
                                     bias, maskc, h0, c0, ww, enc_mask)
    dt = R.dtype
    dev = _cuda_device('teacher_fwd', low)
    _check('teacher_fwd', low, dt, dev, (zx, b_v))
    Td, B, W4 = zx.shape
    W = W4 // 4
    T, A = att.shape[1], att.shape[2]
    shapes = ((u, (B, T, W)), (att, (B, T, A)), (Kc, (A, W4)), (R, (W, W4)),
              (W_a, (W, W)), (v, (1, W)), (b_UW, (1, W)), (b_v, (1, 1)),
              (bias, (1, W4)), (maskc, (4, B, A)), (h0, (B, W)),
              (c0, (B, W)))
    if any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError('teacher_fwd: inconsistent shapes')
    mask_ptr = _mask_ptr('teacher_fwd', enc_mask, dev, B, T)
    # the product stage reads the rows of [W_a | R]^T
    WR_t = torch.cat([W_a, R], dim=1).t().contiguous()
    hs = torch.empty((Td, B, W), dtype=dt, device=dev)
    cs = torch.empty((Td, B, W), dtype=dt, device=dev)
    aa = torch.empty((Td, B, T), dtype=dt, device=dev)
    zs = torch.empty((Td, B, W4), dtype=dt, device=dev)
    # scratch: one step's wvec, h.R and masked contexts, and each row's
    # window centre for the next step
    wv = torch.empty((B, W), dtype=dt, device=dev)
    zr = torch.empty((B, W4), dtype=F32, device=dev)
    cg = torch.empty((4, B, A), dtype=dt, device=dev)
    win = torch.empty((B,), dtype=F32, device=dev)
    ins = (zx, u, att, Kc, WR_t, v, b_UW, b_v, bias, maskc, h0, c0)
    outs = (hs, cs, aa, zs)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * (len(outs) + 4))(
        *(t.data_ptr() for t in outs + (wv, zr, cg, win)))
    err = _build.library().teacher_fwd_launch(
        _DTYPE_CODES[dt], in_ptrs, out_ptrs, mask_ptr, Td, B, T, W, A,
        int(ww), _build.stream_of(zx))
    _build.check(err, 'teacher forward kernel (Td=%d B=%d T=%d W=%d A=%d '
                 'ww=%d)' % (Td, B, T, W, A, ww))
    teacher_fwd.launches += 1
    return outs


teacher_fwd.launches = 0


def teacher_bwd(zs, g, hprev, cprev, cs, aa, u, att, Kc, R, W_a, v, b_UW,
                maskc, ww, enc_mask=None):
    """K7: dz, ds, dctx, dwvec in the weight dtype and dh0, dc0, dva, du,
    datt in float32 (see `teacher_bwd_reference`). Every row of `aa`
    must be 0 outside 2*ww + 1 consecutive positions, as K6 writes it;
    `enc_mask` is K6's."""
    tensors = (zs, g, hprev, cprev, cs, aa, u, att, Kc, R, W_a, v, b_UW,
               maskc)
    if _on_cpu(tensors):
        return teacher_bwd_reference(*tensors, ww, enc_mask)
    dt = R.dtype
    dev = _cuda_device('teacher_bwd', tensors)
    _check('teacher_bwd', tensors, dt, dev)
    Td, B, W = g.shape
    W4 = 4 * W
    T, A = att.shape[1], att.shape[2]
    shapes = ((zs, (Td, B, W4)), (hprev, (Td, B, W)), (cprev, (Td, B, W)),
              (cs, (Td, B, W)), (aa, (Td, B, T)), (u, (B, T, W)),
              (Kc, (A, W4)), (R, (W, W4)), (W_a, (W, W)), (v, (1, W)),
              (b_UW, (1, W)), (maskc, (4, B, A)))
    if any(tuple(t.shape) != s for t, s in shapes):
        raise ValueError('teacher_bwd: inconsistent shapes')
    mask_ptr = _mask_ptr('teacher_bwd', enc_mask, dev, B, T)
    # the wvec stage reads W_a^T's rows; the other products read Kc, R and
    # W_a as they are
    W_aT = W_a.t().contiguous()
    dz = torch.empty((Td, B, W4), dtype=dt, device=dev)
    ds = torch.empty((Td, B, T), dtype=dt, device=dev)
    dctx = torch.empty((Td, B, A), dtype=dt, device=dev)
    dwvec = torch.empty((Td, B, W), dtype=dt, device=dev)
    dh0, dc0, dva = (torch.empty((B, W), dtype=F32, device=dev)
                     for _ in range(3))
    # read-modify-written by the kernel
    du = torch.zeros((B, T, W), dtype=F32, device=dev)
    datt = torch.zeros((B, T, A), dtype=F32, device=dev)
    # scratch: wvec of every step, and one step's products per gate
    wv = torch.empty((Td, B, W), dtype=dt, device=dev)
    part = torch.empty((4, B, A + W), dtype=F32, device=dev)
    ins = (zs, g, hprev, cprev, cs, aa, u, att, Kc, R, W_a, W_aT, v, b_UW,
           maskc)
    outs = (dz, ds, dctx, dwvec, dh0, dc0, dva, du, datt)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * (len(outs) + 2))(
        *(t.data_ptr() for t in outs + (wv, part)))
    err = _build.library().teacher_bwd_launch(
        _DTYPE_CODES[dt], in_ptrs, out_ptrs, mask_ptr, Td, B, T, W, A,
        int(ww), _build.stream_of(zs))
    _build.check(err, 'teacher backward kernel (Td=%d B=%d T=%d W=%d A=%d '
                 'ww=%d)' % (Td, B, T, W, A, ww))
    teacher_bwd.launches += 1
    return outs


teacher_bwd.launches = 0


def _prep(v_a, b_UW, b_v, K, bias, masks, B, W, A, dt, dev):
    """Shared operand preparation: split K, shape the small operands."""
    K_x, K_ctx = K[:W].to(dt), K[W:].to(dt).contiguous()
    v_row = v_a[:, 0][None].to(dt).contiguous()
    b_UW = b_UW[None].to(dt)
    b_v = b_v.reshape(1, 1).to(F32)
    bias = bias[None].to(dt)
    if masks is None:
        mask_x = None
        maskc = torch.ones((4, B, A), dtype=dt, device=dev)
    else:
        mask_x = masks[:, :, :W].to(dt)
        maskc = masks[:, :, W:].to(dt).contiguous()
    return K_x, K_ctx, v_row, b_UW, b_v, bias, mask_x, maskc


def _zx_of(xs, mask_x, K_x, W, dt):
    """Hoisted per-gate input preactivations (Td, B, 4W) float32: one
    matrix product per gate over all timesteps (the masks are constant
    over time); without masks the four gates share one product."""
    if mask_x is None:
        zx = _mm32(xs.to(dt), K_x)
    else:
        zx = torch.cat(
            [_mm32((xs * mask_x[g][:, None, :]).to(dt),
                   K_x[:, g * W:(g + 1) * W]) for g in range(4)], dim=-1)
    return zx.transpose(0, 1).contiguous()


class TeacherTopFused(torch.autograd.Function):
    """(top leaves, xs, attended, u, h0, c0, masks, ww, enc_mask) -> hs
    (B, Td, W), differentiable through K6 and K7 (their plain versions for
    CPU tensors): gradients for every leaf of the top layer, xs, attended,
    u, h0 and c0, none for masks and enc_mask (None or (B, T) uint8)."""

    @staticmethod
    def forward(ctx, W_a, v_a, b_UW, b_v, K, R, bias, xs, attended, u, h0,
                c0, masks, ww, enc_mask):
        B, Td, W = xs.shape
        A = attended.shape[2]
        dt = R.dtype
        K_x, K_ctx, v_row, b_UW2, b_v2, bias2, mask_x, maskc = _prep(
            v_a, b_UW, b_v, K, bias, masks, B, W, A, dt, xs.device)
        zx = _zx_of(xs, mask_x, K_x, W, dt)
        hs, cs, aa, zs = teacher_fwd(
            zx, u.to(dt).contiguous(), attended.to(dt).contiguous(), K_ctx,
            R.contiguous(), W_a.to(dt).contiguous(), v_row, b_UW2, b_v2,
            bias2, maskc, h0.to(dt).contiguous(), c0.to(dt).contiguous(), ww,
            enc_mask)
        ctx.save_for_backward(W_a, v_a, b_UW, b_v, K, R, bias, xs, attended,
                              u, h0, c0, masks, enc_mask, hs, cs, aa, zs)
        ctx.ww = ww
        return hs.transpose(0, 1)

    @staticmethod
    def backward(ctx, g_out):
        (W_a, v_a, b_UW, b_v, K, R, bias, xs, attended, u, h0, c0, masks,
         enc_mask, hs, cs, aa, zs) = ctx.saved_tensors
        B, Td, W = xs.shape
        T, A = attended.shape[1], attended.shape[2]
        dt = R.dtype
        K_x, K_ctx, v_row, b_UW2, _, _, mask_x, maskc = _prep(
            v_a, b_UW, b_v, K, bias, masks, B, W, A, dt, xs.device)
        hprev = torch.cat([h0.to(dt)[None], hs[:-1]], dim=0)
        cprev = torch.cat([c0.to(dt)[None], cs[:-1]], dim=0)
        g_t = g_out.transpose(0, 1).to(dt).contiguous()
        att_d = attended.to(dt).contiguous()
        dz_t, ds_t, dctx_t, dwvec_t, dh0, dc0, dva, du, datt = teacher_bwd(
            zs, g_t, hprev, cprev, cs, aa, u.to(dt).contiguous(), att_d,
            K_ctx, R.contiguous(), W_a.to(dt).contiguous(), v_row, b_UW2,
            maskc, ctx.ww, enc_mask)
        # ---- weight gradients: whole-sequence contractions, float32
        # ---- accumulation, each result rounded once to its leaf's dtype
        # ---- (a product of weight-dtype tensors does exactly that); aa
        # ---- is 0 at padded positions, so none needs the padding mask
        n = Td * B
        dz_b = dz_t.transpose(0, 1)                        # (B, Td, 4W)
        xs_d = xs.to(dt)
        # the context sequence again, as one batched product
        ctx_all = torch.matmul(aa.transpose(0, 1), att_d).transpose(0, 1)
        if mask_x is None:
            dxs = torch.matmul(dz_b, K_x.t())
            cell_in = torch.cat([xs_d.transpose(0, 1), ctx_all], dim=-1)
            dK = torch.matmul(cell_in.reshape(n, W + A).t(),
                              dz_t.reshape(n, 4 * W))
        else:
            dxs = sum(_mm32(dz_b[..., g * W:(g + 1) * W],
                            K_x[:, g * W:(g + 1) * W].t())
                      * mask_x[g][:, None, :].to(F32) for g in range(4))
            parts = []
            for g in range(4):
                dz_g = dz_t[..., g * W:(g + 1) * W].reshape(n, W)
                xg = (xs * mask_x[g][:, None, :]).to(dt).transpose(0, 1)
                cg = (ctx_all * maskc[g][None]).to(dt)
                parts.append(torch.cat(
                    [torch.matmul(xg.reshape(n, W).t(), dz_g),
                     torch.matmul(cg.reshape(n, A).t(), dz_g)], dim=0))
            dK = torch.cat(parts, dim=1)
        hp = hprev.reshape(n, W).t()
        dR = torch.matmul(hp, dz_t.reshape(n, 4 * W))
        dW_a = torch.matmul(hp, dwvec_t.reshape(n, W))
        dbias = dz_t.sum(dim=(0, 1), dtype=F32)
        db_UW = dwvec_t.sum(dim=(0, 1), dtype=F32)
        db_v = ds_t.sum(dtype=F32)
        return (dW_a.to(W_a.dtype), dva.sum(dim=0)[:, None].to(v_a.dtype),
                db_UW.to(b_UW.dtype), db_v[None].to(b_v.dtype),
                dK.to(K.dtype), dR.to(R.dtype), dbias.to(bias.dtype),
                dxs.to(xs.dtype), datt.to(attended.dtype), du.to(u.dtype),
                dh0.to(h0.dtype), dc0.to(c0.dtype), None, None, None)


def teacher_top_fused(top, xs, attended, u, h0, c0, masks, ww,
                      enc_mask=None):
    """Fused teacher-forced top scan: hs (B, Td, W) from the top layer's
    parameters `top` (W_a, v_a, b_UW, b_v, cell{kernel, recurrent_kernel,
    bias}), the lower stack's activations xs (B, Td, W), attended
    (B, T, A), u (B, T, W), h0/c0 (B, W), `masks` (4, B, W+A)
    variational dropout multipliers or None, and `enc_mask` (B, T), true
    at the encoder's valid positions, or None."""
    cell = top['cell']
    if enc_mask is not None:
        enc_mask = enc_mask.to(torch.uint8).contiguous()
    return TeacherTopFused.apply(
        top['W_a'], top['v_a'], top['b_UW'], top['b_v'], cell['kernel'],
        cell['recurrent_kernel'], cell['bias'], xs, attended, u, h0, c0,
        masks, int(ww), enc_mask)


def teacher_top_fused_sharded(top, xs, attended, u, h0, c0, masks, ww,
                              mesh, enc_mask=None):
    """`teacher_top_fused` per data shard of `mesh`, under the JAX
    package's name. The port's tensors already are the rank's rows and
    `top` the full top layer: `models.train.train_step` gathers the
    weights over 'model' and sums their gradients over 'data' once a
    step, so the launch is `teacher_top_fused`'s, on the rank's rows of
    `enc_mask`."""
    return teacher_top_fused(top, xs, attended, u, h0, c0, masks, ww,
                             enc_mask)


def teacher_fused_supported(top, B, Td, T, W, A, ww=5, mesh=None):
    """Whether `teacher_top_fused` launches the CUDA kernels for this
    top layer: float32 or bfloat16 weights on a CUDA device, a local
    window (ww >= 1), widths that are multiples of 8, with or without a
    padding mask. Any B, Td and T; the residual and gradient stacks and
    the sweeps' scratch live in device memory. (CPU tensors run the plain
    versions, which take any shape.)

    Under a `mesh` the kernels run per data shard
    (`teacher_top_fused_sharded`): `B` counts the rows of the call, which
    are the rank's own (the port's tensors are local), and the weights
    must live on the mesh's device; `W` and `A` are the full widths."""
    rk = top['cell']['recurrent_kernel']
    if rk.device.type != 'cuda' or rk.dtype not in _DTYPE_CODES:
        return False
    if mesh is not None and rk.device != mesh.device:
        return False
    if ww < 1 or min(B, Td, T) < 1:
        return False
    with torch.cuda.device(rk.device):
        return bool(_build.library().teacher_scan_supported(W, A, int(ww)))
