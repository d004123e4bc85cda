"""Teacher-forced top-decoder scan with a hand-written backward.

Port of the JAX package's ``models/teacher_scan.py`` (its
``custom_vjp`` becomes `TeacherTopScan`, a ``torch.autograd.Function``).
Plain PyTorch: the JAX module holds no Pallas kernel. Autograd through
the windowed top scan would keep every step's gathered windows and
scatter each step's window cotangent into full (B, T, W) buffers; this
module instead

- runs the forward as a plain loop (per-step windowed additive attention
  + the top LSTM cell, the same math as ``seq2seq._decode_teacher``'s
  windowed body), saving small residuals: the h/c sequences, the
  (B, WIN) alignment windows and their start offsets;
- runs the backward as one reverse loop that recomputes the cheap
  per-step elementwise work (gates, window energies) from the residuals
  and collects the per-step window cotangents in stacks; the (B, T, W)
  gradients of ``u``/``attended`` are then built by a few chunked
  scatter-adds over the stacks after the loop, and every weight gradient
  is one contraction over all steps at once (dR = hprev^T . dZ etc.).

The alignment-state chain contributes no gradient in the dense and the
windowed autograd paths either (the previous alignment only enters
through the discontinuous window mask and the integer window start), so
the manual backward matches autograd on that front.

Mixed-precision rounding mirrors ``seq2seq._decode_teacher``: per-product
float32 accumulation rounded to the weight dtype (``ops.lstm.mm``)
without dropout masks; one float32 accumulation rounded once on the
masked-gate path.
"""

import torch

from ..ops.attention import NEG, softmax
from ..ops.lstm import attention_cell_preact, gate_math, mm

F32 = torch.float32


def _win_ix(astart, WIN, T):
    return torch.clamp(astart[:, None].long()
                       + torch.arange(WIN, device=astart.device), max=T - 1)


def _window_start(aw, astart, ww, WIN, T):
    """(t0 float32, new_start int32) from the carried window state."""
    offs = torch.arange(WIN, dtype=F32, device=aw.device)
    t0 = (aw.to(F32) * (astart[:, None].to(F32) + offs)).sum(dim=-1) + 1.0
    new_start = torch.clamp(torch.floor(t0).to(torch.int32) - ww, 0,
                            max(T - WIN, 0))
    return t0, new_start


def _align(s_en, visible, rows_att):
    """Masked softmax (all-masked rows zeroed) and the float32 context."""
    a = softmax(torch.where(visible, s_en, torch.full_like(s_en, NEG)),
                dim=-1)
    a = a * visible.any(dim=-1, keepdim=True).to(a.dtype)
    ctx = (a.to(F32)[:, :, None] * rows_att.to(F32)).sum(dim=1)
    return ctx, a


def _attention_fwd(top, h, aw, astart, attended, u, ww, WIN, enc_mask):
    """One windowed attention step (gather form; the same visible set as
    ``seq2seq._windowed_attention``'s gather branch, step for step: t0 in
    float32, start clipped to [0, T-WIN], -1e30 mask, all-masked rows
    zeroed, float32 context). Returns (ctx float32, a, new_start)."""
    B, T, A = attended.shape
    t0, new_start = _window_start(aw, astart, ww, WIN, T)
    win_ix = _win_ix(new_start, WIN, T)
    rows = torch.arange(B, device=u.device)[:, None]
    w_vec = mm(h, top['W_a']) + top['b_UW']
    e = torch.tanh(w_vec[:, None, :] + u[rows, win_ix])
    s_en = mm(e, top['v_a'])[..., 0] + top['b_v']
    visible = torch.abs(t0[:, None] - win_ix.to(F32)) <= ww
    if enc_mask is not None:
        visible = visible & (enc_mask[rows, win_ix] > 0)
    ctx, a = _align(s_en, visible, attended[rows, win_ix])
    return ctx, a, new_start


def _attention_fwd_dense(top, h, aw, astart, attended, u, ww, WIN,
                         enc_mask):
    """One windowed attention step computed densely: full-T energies (no
    gathers), the window mask from the carried (aw, astart) state, and
    the result re-windowed into the same carry the gather form produces.
    The visible set and the per-element math are those of
    `_attention_fwd`, so the reverse sweep recomputes the same windowed
    intermediates from the same residuals whichever forward ran.
    Returns (ctx float32, aw_new, new_start)."""
    B, T, A = attended.shape
    t0, new_start = _window_start(aw, astart, ww, WIN, T)
    w_vec = mm(h, top['W_a']) + top['b_UW']
    e = torch.tanh(w_vec[:, None, :] + u)                  # (B, T, W)
    s_en = mm(e, top['v_a'])[..., 0] + top['b_v']          # (B, T)
    pos = torch.arange(T, dtype=F32, device=u.device)
    visible = torch.abs(t0[:, None] - pos[None, :]) <= ww
    if enc_mask is not None:
        visible = visible & (enc_mask > 0)
    ctx, a = _align(s_en, visible, attended)
    return ctx, torch.gather(a, 1, _win_ix(new_start, WIN, T)), new_start


def _fwd_scan(top, xs, attended, u, h0, c0, enc_mask, masks, ww, WIN,
              dense=False):
    """Returns (hs, cs, aws, astarts) stacked time-major. `dense` selects
    the dense attention forward (same visible set and residual format as
    the gather form)."""
    B, Td = xs.shape[:2]
    aw = torch.zeros((B, WIN), dtype=attended.dtype, device=xs.device)
    astart = torch.zeros((B,), dtype=torch.int32, device=xs.device)
    att_step = _attention_fwd_dense if dense else _attention_fwd
    h, c = h0, c0
    hs, cs, aws, astarts = [], [], [], []
    for t in range(Td):
        x_t = xs[:, t]
        ctx, aw, astart = att_step(top, h, aw, astart, attended, u, ww,
                                   WIN, enc_mask)
        cell_in = torch.cat([x_t, ctx.to(x_t.dtype)], dim=-1)
        h, c = gate_math(
            attention_cell_preact(top['cell'], cell_in, h, masks), c)
        for stack, value in zip((hs, cs, aws, astarts),
                                (h, c, aw, astart)):
            stack.append(value)
    return tuple(torch.stack(s) for s in (hs, cs, aws, astarts))


def _mm32_t(a, w):
    """a . w^T with float32 accumulation, kept in float32."""
    return torch.matmul(a.to(F32), w.to(F32).t())


class TeacherTopScan(torch.autograd.Function):
    """(top leaves, xs, attended, u, h0, c0, enc_mask, masks, ww, WIN,
    dense) -> hs (B, Td, W); see `teacher_top_scan`."""

    @staticmethod
    def forward(ctx, W_a, v_a, b_UW, b_v, K, R, bias, xs, attended, u, h0,
                c0, enc_mask, masks, ww, WIN, dense):
        top = _top_of(W_a, v_a, b_UW, b_v, K, R, bias)
        hs, cs, aws, astarts = _fwd_scan(top, xs, attended, u, h0, c0,
                                         enc_mask, masks, ww, WIN, dense)
        ctx.save_for_backward(W_a, v_a, b_UW, b_v, K, R, bias, xs, attended,
                              u, h0, c0, masks, hs, cs, aws, astarts)
        ctx.WIN = WIN
        return hs.transpose(0, 1)

    @staticmethod
    def backward(ctx, g_out):
        (W_a, v_a, b_UW, b_v, K, R, bias, xs, attended, u, h0, c0, masks,
         hs, cs, aws, astarts) = ctx.saved_tensors
        WIN = ctx.WIN
        top = _top_of(W_a, v_a, b_UW, b_v, K, R, bias)
        B, T, A = attended.shape
        Td, W = xs.shape[1], R.shape[0]
        kdt, dev = K.dtype, xs.device
        xs_t = xs.transpose(0, 1)                          # (Td, B, W)
        g_t = g_out.transpose(0, 1).to(F32)
        hprev = torch.cat([h0[None], hs[:-1]], dim=0)
        cprev = torch.cat([c0[None], cs[:-1]], dim=0)
        rows = torch.arange(B, device=dev)[:, None]
        v_f = v_a[:, 0].to(F32)
        masks_f = None if masks is None else masks.to(F32)
        dh = torch.zeros((B, W), dtype=F32, device=dev)
        dc = torch.zeros((B, W), dtype=F32, device=dev)
        dv_a = torch.zeros((W,), dtype=F32, device=dev)
        db_v = torch.zeros((), dtype=F32, device=dev)
        names = ('dxs', 'dz', 'dwvec', 'duw', 'dattw', 'winix', 'ctx')
        stacks = {k: [None] * Td for k in names}
        for t in range(Td - 1, -1, -1):
            h_p, x_t = hprev[t], xs_t[t]
            # ---- recompute the forward step's cheap intermediates ----
            win_ix = _win_ix(astarts[t], WIN, T)
            att_w = attended[rows, win_ix].to(F32)
            w_vec = mm(h_p, W_a) + b_UW
            e = torch.tanh(w_vec[:, None, :] + u[rows, win_ix]).to(F32)
            a_f = aws[t].to(F32)
            ctx_t = (a_f[:, :, None] * att_w).sum(dim=1)
            cell_in = torch.cat([x_t, ctx_t.to(x_t.dtype)], dim=-1)
            z = attention_cell_preact(top['cell'], cell_in, h_p, masks)
            i = torch.sigmoid(z[:, :W]).to(F32)
            f = torch.sigmoid(z[:, W:2 * W]).to(F32)
            gg = torch.tanh(z[:, 2 * W:3 * W]).to(F32)
            o = torch.sigmoid(z[:, 3 * W:]).to(F32)
            th = torch.tanh(cs[t].to(F32))
            # ---- LSTM cell backward ----------------------------------
            dh_tot = g_t[t] + dh
            dcc = dc + dh_tot * o * (1.0 - th * th)
            d_o, d_i, d_g = dh_tot * th, dcc * gg, dcc * i
            d_f = dcc * cprev[t].to(F32)
            dz = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                            d_g * (1.0 - gg * gg), d_o * o * (1.0 - o)],
                           dim=-1)
            dc = dcc * f
            dz_w = dz.to(kdt)
            dh = _mm32_t(dz_w, R)
            if masks is not None:
                dcell_in = sum(
                    masks_f[g] * _mm32_t(dz_w[:, g * W:(g + 1) * W],
                                         K[:, g * W:(g + 1) * W])
                    for g in range(4))
            else:
                dcell_in = _mm32_t(dz_w, K)
            dctx = dcell_in[:, W:]
            # ---- attention backward ----------------------------------
            da = torch.einsum('ba,bwa->bw', dctx, att_w)
            ds = a_f * (da - (a_f * da).sum(dim=-1, keepdim=True))
            dv_a = dv_a + torch.einsum('bwk,bw->k', e, ds)
            db_v = db_v + ds.sum()
            dpre = ds[:, :, None] * v_f[None, None, :] * (1.0 - e ** 2)
            dwvec = dpre.sum(dim=1)                        # (B, W)
            dh = dh + _mm32_t(dwvec.to(W_a.dtype), W_a)
            # stacks in the weight dtype: every consumer accumulates in
            # float32 anyway
            for k, val in zip(names, (
                    dcell_in[:, :W].to(xs.dtype), dz_w, dwvec.to(kdt),
                    dpre.to(u.dtype),
                    (a_f[:, :, None] * dctx[:, None, :]).to(attended.dtype),
                    win_ix, ctx_t.to(xs.dtype))):
                stacks[k][t] = val
        dxs_t, dz_t, dwvec_t, duw_t, dattw_t, winix_t, ctx_all = (
            torch.stack(stacks[k]) for k in names)

        # ---- assemble the large gradients outside the loop ------------
        # u/attended: scatter-add the stacked window cotangents in a few
        # time chunks, so each chunk's float32 conversion is transient
        n_chunks = min(8, Td)
        bounds = [round(k * Td / n_chunks) for k in range(n_chunks + 1)]
        du = torch.zeros((B * T, W), dtype=F32, device=dev)
        datt = torch.zeros((B * T, A), dtype=F32, device=dev)
        flat_ix = rows[None] * T + winix_t                 # (Td, B, WIN)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi == lo:
                continue
            ix = flat_ix[lo:hi].reshape(-1)
            du.index_add_(0, ix, duw_t[lo:hi].to(F32).reshape(-1, W))
            datt.index_add_(0, ix, dattw_t[lo:hi].to(F32).reshape(-1, A))
        # weight gradients as whole-sequence contractions: float32
        # accumulation over the weight-dtype stacks, rounded once
        n = Td * B
        hp = hprev.reshape(n, W).t()
        dW_a = torch.matmul(hp, dwvec_t.reshape(n, W))
        dR = torch.matmul(hp, dz_t.reshape(n, 4 * W))
        db_UW = dwvec_t.sum(dim=(0, 1), dtype=F32)
        dbias = dz_t.sum(dim=(0, 1), dtype=F32)
        cell_in_t = torch.cat([xs_t, ctx_all], dim=-1)
        if masks is not None:
            dK = torch.cat(
                [torch.matmul(
                    (cell_in_t * masks[g][None].to(cell_in_t.dtype))
                    .reshape(n, W + A).t(),
                    dz_t[..., g * W:(g + 1) * W].reshape(n, W))
                 for g in range(4)], dim=-1)
        else:
            dK = torch.matmul(cell_in_t.reshape(n, W + A).t(),
                              dz_t.reshape(n, 4 * W))
        return (dW_a.to(W_a.dtype), dv_a[:, None].to(v_a.dtype),
                db_UW.to(b_UW.dtype), db_v[None].to(b_v.dtype),
                dK.to(K.dtype), dR.to(R.dtype), dbias.to(bias.dtype),
                dxs_t.transpose(0, 1).to(xs.dtype),
                datt.reshape(B, T, A).to(attended.dtype),
                du.reshape(B, T, W).to(u.dtype),
                dh.to(h0.dtype), dc.to(c0.dtype), None, None, None, None,
                None)


def _top_of(W_a, v_a, b_UW, b_v, K, R, bias):
    return {'W_a': W_a, 'v_a': v_a, 'b_UW': b_UW, 'b_v': b_v,
            'cell': {'kernel': K, 'recurrent_kernel': R, 'bias': bias}}


def teacher_top_scan(top, xs, attended, u, h0, c0, enc_mask, masks, ww,
                     WIN, dense=False):
    """Teacher-forced windowed-attention top scan.

    top: the top decoder layer's parameters (W_a, v_a, b_UW, b_v,
    cell{...}); xs (B, Td, W): lower-stack activations; attended/u
    (B, T, A/W); h0/c0 (B, W); enc_mask: float (B, T) visibility or
    None; masks: (4, B, W+A) variational dropout multipliers or None.
    `dense` selects the dense attention forward; the backward is the
    same windowed reverse sweep either way (the window mask zeroes every
    out-of-window gradient, so even the dense forward's true cotangents
    touch only WIN rows per step). Returns hs (B, Td, W)."""
    cell = top['cell']
    return TeacherTopScan.apply(
        top['W_a'], top['v_a'], top['b_UW'], top['b_v'], cell['kernel'],
        cell['recurrent_kernel'], cell['bias'], xs, attended, u, h0, c0,
        enc_mask, masks, int(ww), int(WIN), bool(dense))
