"""Local monotonic additive attention (Bahdanau with windowing).

Port of the JAX package's ``ops/attention.py`` (reference
DenseAnnotationAttention, lib/attention.py:440-621). The
state-independent half of the additive energy, u = enc_out @ A, is
precomputed once per line; per decoder step the energies are

    e_i = exp( tanh(h_prev @ W_a + b_UW + u_i) @ v_a + b_v )

masked to the local window |t0 - i| <= window_width around the expected
source position t0 = prev_alignment . arange + 1 (computed in float32),
normalized into the alignment vector a, which is both the context
weighting and the attention state carried to the next step. A row whose
every position is masked gets a zero alignment.
"""

import torch

from .lstm import mm

NEG = -1e30
# the longest bucket whose window positions 0..T-1 the bfloat16 grid holds
# exactly (8 bits of mantissa); beyond it the JAX package's bfloat16 steps
# compare positions rounded to that grid
BF16_EXACT_T = 256


def softmax(x, dim=-1):
    """``jax.nn.softmax``'s formula, in the input's dtype."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _window_center(prev_a, steps):
    """t0 = prev_a . steps + 1 in float32 (exact products of the bf16
    grid, float32 sums)."""
    return torch.matmul(prev_a.float(), steps.float()) + 1.0


def attention_step(W_a, v_a, b_UW, b_v, h_prev, prev_a, attended, u,
                   window_width=5, mask=None):
    """One attention step over the full attended length T (see
    `_attention_step`). Returns (context (B, A) float32, alignment)."""
    return _attention_step(W_a, v_a, b_UW, b_v, h_prev, prev_a, attended,
                           u, window_width, mask)


def attention_step_shared(W_a, v_a, b_UW, b_v, h_prev, prev_a, attended, u,
                          window_width=5, shared_width=32, mask=None,
                          exclude=None):
    """Attention step reading only a batch-shared contiguous window.

    Alignments advance monotonically ~1 position per emitted character,
    so all lines' ±window_width windows cluster around the same source
    position: one contiguous slice [lo, lo+shared_width) of `u` and
    `attended` covers them on almost every step. When the live lines'
    windows spread wider, the dense step runs instead, so visibility is
    identical to `attention_step`. The JAX ``lax.cond`` on `fits` is a
    host-side ``if`` here (one device read per step).

    `exclude` (B,) marks lines whose window must not constrain the
    slice (finished lines).

    Returns (context (B, A) float32, alignment (B, T)).
    """
    B, T, A = attended.shape
    SW = shared_width
    if not window_width or window_width <= 0 or T <= SW:
        return _attention_step(W_a, v_a, b_UW, b_v, h_prev, prev_a,
                               attended, u, window_width, mask)
    if T > BF16_EXACT_T and prev_a.element_size() < 4:
        # in low precision the dense step compares window positions on
        # the bf16 integer grid, which is exact only up to 256; beyond
        # that the two branches would disagree on visibility
        return _attention_step(W_a, v_a, b_UW, b_v, h_prev, prev_a,
                               attended, u, window_width, mask)
    ww = window_width
    steps = torch.arange(T, dtype=prev_a.dtype, device=prev_a.device)
    t0 = _window_center(prev_a, steps)
    inf = torch.tensor(float('inf'), device=t0.device)
    if exclude is not None:
        t0_lo = torch.where(exclude, inf, t0)
        t0_hi = torch.where(exclude, -inf, t0)
    else:
        t0_lo = t0_hi = t0
    lo_f = torch.floor(t0_lo.min()) - ww
    hi_f = torch.ceil(t0_hi.max()) + ww
    lo_f, hi_f = float(lo_f), float(hi_f)
    if not (hi_f - lo_f + 1.0) <= SW:
        return _attention_step(W_a, v_a, b_UW, b_v, h_prev, prev_a,
                               attended, u, window_width, mask)
    lo = min(max(int(lo_f), 0), T - SW)
    u_s = u[:, lo:lo + SW]
    att_s = attended[:, lo:lo + SW]
    w = mm(h_prev, W_a) + b_UW
    s = (mm(torch.tanh(w[:, None, :] + u_s), v_a) + b_v)[..., 0]
    pos = (lo + torch.arange(SW, device=t0.device)).float()
    keep = torch.abs(t0[:, None] - pos[None, :]) <= ww
    if mask is not None:
        keep = keep & mask[:, lo:lo + SW].bool()
    s = torch.where(keep, s, torch.full_like(s, NEG))
    a_s = softmax(s, dim=1)
    a_s = a_s * keep.any(dim=1, keepdim=True).to(a_s.dtype)
    ctx = (a_s.float()[:, :, None] * att_s.float()).sum(dim=1)
    a_full = torch.zeros((B, T), dtype=a_s.dtype, device=a_s.device)
    a_full[:, lo:lo + SW] = a_s
    return ctx, a_full


def _attention_step(W_a, v_a, b_UW, b_v, h_prev, prev_a, attended, u,
                    window_width=5, mask=None):
    """One attention step.

    h_prev (B, W): previous top-cell hidden state; prev_a (B, T): previous
    alignment; attended (B, T, A); u (B, T, W) precomputed projection.
    With `mask` (B, T), energies outside the true line extent are dropped
    (mask_padding mode). Returns (context (B, A) float32, alignment (B, T)).
    """
    T = attended.shape[1]
    w = mm(h_prev, W_a) + b_UW
    s = (mm(torch.tanh(w[:, None, :] + u), v_a) + b_v)[..., 0]  # (B, T)
    keep = torch.ones_like(s, dtype=torch.bool)
    if mask is not None:
        keep = keep & mask.bool()
    if window_width and window_width > 0:
        steps = torch.arange(T, dtype=s.dtype, device=s.device)
        t0 = _window_center(prev_a, steps)
        keep = keep & (torch.abs(t0[:, None] - steps.float()[None, :])
                       <= window_width)
    s = torch.where(keep, s, torch.full_like(s, NEG))
    a = softmax(s, dim=1)
    a = a * keep.any(dim=1, keepdim=True).to(a.dtype)
    ctx = torch.einsum('bt,bta->ba', a.float(), attended.float())
    return ctx, a
