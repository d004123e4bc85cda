"""LSTM ops: sequence LSTM with hoisted input projection, single step.

Keras cell semantics (gate order i, f, c~, o; sigmoid recurrent
activation, tanh activation) so reference HDF5 weights are directly
usable. Port of the JAX package's ``ops/lstm.py``; the rounding points
are kept, so bf16 results follow the JAX ones step for step:

- ``mm`` casts the activation to the weight dtype, accumulates in
  float32 and rounds the product to the weight dtype;
- ``lstm_step`` sums ``mm(x, K) + mm(h, R) + b`` left to right in the
  weight dtype;
- ``lstm_scan`` hoists ``zx = mm(xs, K) + b`` out of the loop and adds
  ``mm(h, R)`` at each step — another order than ``lstm_step``, which
  bf16 rounds differently.
"""

import torch


def gate_math(z, c_prev):
    """Apply Keras LSTM gate nonlinearities to preactivations z (..., 4N)."""
    n = z.shape[-1] // 4
    i = torch.sigmoid(z[..., :n])
    f = torch.sigmoid(z[..., n:2 * n])
    g = torch.tanh(z[..., 2 * n:3 * n])
    o = torch.sigmoid(z[..., 3 * n:])
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


def mm(a, w):
    """Matmul with the activation cast to the weight dtype and float32
    accumulation, the result rounded back to the weight dtype (the
    package switches off reduced-precision bf16 reductions at import)."""
    return torch.matmul(a.to(w.dtype), w)


def lstm_step(x, h, c, w):
    """Single LSTM step: x (B, D), h/c (B, N). Returns (h, c)."""
    z = mm(x, w['kernel']) + mm(h, w['recurrent_kernel']) + w['bias']
    return gate_math(z, c)


def attention_cell_preact(cell, cell_in, h, masks):
    """Gate preactivations of the top attention-LSTM cell, with optional
    per-gate variational dropout masks (4, B, D) on the input half.

    Rounding disciplines of the JAX package: with masks, the four
    per-gate input products and the recurrent product accumulate in
    float32 and round ONCE; without, the `mm` per-product rounding
    (reference-parity path)."""
    if masks is None:
        return (mm(cell_in, cell['kernel']) + mm(h, cell['recurrent_kernel'])
                + cell['bias'])
    W = cell['recurrent_kernel'].shape[0]
    kdt = cell['kernel'].dtype
    f32 = torch.float32
    # inputs rounded to the weight dtype, then exact float32 products
    # of those values summed in float32
    ks = [torch.matmul((cell_in * masks[g]).to(kdt).to(f32),
                       cell['kernel'][:, g * W:(g + 1) * W].to(f32))
          for g in range(4)]
    z = torch.cat(ks, dim=-1) + torch.matmul(
        h.to(kdt).to(f32), cell['recurrent_kernel'].to(f32))
    return z.to(kdt) + cell['bias']


def lstm_scan(xs, w, h0=None, c0=None, reverse=False, mask=None):
    """Run an LSTM over xs (B, T, D). Returns (outputs (B, T, N), h, c).

    The input projection runs as one batched matmul over all timesteps;
    the loop carries (h, c) and consumes the precomputed preactivations.

    With `mask` (B, T) the recurrence skips masked-out timesteps (the
    carry passes through unchanged and the output is zero there), which
    makes results independent of padded length. Without it, padding runs
    through the recurrence like the reference (seq2seq.py:1026-1043).
    """
    B, T, _ = xs.shape
    rk = w['recurrent_kernel']
    N, dt = rk.shape[0], rk.dtype
    h = (torch.zeros((B, N), dtype=dt, device=xs.device) if h0 is None
         else h0.to(dt))
    c = (torch.zeros((B, N), dtype=dt, device=xs.device) if c0 is None
         else c0.to(dt))
    zx = mm(xs, w['kernel']) + w['bias']
    out = torch.zeros((B, T, N), dtype=dt, device=xs.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new = gate_math(zx[:, t] + mm(h, rk), c)
        if mask is None:
            h, c = h_new, c_new
            out[:, t] = h
        else:
            m = mask[:, t, None]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            out[:, t] = torch.where(m, h_new, torch.zeros_like(h_new))
    return out, h, c
