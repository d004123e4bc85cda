"""The plain float32 reference of the cor-asv-ann seq2seq model.

Written from the model's equations (the reference's lib/seq2seq.py and
lib/attention.py, as the benchmark's configurations describe them), in
plain PyTorch with no kernel, cache or batching trick, and independent of
the program under test: it imports nothing of it.

- Keras LSTM cells: gates i, f, c~, o; sigmoid and tanh.
- Encoder: a bidirectional LSTM layer of width W each way, then a
  forward LSTM layer of width W (depth 2). With padding masks the
  recurrence skips padded steps (the carry passes, the output is 0).
- Decoder: a plain LSTM layer, then the attention LSTM cell whose input
  is [lower output, attention context]. Decoder layer n starts from the
  final state of encoder layer n (the backward direction's for layer 1).
- Attention: additive energies ``tanh(h W_a + b_UW + u_i) v_a + b_v``
  with ``u = attended A``, visible only within +-window of the expected
  source position ``t0 = prev_a . arange(T) + 1`` and inside the line;
  a row with nothing visible gets a zero alignment.
- Readout: ``softmax(h E^T)`` with the character embedding E (tied).

Parameters are a flat dict of float32 tensors (see `param_shapes`).
"""

import torch

NEG = -1e30


def param_shapes(V, W):
    """Shapes of the parameters of a depth-2 model (attended size A = W)."""
    lstm = {'K': None, 'R': (W, 4 * W), 'b': (4 * W,)}
    shapes = {'E': (V, W), 'A': (W, W)}
    for name, d_in in (('enc1_fw', W), ('enc1_bw', W), ('enc2', 2 * W),
                       ('dec1', W), ('top', 2 * W)):
        for part, shape in lstm.items():
            shapes['%s_%s' % (name, part)] = (
                (d_in, 4 * W) if part == 'K' else shape)
    shapes.update(W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,))
    return shapes


def gates(z, c):
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(x, K, R, b, mask=None, reverse=False, h=None, c=None):
    """An LSTM over x (B, T, D); returns (outputs (B, T, N), h, c)."""
    B, T, _ = x.shape
    N = R.shape[0]
    h = x.new_zeros((B, N)) if h is None else h
    c = x.new_zeros((B, N)) if c is None else c
    zx = x @ K + b
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hn, cn = gates(zx[:, t] + h @ R, c)
        if mask is None:
            h, c, outs[t] = hn, cn, hn
        else:
            m = mask[:, t, None]
            h = torch.where(m, hn, h)
            c = torch.where(m, cn, c)
            outs[t] = torch.where(m, hn, torch.zeros_like(hn))
    return torch.stack(outs, dim=1), h, c


def encode(p, x, mask, drop=None):
    """x (B, T, V) input vectors, mask (B, T) true inside the line.
    `drop` holds the two encoder dropout scales (B, 1, 2W), (B, 1, W) or
    is None. Returns (attended (B, T, W), [(h, c)] per layer, u)."""
    e = x @ p['E']
    fw, _, _ = lstm(e, p['enc1_fw_K'], p['enc1_fw_R'], p['enc1_fw_b'], mask)
    bw, h1, c1 = lstm(e, p['enc1_bw_K'], p['enc1_bw_R'], p['enc1_bw_b'],
                      mask, reverse=True)
    out = torch.cat([fw, bw], dim=-1)
    if drop is not None:
        out = out * drop[0]
    out, h2, c2 = lstm(out, p['enc2_K'], p['enc2_R'], p['enc2_b'], mask)
    if drop is not None:
        out = out * drop[1]
    return out, [(h1, c1), (h2, c2)], out @ p['A']


def attend(p, h_prev, prev_a, attended, u, mask, window):
    """One attention step: (context (B, A), alignment (B, T))."""
    T = attended.shape[1]
    w = h_prev @ p['W_a'] + p['b_UW']
    s = (torch.tanh(w[:, None, :] + u) @ p['v_a'])[..., 0] + p['b_v']
    pos = torch.arange(T, dtype=attended.dtype, device=attended.device)
    t0 = prev_a @ pos + 1.0
    keep = mask & (torch.abs(t0[:, None] - pos[None, :]) <= window)
    s = torch.where(keep, s, torch.full_like(s, NEG))
    a = torch.softmax(s, dim=1) * keep.any(dim=1, keepdim=True)
    return torch.einsum('bt,bta->ba', a, attended), a


def readout(p, h):
    return torch.softmax(h @ p['E'].T, dim=-1)


def decoder_step(p, feedback, states, prev_a, attended, u, mask, window):
    """One decoder step of a batch of hypotheses: feedback (B, V), states
    [(h, c), (h, c)], prev_a (B, T). Returns (probs, states, a)."""
    (h1, c1), (h2, c2) = states
    h1, c1 = gates(feedback @ p['E'] @ p['dec1_K'] + h1 @ p['dec1_R']
                   + p['dec1_b'], c1)
    ctx, a = attend(p, h2, prev_a, attended, u, mask, window)
    h2, c2 = gates(torch.cat([h1, ctx], dim=-1) @ p['top_K']
                   + h2 @ p['top_R'] + p['top_b'], c2)
    return readout(p, h2), [(h1, c1), (h2, c2)], a


def teacher_forward(p, x, mask, dec_in, window, drop=None):
    """Teacher-forced probabilities (B, Td, V) of one-hot decoder inputs
    dec_in (B, Td, V). `drop` is None or the four dropout scales: the two
    encoder layers', the lower decoder layer's (B, 1, W) and the top
    cell's per-gate input scales (4, B, 2W)."""
    attended, states, u = encode(p, x, mask, drop and drop[:2])
    (h1, c1), (h, c) = states
    low, _, _ = lstm(dec_in @ p['E'], p['dec1_K'], p['dec1_R'], p['dec1_b'],
                     h=h1, c=c1)
    if drop is not None:
        low = low * drop[2]
    W = h.shape[1]
    a = x.new_zeros(attended.shape[:2])
    hs = []
    for t in range(dec_in.shape[1]):
        ctx, a = attend(p, h, a, attended, u, mask, window)
        cell_in = torch.cat([low[:, t], ctx], dim=-1)
        if drop is None:
            zin = cell_in @ p['top_K']
        else:
            zin = torch.cat([(cell_in * drop[3][g]) @
                             p['top_K'][:, g * W:(g + 1) * W]
                             for g in range(4)], dim=-1)
        h, c = gates(zin + h @ p['top_R'] + p['top_b'], c)
        hs.append(h)
    return readout(p, torch.stack(hs, dim=1))
