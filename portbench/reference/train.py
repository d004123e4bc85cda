"""The reference's training steps.

Plain float32 training of the model of ``reference/model.py`` as the
reference trains it (lib/seq2seq.py:491-553, 590-649; Keras semantics):

- inputs one-hot, a line's source ending in its newline; the decoder's
  input is the target shifted right by one behind a zero start vector,
  its output the target, weighted 1 on the target's positions;
- padding masked out of the encoder's recurrence and the attention;
- variational dropout (rate as the configuration states, masks
  constant over time and drawn per line): on each encoder layer's
  output, on the lower decoder layer's output and, per gate, on the top
  cell's input. The masks are drawn, as the program draws them, from one
  CPU ``torch.Generator`` seeded with the dropout seed, in this order
  per step: (B, 1, 2W), (B, 1, W), (B, 1, W), (4, B, 2W), each kept
  where ``torch.rand < 1 - rate``;
- loss: the mean of -log p (p clamped to [1e-7, 1]) over the weighted
  positions, plus the embedding regulariser (row 0 pulled to the
  detached mean of the others, plus 0.01 of the squared distance of each
  row's squared norm from 1);
- each gradient clipped to norm 5 by itself, then Adam (lr from the
  configuration, betas 0.9/0.999, eps 1e-7 outside the root).
"""

import numpy as np
import torch

from . import model


def vectorise(pairs, c2i, V, device):
    """One-hot (x, mask, dec_in, targets, weights) of (source, target)
    text pairs, padded to the longest of the batch."""
    B = len(pairs)
    T = max(len(s) for s, _ in pairs)
    Td = max(len(t) for _, t in pairs) + 1
    x = np.zeros((B, T, V), np.float32)
    dec_in = np.zeros((B, Td, V), np.float32)
    tgt = np.full((B, Td), -1, np.int64)
    for b, (s, t) in enumerate(pairs):
        for i, ch in enumerate(s):
            x[b, i, c2i.get(ch, 0)] = 1.0
        for i, ch in enumerate(t):
            dec_in[b, i + 1, c2i.get(ch, 0)] = 1.0
            tgt[b, i] = c2i.get(ch, 0)
    x = torch.from_numpy(x).to(device)
    return (x, x.ne(0).any(dim=2), torch.from_numpy(dec_in).to(device),
            torch.from_numpy(tgt).to(device),
            torch.from_numpy((tgt >= 0).astype(np.float32)).to(device))


def dropout_scales(gen, B, W, rate, device):
    keep = 1.0 - rate
    shapes = ((B, 1, 2 * W), (B, 1, W), (B, 1, W), (4, B, 2 * W))
    return [((torch.rand(s, generator=gen) < keep).float() / keep).to(device)
            for s in shapes]


def loss_of(p, batch, window, drop):
    x, mask, dec_in, tgt, w = batch
    probs = model.teacher_forward(p, x, mask, dec_in, window, drop)
    logp = torch.log(torch.clamp(probs, 1e-7, 1.0))
    ll = -torch.gather(logp, 2, tgt.clamp(min=0)[..., None])[..., 0]
    data = torch.sum(ll * w) / torch.clamp(torch.sum(w != 0), min=1)
    E = p['E']
    reg = torch.sum(torch.square(E[0] - E[1:].mean(dim=0).detach())) \
        + 0.01 * torch.sum(torch.square(1.0 - torch.sum(E * E, dim=1)))
    return data + reg


def run_steps(init, config, texts, dropout_seed, device, tf32=False):
    """Train from `init` (flat weights) on the batches of text pairs
    `texts`, a step each. Returns losses, the first step's clipped
    gradients and the weights after the last step."""
    charset = config['charset']
    c2i = {c: i + 1 for i, c in enumerate(sorted(set(charset)))}
    V = len(c2i) + 1
    W = config['width']
    lr = config['learning_rate']
    b1, b2, eps = 0.9, 0.999, 1e-7
    p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in init.items()}
    v2 = {k: torch.zeros_like(v) for k, v in init.items()}
    gen = torch.Generator().manual_seed(dropout_seed)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    losses, first = [], None
    try:
        for step, pairs in enumerate(texts, start=1):
            batch = vectorise(pairs, c2i, V, device)
            drop = dropout_scales(gen, len(pairs), W, config['dropout'],
                                  device)
            loss = loss_of(p, batch, config['window_width'], drop)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                clipped = {}
                for (k, leaf), g in zip(p.items(), grads):
                    norm = torch.sqrt(torch.sum(g * g))
                    g = g * torch.clamp(5.0 / torch.clamp(norm, min=1e-12),
                                        max=1.0)
                    clipped[k] = g
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v2[k] = b2 * v2[k] + (1 - b2) * g * g
                    denom = (torch.sqrt(v2[k]) / np.sqrt(1 - b2 ** step)
                             + eps)
                    leaf -= lr / (1 - b1 ** step) * m[k] / denom
                if first is None:
                    first = clipped
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
    return dict(losses=losses, first_grads=first,
                after={k: v.detach() for k, v in p.items()})


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def compare(ref, init, losses, first_grads, after):
    """The three numbers of a run against the reference's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref['losses']))
    g_ref, g_got = _norms(ref['first_grads']), _norms(first_grads)
    g_med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = _norms({k: ref['after'][k] - init[k] for k in moved})
    d_got = _norms({k: after[k] - init[k] for k in moved})
    d_med = float(np.median(list(d_ref.values())))
    change_gap = max(abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med)
                     for k in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap,
                leaves_compared=len(moved))
