"""K1: the whole greedy decode loop, one cooperative CUDA launch per tile
of up to 16 lines (``csrc/decode_loop.cu``).

Replaces the JAX package's Pallas kernel ``ops/pallas_decode_loop.py:
_kernel`` (``decode_greedy_fused``). Each step of a line: embed the
softmax feedback, LSTM layer 1, dense window-masked additive attention,
the attention LSTM cell, the tied softmax readout, argmax over indices
>= 1 (lowest index on ties), newline / 2T stop and a float32
``-log max(p, 1e-30)`` score. Depth 2, no residual connections,
bfloat16 weights.

The TPU kernel keeps all decoder weights resident in 16 MB of VMEM. On
Hopper the launch spreads them over the SMs: unit blocks each keep the
gate columns of a slice of units of k1, r1, k2, r2 and W_a in shared
memory for the whole loop and run the tile's products on ``mma.sync``
with the gates in their epilogue; attention blocks own lines of the tile
and run their windowed attention; as many readout blocks, with E
resident, run their readout, beside the attention of the next step. The
blocks exchange h1, h2, x, wvec, ctx and the lines' done flags through a
small scratch buffer and meet at counters, four a step. The launcher
picks the split from the widths and the card's SM count and shared
memory (`decode_loop_plan`); the kernel bounds T only where the window
centre's products stop being exact in float32 (`max_decode_t`), serving
sends it buckets up to T = 256 (`loop_covers`). Batches of more than 16
lines run as tiles in turn, each one launch.

``decode_loop_reference`` is the plain twin: a step-by-step PyTorch
transcription of ``_kernel`` with the same rounding points. The wrapper
``decode_loop`` takes it for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

import ctypes

import torch

from . import _build
from .attention import BF16_EXACT_T, NEG, softmax
from .lstm import mm

ROWS = 16            # lines of a tile: one launch
_PLAN_KEYS = ('unit_blocks', 'line_blocks', 'units_per_block',
              'gate_columns', 'tiles_per_pass', 'smem_bytes', 'max_t')


def decode_loop_plan(width, attended_size, voc_size, window_width,
                     lines=ROWS, units_per_block=0, lib=None):
    """The grid a tile of `lines` lines takes on the current CUDA device
    (`units_per_block` > 0 imposes one): a dict of `_PLAN_KEYS`
    (`line_blocks`: attention blocks, and as many readout blocks), or None
    where no plan fits (the widths, the window, or the card's SMs and
    shared memory). `lib`: the kernel library, built at first use."""
    lib = lib or _build.library()
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = lib.decode_loop_plan(lines, width, attended_size, voc_size,
                               window_width, units_per_block, out)
    return None if err else dict(zip(_PLAN_KEYS, out))


def max_decode_t(width, attended_size, voc_size, window_width, device):
    """Longest bucket T the kernel takes for these widths on `device`
    (its lines keep only their window in shared memory, so T is bounded
    where a.t of the window centre's sum stops being exact in float32),
    or 0 where the decoder's weights do not fit the card."""
    with torch.cuda.device(device):
        plan = decode_loop_plan(width, attended_size, voc_size,
                                window_width)
    return plan['max_t'] if plan else 0


def loop_covers(config, dtype, T):
    """Whether the kernel's loop is the serving decoder for this model,
    weight dtype and bucket: depth 2, no residual connections, a local
    window, widths in multiples of 8, bfloat16 weights, and T within
    `BF16_EXACT_T`. Beyond it the JAX package's bfloat16 serving compares
    window positions rounded to the bfloat16 grid, and the kernel keeps
    them exact, so those buckets go to the windowed decoder as there."""
    return (config.depth == 2 and not config.residual_connections
            and config.window_width > 0
            and not (config.width % 8 or config.attended_size % 8)
            and dtype == torch.bfloat16 and T <= BF16_EXACT_T)


def fused_greedy_supported(params, config, T):
    """Whether `decode_greedy_fused` serves this model and bucket:
    `loop_covers`, weights on a CUDA device whose SMs hold them in their
    shared memory, and T within `max_decode_t`."""
    emb = params['char_embedding']['kernel']
    if not loop_covers(config, emb.dtype, T) or emb.device.type != 'cuda':
        return False
    return T <= max_decode_t(config.width, config.attended_size,
                             config.voc_size, config.window_width,
                             emb.device)


def _gates(z, c_prev, W):
    """Gate math in float32, rounded to the weight dtype at the state
    boundary (``_kernel``'s ``gates``)."""
    wdt = z.dtype
    z = z.float()
    i = torch.sigmoid(z[:, :W])
    f = torch.sigmoid(z[:, W:2 * W])
    g = torch.tanh(z[:, 2 * W:3 * W])
    o = torch.sigmoid(z[:, 3 * W:])
    c = f * c_prev.float() + i * g
    return (o * torch.tanh(c)).to(wdt), c.to(wdt)


def window_keep(prev_a, steps_f, ww, valid):
    """The kernel's window test: (B, T) positions within `ww` of the
    expected position t0 = prev_a . steps + 1, with exact float32
    positions `steps_f` (1, T), among the `valid` ones."""
    t0 = (prev_a.float() * steps_f).sum(dim=1, keepdim=True) + 1.0
    return (torch.abs(t0 - steps_f) <= float(ww)) & valid


def decode_loop_reference(attended, u, states, live, enc_mask, weights,
                          newline, S, ww):
    """Plain PyTorch twin of the kernel: the greedy loop of one batch.

    attended (B, T, A), u (B, T, W) and the states [(h1, c1), (h2, c2)]
    in the weight dtype; live (B,) and enc_mask (B, T) int32; `weights`
    as built by `decoder_weights`. Returns (idx (B, S) int32, prob
    (B, S) float32, length (B,) int32, score (B,) float32 — the raw sum
    of -log p, not yet divided by the length)."""
    f32 = torch.float32
    E = weights['E']
    B, T, W = u.shape
    dev = u.device
    steps_f = torch.arange(T, dtype=f32, device=dev)[None, :]
    (h1, c1), (h2, c2) = states
    fb = torch.zeros((B, E.shape[0]), dtype=E.dtype, device=dev)
    prev_a = torch.zeros((B, T), dtype=E.dtype, device=dev)
    done = live == 0
    length = torch.zeros((B,), dtype=torch.int32, device=dev)
    score = torch.zeros((B,), dtype=f32, device=dev)
    out_idx = torch.zeros((B, S), dtype=torch.int32, device=dev)
    out_prob = torch.zeros((B, S), dtype=f32, device=dev)
    valid = enc_mask > 0
    t = 0
    while t < S and not bool(done.all()):
        x = mm(fb, E)
        z1 = mm(x, weights['k1']) + mm(h1, weights['r1']) + weights['b1']
        h1n, c1n = _gates(z1, c1, W)
        w_vec = mm(h2, weights['W_a']) + weights['b_UW']
        e_t = torch.tanh((w_vec[:, None, :] + u).float()).to(E.dtype)
        s_en = (torch.matmul(e_t.float(), weights['v_a'].float())[..., 0]
                + weights['b_v'].float())
        keep = window_keep(prev_a, steps_f, ww, valid)
        s_en = torch.where(keep, s_en, torch.full_like(s_en, NEG))
        a = softmax(s_en, dim=1)
        a = (a * keep.any(dim=1, keepdim=True).to(f32)).to(E.dtype)
        ctx = (a.float()[..., None] * attended.float()).sum(dim=1)
        cell_in = torch.cat([h1n, ctx.to(E.dtype)], dim=-1)
        z2 = mm(cell_in, weights['k2']) + mm(h2, weights['r2']) \
            + weights['b2']
        h2n, c2n = _gates(z2, c2, W)
        logits = torch.matmul(h2n.float(), E.float().T)
        probs = softmax(logits, dim=-1).to(E.dtype)
        lane = torch.arange(probs.shape[1], device=dev)[None, :]
        masked = torch.where(lane == 0, -1.0, probs.float())
        p, _ = masked.max(dim=1)
        idx = torch.argmax(masked, dim=1).to(torch.int32)
        active = ~done
        out_idx[:, t] = torch.where(active, idx, torch.zeros_like(idx))
        out_prob[:, t] = torch.where(active, p, torch.zeros_like(p))
        length += active.to(torch.int32)
        score += torch.where(active, -torch.log(torch.clamp(p, min=1e-30)),
                             torch.zeros_like(p))
        done = done | (active & (idx == newline))
        fb, h1, c1, h2, c2, prev_a = probs, h1n, c1n, h2n, c2n, a
        t += 1
    return out_idx, out_prob, length, score


def decoder_weights(params):
    """The decoder weights the loop reads, by kernel argument name."""
    dec = params['decoder']
    top = dec[1]
    return dict(E=params['char_embedding']['kernel'],
                k1=dec[0]['kernel'], r1=dec[0]['recurrent_kernel'],
                b1=dec[0]['bias'],
                k2=top['cell']['kernel'], r2=top['cell']['recurrent_kernel'],
                b2=top['cell']['bias'],
                W_a=top['W_a'], v_a=top['v_a'], b_UW=top['b_UW'],
                b_v=top['b_v'])


_WEIGHT_ORDER = ('E', 'k1', 'r1', 'b1', 'k2', 'r2', 'b2', 'W_a', 'v_a',
                 'b_UW', 'b_v')


def _aligned(t):
    """t, contiguous and 16-byte aligned (the kernel reads rows in
    16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def run_kernel(lib, attended, u, states, live, enc_mask, weights, newline,
               S, ww, units_per_block=0, stream=None):
    """Launch K1 from `lib` on the tiles of the batch: (idx, prob, length,
    score, tiles). Arguments and checks as for `decode_loop`, whose CUDA
    path this is; the emulated build of the tests calls it on CPU
    tensors."""
    (h1, c1), (h2, c2) = states
    inputs = [attended, u, h1, c1, h2, c2, live, enc_mask] \
        + [weights[k] for k in _WEIGHT_ORDER]
    dev = u.device
    B, T, W = u.shape
    A = attended.shape[2]
    V = weights['E'].shape[0]
    bf16 = torch.bfloat16
    if any(t.dtype != bf16 for t in inputs[:6] + inputs[8:]) \
            or live.dtype != torch.int32 or enc_mask.dtype != torch.int32:
        raise ValueError('decode_loop: bfloat16 activations and weights, '
                         'int32 live/mask expected')
    shapes_ok = (attended.shape[:2] == (B, T)
                 and all(t.shape == (B, W) for t in (h1, c1, h2, c2))
                 and live.shape == (B,) and enc_mask.shape == (B, T)
                 and weights['E'].shape == (V, W)
                 and weights['k1'].shape == (W, 4 * W)
                 and weights['r1'].shape == (W, 4 * W)
                 and weights['b1'].shape == (4 * W,)
                 and weights['k2'].shape == (W + A, 4 * W)
                 and weights['r2'].shape == (W, 4 * W)
                 and weights['b2'].shape == (4 * W,)
                 and weights['W_a'].shape == (W, W)
                 and weights['v_a'].shape == (W, 1)
                 and weights['b_UW'].shape == (W,)
                 and weights['b_v'].shape == (1,))
    if not shapes_ok or W % 8 or A % 8:
        raise ValueError('decode_loop: inconsistent shapes')
    inputs = [_aligned(t) for t in inputs]
    tiles = -(-B // ROWS)
    out_idx = torch.zeros((B, S), dtype=torch.int32, device=dev)
    out_prob = torch.zeros((B, S), dtype=torch.float32, device=dev)
    length = torch.zeros((B,), dtype=torch.int32, device=dev)
    score = torch.zeros((B,), dtype=torch.float32, device=dev)
    # exchange between the blocks: h1 (two copies), h2, x, wvec, ctx
    xch = torch.zeros((ROWS * (5 * W + A),), dtype=bf16, device=dev)
    # the lines' done flags, then 4 counters a tile, zero
    ints = torch.zeros((ROWS + 4 * tiles,), dtype=torch.int32, device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    err = lib.decode_loop_launch(
        ptrs(inputs), ptrs([out_idx, out_prob, length, score]),
        xch.data_ptr(), ints.data_ptr(), B, T, W, A, V, S, int(ww),
        int(newline), int(units_per_block), stream)
    _build.check(err, 'decode_loop kernel', lib)
    return out_idx, out_prob, length, score, tiles


def decode_loop(attended, u, states, live, enc_mask, weights, newline, S,
                ww, units_per_block=0):
    """The greedy loop of one batch: the CUDA kernel on CUDA tensors (one
    launch per tile of 16 lines; `units_per_block` > 0 imposes the split,
    tests and tools only), the plain twin on CPU tensors. Arguments and
    results as for `decode_loop_reference`."""
    (h1, c1), (h2, c2) = states
    inputs = [attended, u, h1, c1, h2, c2, live, enc_mask] \
        + [weights[k] for k in _WEIGHT_ORDER]
    if all(t.device.type == 'cpu' for t in inputs):
        return decode_loop_reference(attended, u, states, live, enc_mask,
                                     weights, newline, S, ww)
    dev = u.device
    if dev.type != 'cuda' or any(t.device != dev for t in inputs):
        raise ValueError('decode_loop: tensors must all be on one CUDA '
                         'device (or all on the CPU)')
    *out, tiles = run_kernel(_build.library(), attended, u, states, live,
                             enc_mask, weights, newline, S, ww,
                             units_per_block, _build.stream_of(u))
    decode_loop.launches += tiles
    return tuple(out)


decode_loop.launches = 0


def decode_greedy_fused(params, config, enc_input, newline_idx,
                        max_steps=None):
    """Whole-loop greedy decode. Same contract as
    ``models.seq2seq.decode_greedy`` minus alignments (None there).
    Encodes with the port's ``encode``, then runs the loop in one
    launch per tile of 16 lines. Callers check `fused_greedy_supported`
    first."""
    from ..models.seq2seq import encode, ensure_onehot
    enc_input = ensure_onehot(enc_input, config, params)
    B, T, V = enc_input.shape
    S = 2 * T if max_steps is None else max_steps
    attended, states, u = encode(params, config, enc_input)
    live = enc_input.reshape(B, -1).ne(0).any(dim=1).to(torch.int32)
    enc_mask = (enc_input.ne(0).any(dim=2).to(torch.int32)
                if config.mask_padding
                else torch.ones((B, T), dtype=torch.int32,
                                device=enc_input.device))
    idx, prob, length, score = decode_loop(
        attended, u, states, live, enc_mask, decoder_weights(params),
        newline_idx, S, config.window_width)
    lengths = torch.clamp(length, min=1)
    return idx, prob.to(attended.dtype), length, score / lengths, None
