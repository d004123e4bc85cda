"""K3: one fused decoder step as a CUDA kernel (``csrc/decode_step.cu``),
on attention windows gathered by the caller or read by index.

Replaces the JAX package's Pallas kernel ``ops/pallas_decode.py:
_fused_step_kernel`` (``fused_decode_step``, ``pack_weights``). One
launch computes, for N rows at once: the embedding of the softmax
feedback, LSTM layer 1, windowed additive attention over WIN rows of
``u`` and ``attended``, the attention LSTM cell and the weight-tied
softmax readout. Depth 2, no residual connections, float32 or bfloat16
weights; every output is float32. In the JAX package nothing but a test
calls the kernel; here it is the step of the beam search
(``models/beam.py:beam_decoder_step``), over B*K hypothesis rows.

Two entry points launch the same kernel:

- ``fused_decode_step`` takes the window rows gathered, (N, WIN, W) and
  (N, WIN, A): the JAX package's signature, held against the Pallas
  kernel;
- ``fused_decode_step_indexed`` takes the encoder's (L, T, W) and
  (L, T, A) with each row's window start, and the kernel reads the rows
  by index (row n on line n // rows_per_line, position j at encoder row
  min(win_start[n] + j, T - 1), the beam's ``win_ix``), so the beam
  writes no gathered copy.

The kernel (six launches on the stream, csrc/decode_step.cu) takes any
N (product tiles of 64 or 128 rows); W and A have to be multiples of 8
(16-byte loads), and V's logits of 64 rows must fit a block's shared
memory: `fused_step_supported`. It reads the weights in
the layouts `pack_weights` adds beside the JAX package's entries
(`kernel_layouts`).

``fused_decode_step_reference`` is the plain version: a PyTorch
transcription of the Pallas body with the same rounding points;
``fused_decode_step_indexed_reference`` gathers and calls it. The
wrappers take them for CPU tensors only; for CUDA tensors they launch
the kernel or raise.
"""

import ctypes

import torch

from . import _build
from .lstm_scan_kernel import _DTYPE_CODES, _on_cpu

F32 = torch.float32
_WEIGHT_ORDER = ('E', 'k1', 'r1', 'b1', 'k2', 'r2', 'b2', 'W_a', 'v_a',
                 'b_UW', 'b_v')
_BIASES = ('b1', 'b2', 'b_UW', 'b_v')
# what the kernel reads, in the order of its `in` array after the
# activations: E^T, [k1; r1] and [k2; r2] by gate-column blocks, W_a^T,
# E padded along V, then v_a and the biases
_KERNEL_ORDER = ('ET', 'z1w', 'W_aT', 'z2w', 'Ep', 'v_a', 'b1', 'b2',
                 'b_UW', 'b_v')
# units of a slice of the kernel's LSTM stages (csrc/decode_step.cu: US)
UNITS_PER_SLICE = 32


def _gate_blocks(m, W):
    """(K, 4W) row-major -> (4*Wp, K): the columns of the gates as rows,
    ordered slice by slice of UNITS_PER_SLICE units (gate i, f, g, o of
    the slice's units), units beyond W zero (Wp: W rounded up to a
    whole slice)."""
    K = m.shape[0]
    Wp = -(-W // UNITS_PER_SLICE) * UNITS_PER_SLICE
    g = torch.nn.functional.pad(m.reshape(K, 4, W), (0, Wp - W))
    g = g.reshape(K, 4, Wp // UNITS_PER_SLICE, UNITS_PER_SLICE)
    return g.permute(2, 1, 3, 0).reshape(4 * Wp, K).contiguous()


def kernel_layouts(weights):
    """The packed matrices the CUDA kernel reads, from the JAX package's
    entries of `weights` (`pack_weights` adds them): E^T and E with V
    padded to a multiple of 16, W_a^T, and [k1; r1], [k2; r2] as
    gate-column-major blocks (`_gate_blocks`), so that each LSTM stage is
    one product over the concatenated reduction."""
    E = weights['E']
    V, W = E.shape
    Vp = -(-V // 16) * 16
    Ep = torch.nn.functional.pad(E, (0, 0, 0, Vp - V))
    return dict(
        ET=Ep.t().contiguous(), Ep=Ep.contiguous(),
        W_aT=weights['W_a'].t().contiguous(),
        z1w=_gate_blocks(torch.cat([weights['k1'], weights['r1']]), W),
        z2w=_gate_blocks(torch.cat([weights['k2'], weights['r2']]), W))


def pack_weights(params, dtype=torch.bfloat16):
    """The depth-2 decoder weights as a flat dict: matrices cast to
    `dtype`, biases float32 (the JAX package's ``pack_weights``), and
    beside them the kernel's layouts (`kernel_layouts`)."""
    dec = params['decoder']
    top = dec[1]
    named = dict(E=params['char_embedding']['kernel'],
                 k1=dec[0]['kernel'], r1=dec[0]['recurrent_kernel'],
                 b1=dec[0]['bias'],
                 k2=top['cell']['kernel'], r2=top['cell']['recurrent_kernel'],
                 b2=top['cell']['bias'],
                 W_a=top['W_a'], v_a=top['v_a'], b_UW=top['b_UW'],
                 b_v=top['b_v'])
    weights = {k: torch.as_tensor(v).to(F32 if k in _BIASES else dtype)
               .contiguous() for k, v in named.items()}
    weights.update(kernel_layouts(weights))
    return weights


def _dot(a, w):
    """Product of `a` rounded to the dtype of `w` with `w`, summed in
    float32 and left there."""
    return torch.matmul(a.to(w.dtype).to(F32), w.to(F32))


def _gates(z, c_prev):
    n = z.shape[-1] // 4
    i = torch.sigmoid(z[:, :n])
    f = torch.sigmoid(z[:, n:2 * n])
    g = torch.tanh(z[:, 2 * n:3 * n])
    o = torch.sigmoid(z[:, 3 * n:])
    c = f * c_prev + i * g
    return o * torch.tanh(c), c


def fused_decode_step_reference(fb, h1, c1, h2, c2, u_w, att_w, visible,
                                weights):
    """Plain K3. fb (N, V), h1/c1/h2/c2 (N, W), u_w (N, WIN, W), att_w
    (N, WIN, A), visible (N, WIN); `weights` as built by `pack_weights`.
    Returns float32 (probs (N, V), h1, c1, h2, c2, align (N, WIN))."""
    w = weights
    x = _dot(fb, w['E'])
    z1 = _dot(x, w['k1']) + _dot(h1, w['r1']) + w['b1']
    h1n, c1n = _gates(z1, c1.to(F32))
    w_vec = _dot(h2, w['W_a']) + w['b_UW']
    t = torch.tanh(w_vec[:, None, :] + u_w.to(F32))
    s = _dot(t, w['v_a'])[..., 0] + w['b_v'][0]
    vis = visible > 0
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    es = torch.exp(s - s.amax(dim=1, keepdim=True))
    a = es / es.sum(dim=1, keepdim=True)
    a = a * vis.any(dim=1, keepdim=True).to(F32)
    ctx = (a[:, :, None] * att_w.to(F32)).sum(dim=1)
    z2 = (_dot(torch.cat([h1n, ctx], dim=-1), w['k2']) + _dot(h2, w['r2'])
          + w['b2'])
    h2n, c2n = _gates(z2, c2.to(F32))
    logits = _dot(h2n, w['E'].t())
    el = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    return el / el.sum(dim=1, keepdim=True), h1n, c1n, h2n, c2n, a


def gather_windows(u, attended, rows_per_line, win_start, WIN):
    """The window rows of the indexed form as the gathered form takes
    them: (N, WIN, W) and (N, WIN, A), row n on line n // rows_per_line,
    position j at encoder row min(win_start[n] + j, T - 1)."""
    N = win_start.shape[0]
    T = u.shape[1]
    dev = u.device
    line = torch.div(torch.arange(N, device=dev), rows_per_line,
                     rounding_mode='floor')[:, None]
    ix = torch.clamp(win_start.long()[:, None]
                     + torch.arange(WIN, device=dev), max=T - 1)
    return u[line, ix], attended[line, ix]


def fused_decode_step_indexed_reference(fb, h1, c1, h2, c2, u, attended,
                                        rows_per_line, win_start, visible,
                                        weights):
    """Plain K3 on windows read by index: `gather_windows`, then
    `fused_decode_step_reference`."""
    u_w, att_w = gather_windows(u, attended, rows_per_line, win_start,
                                visible.shape[1])
    return fused_decode_step_reference(fb, h1, c1, h2, c2, u_w, att_w,
                                       visible, weights)


def step_rows_per_tile(dtype, N, W, rows_per_tile=0):
    """The rows of a product tile a launch over N rows of width W takes in
    `dtype` on the current CUDA device (the launcher's pick, or the
    imposed one; 0 if refused)."""
    return _build.library().decode_step_rows_per_tile(_DTYPE_CODES[dtype], N,
                                                      W, rows_per_tile)


def _launch(name, fb, h1, c1, h2, c2, u, att, visible, win_start,
            rows_per_line, weights, rows_per_tile):
    """Checks, then one launch of the kernel: gathered windows where
    `rows_per_line` is 0, else by index."""
    acts = (fb, h1, c1, h2, c2, u, att, visible)
    dev = fb.device
    mats = tuple(weights.get(k) for k in _WEIGHT_ORDER + _KERNEL_ORDER)
    if any(t is None for t in mats):
        raise ValueError('%s: weights without the kernel\'s layouts (use '
                         'pack_weights)' % name)
    extra = () if win_start is None else (win_start,)
    if dev.type != 'cuda' or any(t.device != dev
                                 for t in acts + mats + extra):
        raise ValueError('%s: tensors must all be on one CUDA device (or '
                         'all on the CPU)' % name)
    N, V = fb.shape
    W, A, WIN = h1.shape[1], att.shape[-1], visible.shape[1]
    wdt = weights['E'].dtype
    Vp = -(-V // 16) * 16
    Wp = -(-W // UNITS_PER_SLICE) * UNITS_PER_SLICE
    shapes = dict(E=(V, W), k1=(W, 4 * W), r1=(W, 4 * W), b1=(4 * W,),
                  k2=(W + A, 4 * W), r2=(W, 4 * W), b2=(4 * W,),
                  W_a=(W, W), v_a=(W, 1), b_UW=(W,), b_v=(1,),
                  ET=(W, Vp), Ep=(Vp, W), W_aT=(W, W), z1w=(4 * Wp, 2 * W),
                  z2w=(4 * Wp, 2 * W + A))
    for k, shape in shapes.items():
        t = weights[k]
        if tuple(t.shape) != shape or not t.is_contiguous() \
                or t.dtype != (F32 if k in _BIASES else wdt):
            raise ValueError('%s: weight %s: contiguous %s of shape %s '
                             'expected' % (name, k, wdt, shape))
    if wdt not in _DTYPE_CODES or u.dtype not in _DTYPE_CODES \
            or att.dtype != u.dtype:
        raise ValueError('%s: float32 or bfloat16 weights and windows '
                         'expected' % name)
    if rows_per_line == 0:
        T = 0
        win_ok = (tuple(u.shape) == (N, WIN, W)
                  and tuple(att.shape) == (N, WIN, A))
    else:
        L, T = u.shape[0], u.shape[1]
        win_ok = (rows_per_line > 0 and tuple(u.shape) == (L, T, W)
                  and tuple(att.shape) == (L, T, A) and T >= 1
                  and L * rows_per_line >= N
                  and tuple(win_start.shape) == (N,))
    if any(tuple(t.shape) != (N, W) for t in (h1, c1, h2, c2)) \
            or not win_ok or tuple(visible.shape) != (N, WIN) or N < 1:
        raise ValueError('%s: inconsistent shapes' % name)
    lib = _build.library()
    with torch.cuda.device(dev):
        if not lib.decode_step_supported(V, W, A, WIN):
            raise ValueError('%s: widths V=%d W=%d A=%d WIN=%d are beyond '
                             'the kernel' % (name, V, W, A, WIN))
        starts = (torch.zeros(1, dtype=torch.int32, device=dev)
                  if win_start is None
                  else win_start.to(torch.int32).contiguous())
        ins = [t.to(F32).contiguous() for t in (fb, h1, c1, h2, c2)] \
            + [u.contiguous(), att.contiguous(), (visible > 0).contiguous(),
               starts] + [weights[k] for k in _KERNEL_ORDER]
        if any(t.data_ptr() % 16 for t in ins):
            raise ValueError('%s: 16-byte aligned tensors expected' % name)
        outs = [torch.empty(shape, dtype=F32, device=dev) for shape in
                ((N, V), (N, W), (N, W), (N, W), (N, W), (N, WIN))]
        scratch = [torch.empty((N, Vp + 5 * W + A), dtype=wdt, device=dev),
                   torch.empty((N, W), dtype=F32, device=dev)]
        in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
        out_ptrs = (ctypes.c_void_p * (len(outs) + 2))(
            *(t.data_ptr() for t in outs + scratch))
        err = lib.decode_step_launch(
            _DTYPE_CODES[wdt], _DTYPE_CODES[u.dtype], in_ptrs, out_ptrs,
            N, V, W, A, WIN, rows_per_line, T, rows_per_tile,
            _build.stream_of(fb))
    _build.check(err, '%s (N=%d V=%d W=%d A=%d WIN=%d)'
                 % (name, N, V, W, A, WIN))
    return tuple(outs)


def fused_decode_step(fb, h1, c1, h2, c2, u_w, att_w, visible, weights, *,
                      rows_per_tile=0):
    """K3: one decoder step of N rows on gathered windows (see
    `fused_decode_step_reference`): the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. `rows_per_tile` imposes the kernel's
    row tile (tests; 0: the launcher's pick)."""
    acts = (fb, h1, c1, h2, c2, u_w, att_w, visible)
    if _on_cpu(acts + tuple(weights[k] for k in _WEIGHT_ORDER)):
        return fused_decode_step_reference(*acts, weights)
    out = _launch('fused_decode_step', *acts, None, 0, weights,
                  rows_per_tile)
    fused_decode_step.launches += 1
    return out


fused_decode_step.launches = 0


def fused_decode_step_indexed(fb, h1, c1, h2, c2, u, attended,
                              rows_per_line, win_start, visible, weights, *,
                              rows_per_tile=0):
    """K3 reading the window rows by index: u (L, T, W) and attended (L,
    T, A) per line, row n on line n // rows_per_line, window position j
    at encoder row min(win_start[n] + j, T - 1) (see
    `fused_decode_step_indexed_reference`): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    acts = (fb, h1, c1, h2, c2, u, attended, visible, win_start)
    if _on_cpu(acts + tuple(weights[k] for k in _WEIGHT_ORDER)):
        return fused_decode_step_indexed_reference(
            fb, h1, c1, h2, c2, u, attended, rows_per_line, win_start,
            visible, weights)
    if int(rows_per_line) < 1:
        raise ValueError('fused_decode_step_indexed: rows_per_line >= 1 '
                         'expected')
    out = _launch('fused_decode_step_indexed', fb, h1, c1, h2, c2, u,
                  attended, visible, win_start, int(rows_per_line), weights,
                  rows_per_tile)
    fused_decode_step_indexed.launches += 1
    return out


fused_decode_step_indexed.launches = 0


def step_covers(config, with_lm=False):
    """Whether the fused step computes this model's decoder step: depth
    2, no residual connections, a local window, no LM readout beside
    it."""
    return (config.depth == 2 and not config.residual_connections
            and config.window_width > 0 and not with_lm)


def fused_step_supported(params, config, with_lm=False):
    """Whether `fused_decode_step(_indexed)` can launch the CUDA kernel as
    the step of this model: `step_covers`, float32 or bfloat16 weights on
    a CUDA device, and widths that the kernel takes (W and A multiples of
    8, a tile's logits and window within a block's shared memory). (CPU
    tensors run the plain version, which takes any widths.)"""
    emb = params['char_embedding']['kernel']
    if not step_covers(config, with_lm) or emb.device.type != 'cuda' \
            or emb.dtype not in _DTYPE_CODES:
        return False
    with torch.cuda.device(emb.device):
        return bool(_build.library().decode_step_supported(
            config.voc_size, config.width, config.attended_size,
            2 * config.window_width + 2))
