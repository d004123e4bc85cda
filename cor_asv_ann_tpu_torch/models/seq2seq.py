"""Seq2seq core: encoder, decoder step, greedy decoders, teacher forcing.

Port of the JAX package's ``models/seq2seq.py`` (reference
lib/seq2seq.py:190-489): a stacked (bi)LSTM encoder, a forward LSTM
decoder with local additive attention on top, and a weight-tied softmax
output. Functions take (params, config, tensors) and run on the device
the tensors live on. Training uses the same decoder teacher-forced
(`forward_teacher`). Every LSTM scan, masked or not, in serving as in
training, goes through the whole-sequence scan kernels where they take
it (`_sequence_scan`); training's top attention layer,
masked or not, through the fused teacher kernels (ops/teacher_kernel.py),
else the windowed scan with the hand-written backward
(models/teacher_scan.py) or the dense or windowed per-step body under
autograd, chosen as the JAX package chooses (`_decode_teacher`).

Greedy contract (reference ``decode_batch_greedy``, seq2seq.py:1215-1286):
the raw softmax is fed back as the next input, the pick is
``argmax(probs[:, 1:]) + 1`` (index 0 excluded, ties to the lowest
index), each line stops at its newline, no decode runs past 2T steps,
and the score is the float32 sum of ``-log p`` divided by
``max(length, 1)``. The JAX ``while_loop``'s ``all(done)`` test and the
shared-window ``fits`` test are host reads, once per step.
"""

import torch

from ..ops.attention import attention_step, attention_step_shared, softmax
from ..ops.lstm import (attention_cell_preact, gate_math, lstm_scan,
                        lstm_step, mm)
from ..ops.lstm_scan_kernel import fused_scan_supported, lstm_scan_fused
from ..ops.teacher_kernel import teacher_fused_supported, teacher_top_fused
from ..utils import profiling
from .config import Seq2SeqConfig
from .teacher_scan import teacher_top_scan

# batch-shared attention window width for greedy decode (see
# ops/attention.py:attention_step_shared)
SHARED_WINDOW = 32
# Whole-sequence LSTM scan kernels K4/K5 (ops/lstm_scan_kernel.py) for
# every sequence scan, serving's encoder as training's: 'auto' takes them
# for CUDA tensors at the shapes they support (fused_scan_supported), in
# float32, and in bfloat16 where a gradient flows through the scan; 'on'
# forces `lstm_scan_fused` (its plain versions on CPU tensors, for
# tests), 'off' keeps the step-by-step `lstm_scan`. The JAX package
# scans through its kernels in training only. K4 computes the same
# recurrence with another rounding (its own logistic, another summation
# order), so served float32 results are held to the golden corpus by its
# texts and score tolerances, not by byte equality. Served bfloat16
# scans keep `lstm_scan`: K4's bfloat16 logistic rounds every
# intermediate, and on the card the K3 beam over such an encoder fell
# below its agreement bar with the float32 goldens. CPU tensors keep
# `lstm_scan` under 'auto'.
_FUSED_SCAN = 'auto'
# Teacher-forced attention mode: 'auto' uses the windowed carry (aw,
# astart through `_windowed_attention`: only the +-window_width visible
# rows are read, identical to the dense masked energies since everything
# else is masked to -1e30 anyway) whenever the model has a local window
# and the line is at least _TEACHER_WINDOWED_MIN_T long; 'dense' forces
# the full-T energies; 'windowed' forces the carry. The threshold is the
# JAX package's (measured there, on its own hardware), kept so that both
# packages dispatch alike; it is not a measurement on a GPU.
_TEACHER_ATTENTION = 'auto'
_TEACHER_WINDOWED_MIN_T = 192
# Hand-written backward for the windowed teacher-forced top scan
# (models/teacher_scan.py). 'auto' = for training whenever the windowed
# path is selected and its cotangent stacks stay within
# _TEACHER_VJP_STACK_BUDGET bytes; 'on' forces it for any windowed call
# (and, below the windowed threshold, its dense forward for training);
# 'off' keeps autograd. The budget is the JAX package's.
_TEACHER_VJP = 'auto'
_TEACHER_VJP_STACK_BUDGET = 2.5e9
# Fused whole-sequence teacher kernels K6/K7 (ops/teacher_kernel.py):
# 'auto' takes them for training on CUDA tensors where
# `teacher_fused_supported` says so, 'on' forces `teacher_top_fused` (its
# plain versions on CPU tensors, for tests), 'off' disables them. Unlike
# the JAX package's Pallas kernels they take the encoder's padding mask,
# so mask_padding models train through them too.
_TEACHER_KERNEL = 'auto'
# The mesh (parallel/mesh.py) over whose 'data' axis the training batch
# in flight is sharded, None otherwise: `train_step` under a mesh sets it
# for its own call (None for a batch the data axis does not divide,
# which every rank holds whole). The kernels then launch on the rank's
# rows, and dropout masks are drawn at the global batch size, of which a
# rank keeps its rows.
_TRAIN_MESH = None


def _sequence_scan(xs, w, h0=None, c0=None, reverse=False, mask=None,
                   counted=False):
    """lstm_scan for every sequence recurrence of the model: the fused
    whole-sequence scan where it is supported, else the plain scan; a
    padding mask (mask_padding models' encoders) goes along either way.
    Under a training mesh the kernels launch on this rank's rows, and the
    mask is theirs. `counted` adds the scan to the tracer's
    ``decoders.encoder_scans``, and to ``decoders.encoder_kernel_scans``
    where the fused scan serves it."""
    rk = w['recurrent_kernel']
    fused = _FUSED_SCAN == 'on' or (
        _FUSED_SCAN != 'off' and xs.device.type == 'cuda'
        and (rk.dtype == torch.float32
             or (torch.is_grad_enabled()
                 and (xs.requires_grad or rk.requires_grad)))
        and fused_scan_supported(w, xs.shape[0], mesh=_TRAIN_MESH))
    if counted:
        profiling.count('decoders.encoder_scans')
        if fused:
            profiling.count('decoders.encoder_kernel_scans')
    scan = lstm_scan_fused if fused else lstm_scan
    return scan(xs, w, h0, c0, reverse=reverse, mask=mask)


def _dropout_keep(shape, rate, generator, device, batch_dim=None):
    """Bernoulli(1 - rate) keep mask drawn from `generator` (on its own
    device) and moved to `device`. `batch_dim` names the batch axis of
    `shape`: under a training mesh the mask is drawn for the global batch,
    as one process draws it, and this rank keeps its rows."""
    mesh = _TRAIN_MESH
    if mesh is not None and batch_dim is not None:
        n = shape[batch_dim]
        shape = list(shape)
        shape[batch_dim] = n * mesh.shape['data']
    keep = torch.rand(shape, generator=generator, device=generator.device)
    if mesh is not None and batch_dim is not None:
        keep = keep.narrow(batch_dim, mesh.data_index * n, n)
    return (keep < 1.0 - rate).to(device)


def _variational_dropout(out, config, generator):
    """Time-constant dropout on a layer's outputs (seq2seq.py:296-298):
    one mask per sample shared over time; `config.keras_dropout` shares
    it over the batch too, like the reference's noise_shape=(1, dim)."""
    shared = config.keras_dropout
    keep = _dropout_keep((1 if shared else out.shape[0], 1, out.shape[2]),
                         config.dropout, generator, out.device,
                         batch_dim=None if shared else 0)
    return torch.where(keep, out / (1.0 - config.dropout),
                       torch.zeros_like(out))


def cross_sum(x):
    """Deep-bidirectional fw/bw cross-summary (seq2seq.py:246-259)."""
    shape = x.shape
    y = torch.flip(x.reshape(shape[:-1] + (shape[-1] // 2, 2)), dims=(-1,))
    return x + y.reshape(shape)


def ensure_onehot(enc_input, config, params):
    """Expand a compact (B, T) integer index batch to (B, T, V) one-hot in
    the weight dtype; (B, T, V) inputs pass through unchanged.

    Index -1 (padding) maps to the zero row, like the host vectorizer
    (utils/data.py:lines_to_index_batch). ``torch.nn.functional.one_hot``
    rejects -1, so padding is masked by hand."""
    if enc_input.dim() != 2:
        return enc_input
    dt = params['char_embedding']['kernel'].dtype
    idx = enc_input.long()
    valid = (idx >= 0) & (idx < config.voc_size)
    onehot = torch.nn.functional.one_hot(
        torch.where(valid, idx, torch.zeros_like(idx)), config.voc_size)
    return (onehot * valid[..., None]).to(dt)


@profiling.traced('decoders.encode')
def encode(params, config: Seq2SeqConfig, enc_input, dropout_rng=None,
           train=False):
    """Run the encoder over (B, T, V) input.

    Returns (attended (B,T,A), [(h,c)] per decoder layer, u (B,T,W)).
    Without ``mask_padding``, padding runs through the recurrence
    unmasked, like the reference (seq2seq.py:1026-1043). The scans go
    through `_sequence_scan`; with `train` a ``torch.Generator`` as
    `dropout_rng` switches variational dropout on. Without `train` the
    tracer counts the scans (``decoders.encoder_scans``) and those the
    fused scan serves (``decoders.encoder_kernel_scans``).
    """
    depth, deep = config.depth, config.deep_bidirectional_encoder
    mask = enc_input.ne(0).any(dim=2) if config.mask_padding else None
    out = mm(enc_input, params['char_embedding']['kernel'])
    states = []

    def scan(xs, w, reverse=False):
        return _sequence_scan(xs, w, reverse=reverse, mask=mask,
                              counted=not train)

    for n in range(depth):
        lw = params['encoder'][n]
        if n == 0 or deep:
            inp = out if n == 0 else cross_sum(out)
            fw_out, _fh, _fc = scan(inp, lw['fw'])
            bw_out, h, c = scan(inp, lw['bw'], reverse=True)
            out = torch.cat([fw_out, bw_out], dim=-1)
        else:
            out2, h, c = scan(out, lw)
            if config.residual_connections and n >= 2:
                out = out2 + out
            else:
                out = out2
        if train and config.dropout > 0 and dropout_rng is not None:
            out = _variational_dropout(out, config, dropout_rng)
        if config.bridge_dense:
            bw_ = params['bridge'][n]
            h = torch.tanh(mm(h, bw_['h']['kernel']) + bw_['h']['bias'])
            c = torch.tanh(mm(c, bw_['c']['kernel']) + bw_['c']['bias'])
        states.append((h, c))
    u = mm(out, params['attention_dense']['kernel'])
    return out, states, u


def _output_probs(params, h):
    """Weight-tied softmax output projection (seq2seq.py:369-382)."""
    logits = mm(h, params['char_embedding']['kernel'].T)
    return softmax(logits, dim=-1)


def decode_step_fn(config: Seq2SeqConfig):
    """The per-step LSTM cell update honoring `use_pallas_lstm`: the
    hand-written CUDA LSTM step on CUDA tensors (its plain twin on CPU
    tensors), else the plain ``lstm_step``."""
    if config.use_pallas_lstm:
        from ..ops.lstm_step_kernel import lstm_step_auto
        return lstm_step_auto
    return lstm_step


def decoder_lower_stack(params, config: Seq2SeqConfig, feedback,
                        layer_states, step=None):
    """Embedding + the attention-free lower decoder layers.
    Returns (pre-top activation, new lower states)."""
    step = step or decode_step_fn(config)
    out = mm(feedback, params['char_embedding']['kernel'])
    new_states = []
    for n in range(config.depth - 1):
        h, c = step(out, *layer_states[n], params['decoder'][n])
        new_states.append((h, c))
        if config.residual_connections and n > 0:
            out = h + out
        else:
            out = h
    return out, new_states


def decoder_top_cell(params, config: Seq2SeqConfig, out, ctx, h_prev,
                     c_prev, step=None):
    """Top attention-cell update + weight-tied softmax readout.

    `out` is the lower-stack activation, `ctx` the float32 attention
    context (the concatenation promotes to float32 like ``jnp``'s, and
    ``mm`` then casts to the weight dtype). Returns (probs, (h, c))."""
    step = step or decode_step_fn(config)
    top = params['decoder'][config.depth - 1]
    cell_in = torch.cat([out.to(ctx.dtype), ctx], dim=-1)
    h, c = step(cell_in, h_prev, c_prev, top['cell'])
    if config.residual_connections and config.depth > 1:
        out = h + out
    else:
        out = h
    return _output_probs(params, out), (h, c)


def decoder_step(params, config: Seq2SeqConfig, feedback, states, attended,
                 u, enc_mask=None, shared_window=0, exclude=None):
    """One decoder step for all layers.

    feedback (B, V): previous softmax output; states: ([(h, c)] * depth,
    prev_alignment (B, T)). With `shared_window` > 0 the attention reads
    a batch-shared contiguous window (ops/attention.py); `exclude` (B,)
    marks lines that must not constrain it (finished lines).
    Returns (probs (B, V), new_states, alignment (B, T)).
    """
    depth = config.depth
    layer_states, prev_a = states
    step = decode_step_fn(config)
    out, new_states = decoder_lower_stack(params, config, feedback,
                                          layer_states, step)
    top = params['decoder'][depth - 1]
    h_prev, c_prev = layer_states[depth - 1]
    if shared_window:
        ctx, a = attention_step_shared(
            top['W_a'], top['v_a'], top['b_UW'], top['b_v'], h_prev,
            prev_a, attended, u, config.window_width,
            shared_width=shared_window, mask=enc_mask, exclude=exclude)
    else:
        ctx, a = attention_step(top['W_a'], top['v_a'], top['b_UW'],
                                top['b_v'], h_prev, prev_a, attended, u,
                                config.window_width, mask=enc_mask)
    probs, hc = decoder_top_cell(params, config, out, ctx, h_prev, c_prev,
                                 step)
    new_states.append(hc)
    return probs, (new_states, a), a


def forward_teacher(params, config: Seq2SeqConfig, enc_input, dec_input,
                    dropout_rng=None, train=False, lm=False):
    """Teacher-forced forward pass for training/evaluation.

    Returns probs (B, Td, V); with `lm`, a second unconditioned pass with
    tied weights on zeroed attention constants (reference lm_loss,
    seq2seq.py:321-322, 340-341, 355-356) returns (probs, lm_probs).

    Both inputs may be compact (B, T) integer index batches (-1 = zero
    row); they expand to one-hot on the device (ensure_onehot).
    `dropout_rng` is a ``torch.Generator``; it is advanced by every mask
    drawn.
    """
    enc_input = ensure_onehot(enc_input, config, params)
    dec_input = ensure_onehot(dec_input, config, params)
    attended, states, u = encode(params, config, enc_input, dropout_rng,
                                 train)
    enc_mask = enc_input.ne(0).any(dim=2) if config.mask_padding else None
    probs = _decode_teacher(params, config, dec_input, states, attended, u,
                            dropout_rng, train, enc_mask=enc_mask)
    if not lm:
        return probs
    zero_states = [(torch.zeros_like(h), torch.zeros_like(c))
                   for h, c in states]
    lm_probs = _decode_teacher(params, config, dec_input, zero_states,
                               torch.zeros_like(attended),
                               torch.zeros_like(u), dropout_rng, train,
                               enc_mask=enc_mask)
    return probs, lm_probs


def _decode_teacher(params, config, dec_input, states, attended, u,
                    dropout_rng=None, train=False, enc_mask=None):
    """The teacher-forced decoder: whole-sequence scans for the lower
    layers, then the top attention layer by one of four routes, chosen
    like the JAX package's ``_decode_teacher``:

    - the fused kernels K6/K7 (`teacher_top_fused`) for training, with
      the padding mask where the model has one (the JAX package's
      kernels take none), where `_TEACHER_KERNEL` allows;
    - `teacher_top_scan` (windowed, hand-written backward) for training
      of long lines, or when `_TEACHER_VJP` forces it;
    - the windowed per-step body for forward-only long lines;
    - the dense per-step body otherwise (eval, training with the kernels
      off or on CPU tensors below the windowed threshold, global
      attention). Under autograd it keeps
      every step's (B, T, W) energy tanh for the backward pass, where
      the JAX package rematerialises it: Td*B*T*W values of the weight
      dtype at once."""
    depth = config.depth
    B, Td, V = dec_input.shape
    out = mm(dec_input, params['char_embedding']['kernel'])
    dropping = train and config.dropout > 0 and dropout_rng is not None
    # plain lower decoder layers: full scan with hoisted input projection
    for n in range(depth - 1):
        h0, c0 = states[n]
        out2, _, _ = _sequence_scan(out, params['decoder'][n], h0, c0)
        if config.residual_connections and n > 0:
            out = out2 + out
        else:
            out = out2
        if dropping:
            out = _variational_dropout(out, config, dropout_rng)
    # top layer: attention and cell update per decoder step
    top = params['decoder'][depth - 1]
    W, A, ww = config.width, config.attended_size, config.window_width
    h0, c0 = states[depth - 1]
    masks = None
    if dropping:
        # per-gate masks on the cell input, constant over time
        masks = (_dropout_keep((4, B, W + A), config.dropout, dropout_rng,
                               out.device, batch_dim=1).float()
                 / (1.0 - config.dropout))
    T_enc = attended.shape[1]
    WIN = min(2 * ww + 2, T_enc)
    use_windowed = (ww > 0 and _TEACHER_ATTENTION != 'dense'
                    and (_TEACHER_ATTENTION == 'windowed'
                         or T_enc >= _TEACHER_WINDOWED_MIN_T))
    # the manual backward emits (Td, B, WIN, ~2W) cotangent stacks; at
    # very large B*Td they dominate device memory, so such shapes keep
    # autograd through the dense body
    itemsize = attended.element_size()
    vjp_stack_bytes = (
        # du_w/datt_w + dx/dz/dwvec/ctx/h/c stacks in the weight dtype
        (Td * B * WIN * (W + A) + Td * B * 7 * W) * itemsize
        # the window index stack
        + Td * B * WIN * 4
        # float32 du (B, T, W) + datt (B, T, A) scatter accumulators
        + B * T_enc * (W + A) * 4)
    use_manual_vjp = (_TEACHER_VJP != 'off'
                      and _TEACHER_ATTENTION != 'dense'
                      and ww > 0
                      and (use_windowed or (train and _TEACHER_VJP == 'on'))
                      and (_TEACHER_VJP == 'on'
                           or (train and vjp_stack_bytes
                               <= _TEACHER_VJP_STACK_BUDGET)))
    if train and use_windowed and not use_manual_vjp \
            and _TEACHER_ATTENTION != 'windowed':
        # when the manual backward is off or over its budget, train
        # dense instead of autograd through the windowed gathers
        use_windowed = False
    use_kernel = False
    if train and _TEACHER_KERNEL != 'off' and ww > 0 \
            and _TEACHER_ATTENTION != 'dense':
        use_kernel = _TEACHER_KERNEL == 'on' or teacher_fused_supported(
            top, B, Td, T_enc, W, A, ww=ww, mesh=_TRAIN_MESH)
    if train:
        profiling.count('training.teacher_calls')
        if use_kernel:
            profiling.count('training.teacher_kernel_calls')
    if use_kernel:
        out2 = teacher_top_fused(top, out, attended, u, h0, c0, masks, ww,
                                 enc_mask)
    elif use_manual_vjp:
        mask_f = (enc_mask.to(attended.dtype) if enc_mask is not None
                  else None)
        out2 = teacher_top_scan(top, out, attended, u, h0, c0, mask_f,
                                masks, ww, WIN, not use_windowed)
    else:
        out2 = _teacher_body(top, out, attended, u, h0, c0, masks, ww,
                             WIN if use_windowed else 0, enc_mask)
    if config.residual_connections and depth > 1:
        out = out2 + out
    else:
        out = out2
    return _output_probs(params, out)


def _teacher_body(top, xs, attended, u, h, c, masks, ww, WIN, enc_mask):
    """The top layer step by step under autograd: the dense body over
    the full encoder length, or with `WIN` > 0 the windowed body
    (`_windowed_attention` carry), which is identical in value since the
    rows it skips are masked anyway. Returns hs (B, Td, W)."""
    B = xs.shape[0]
    dt, dev = attended.dtype, attended.device
    if WIN:
        aw = torch.zeros((B, WIN), dtype=dt, device=dev)
        astart = torch.zeros((B,), dtype=torch.int32, device=dev)
    else:
        a = torch.zeros(attended.shape[:2], dtype=dt, device=dev)
        # the context is a float32 sum over float32 values: convert the
        # attended sequence once, not once per step
        attended_f = attended.float()
    hs = []
    for t in range(xs.shape[1]):
        if WIN:
            ctx, aw, astart = _windowed_attention(
                top, h, aw, astart, attended, u, ww, SHARED_WINDOW,
                enc_mask=enc_mask)
        else:
            ctx, a = attention_step(top['W_a'], top['v_a'], top['b_UW'],
                                    top['b_v'], h, a, attended_f, u, ww,
                                    mask=enc_mask)
        cell_in = torch.cat([xs[:, t].to(ctx.dtype), ctx], dim=-1)
        h, c = gate_math(
            attention_cell_preact(top['cell'], cell_in, h, masks), c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _greedy_pick(probs):
    """argmax over indices >= 1 (lowest index on ties) and its prob."""
    idx = torch.argmax(probs[:, 1:], dim=1).to(torch.int32) + 1
    p = torch.gather(probs, 1, idx[:, None].long())[:, 0]
    return idx, p


class _GreedyState:
    """Per-batch output buffers and termination bookkeeping shared by
    both greedy decoders."""

    def __init__(self, enc_input, S, T, dt, return_alignments):
        B, dev = enc_input.shape[0], enc_input.device
        self.S = S
        self.t = 0
        self.done = ~enc_input.reshape(B, -1).ne(0).any(dim=1)
        self.out_idx = torch.zeros((B, S), dtype=torch.int32, device=dev)
        self.out_prob = torch.zeros((B, S), dtype=dt, device=dev)
        self.length = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.score = torch.zeros((B,), dtype=torch.float32, device=dev)
        self.out_align = (torch.zeros((B, S, T), dtype=dt, device=dev)
                          if return_alignments else None)

    def running(self):
        return self.t < self.S and not bool(self.done.all())

    def record(self, probs, newline_idx, align_row=None):
        idx, p = _greedy_pick(probs)
        active = ~self.done
        t = self.t
        self.out_idx[:, t] = torch.where(active, idx, torch.zeros_like(idx))
        self.out_prob[:, t] = torch.where(active, p, torch.zeros_like(p))
        self.length += active.to(torch.int32)
        self.score += torch.where(active, -torch.log(p.float()),
                                  torch.zeros_like(self.score))
        self.done = self.done | (active & (idx == newline_idx))
        if self.out_align is not None:
            self.out_align[:, t, :] = torch.where(
                active[:, None], align_row, torch.zeros_like(align_row))
        self.t = t + 1

    def result(self):
        lengths = torch.clamp(self.length, min=1)
        return (self.out_idx, self.out_prob, self.length,
                self.score / lengths, self.out_align)


def decode_greedy(params, config: Seq2SeqConfig, enc_input, newline_idx,
                  max_steps=None, return_alignments=False):
    """Greedy batch decode with softmax feedback, attention through the
    batch-shared window (exact dense fallback when live alignments
    spread wider); see `decode_greedy_windowed` for long lines.

    Returns (indices (B,S) int32, probs (B,S), lengths (B,), scores (B,),
    alignments (B,S,T) or None).
    """
    enc_input = ensure_onehot(enc_input, config, params)
    B, T, V = enc_input.shape
    S = 2 * T if max_steps is None else max_steps
    attended, states, u = encode(params, config, enc_input)
    dt = attended.dtype
    enc_mask = enc_input.ne(0).any(dim=2) if config.mask_padding else None
    st = _GreedyState(enc_input, S, T, dt, return_alignments)
    feedback = torch.zeros((B, V), dtype=dt, device=enc_input.device)
    layers = list(states)
    align = torch.zeros((B, T), dtype=dt, device=enc_input.device)
    while st.running():
        feedback, (layers, align), _ = decoder_step(
            params, config, feedback, (layers, align), attended, u,
            enc_mask=enc_mask, shared_window=SHARED_WINDOW,
            exclude=st.done)
        st.record(feedback, newline_idx, align)
    return st.result()


def _windowed_attention(top, h_prev, aw, astart, attended, u, ww,
                        shared_width, exclude=None, enc_mask=None):
    """Attention step over windowed state (aw (B,WIN) + astart (B,)).

    Fast path: when every live line's window fits inside one contiguous
    batch-shared slice [lo, lo+shared_width), read that slice and
    re-window per line. Fallback: per-line gathers of the WIN visible
    rows. Both branches see the identical visible position set; the JAX
    ``lax.cond`` on `fits` is a host-side ``if`` here.

    Returns (ctx (B, A) float32, aw (B, WIN), astart (B,)).
    """
    B, T, A = attended.shape
    dev = attended.device
    WIN = aw.shape[-1]
    SW = min(shared_width, T)
    # t0 in float32 regardless of serving dtype: bf16 positions >= 128
    # have ulp 1
    offs = torch.arange(WIN, dtype=torch.float32, device=dev)
    t0 = (aw.float() * (astart[:, None].float() + offs)).sum(dim=-1) + 1.0
    new_start = torch.clamp(torch.floor(t0).to(torch.int32) - ww, 0,
                            max(T - WIN, 0))
    w_vec = mm(h_prev, top['W_a']) + top['b_UW']

    def finish(s_en, positions, rows_att, mask_rows):
        visible = torch.abs(t0[:, None] - positions.float()) <= ww
        if mask_rows is not None:
            visible = visible & mask_rows
        s_m = torch.where(visible, s_en, torch.full_like(s_en, -1e30))
        a = softmax(s_m, dim=-1)
        a = a * visible.any(dim=-1, keepdim=True).to(a.dtype)
        ctx = (a.float()[:, :, None] * rows_att.float()).sum(dim=1)
        return a, ctx

    def energies(u_rows):
        return (mm(torch.tanh(w_vec[:, None, :] + u_rows),
                   top['v_a'])[..., 0] + top['b_v'])

    def gather():
        win_ix = torch.clamp(
            new_start[:, None].long()
            + torch.arange(WIN, device=dev), max=T - 1)
        rows = torch.arange(B, device=dev)[:, None]
        u_w = u[rows, win_ix]                              # (B, WIN, W)
        att_w = attended[rows, win_ix]
        m_w = enc_mask[rows, win_ix] if enc_mask is not None else None
        a, ctx = finish(energies(u_w), win_ix, att_w, m_w)
        return ctx, a

    def shared(lo):
        u_s = u[:, lo:lo + SW]
        att_s = attended[:, lo:lo + SW]
        pos = (lo + torch.arange(SW, device=dev)).expand(B, SW)
        m_s = enc_mask[:, lo:lo + SW] if enc_mask is not None else None
        a_s, ctx = finish(energies(u_s), pos, att_s, m_s)
        # re-window: each line's WIN columns start at new_start - lo
        ix = torch.clamp((new_start - lo)[:, None].long()
                         + torch.arange(WIN, device=dev), 0, SW - 1)
        return ctx, torch.gather(a_s, 1, ix)

    if T <= SW:
        ctx, a = shared(0)
        return ctx, a, new_start
    if exclude is not None:
        ns_lo = torch.where(exclude, torch.full_like(new_start, T), new_start)
        ns_hi = torch.where(exclude, torch.zeros_like(new_start), new_start)
    else:
        ns_lo = ns_hi = new_start
    lo_min, hi_max = (int(v) for v in torch.stack(
        [ns_lo.min(), ns_hi.max()]).tolist())
    lo = min(max(lo_min, 0), T - SW)
    if hi_max + WIN - lo_min <= SW:
        ctx, a = shared(lo)
    else:
        ctx, a = gather()
    return ctx, a, new_start


def decode_greedy_windowed(params, config: Seq2SeqConfig, enc_input,
                           newline_idx, max_steps=None,
                           return_alignments=False):
    """Greedy batch decode with windowed attention (long-line variant,
    models/api.py:WINDOWED_DECODE_MIN_T). Same contract as
    `decode_greedy`: only the WIN = 2*window_width+2 positions around the
    previous expected source position are read, which is identical to
    full-T attention since everything else is masked anyway.

    Returns (indices (B,S) int32, probs (B,S), lengths (B,), scores (B,),
    alignments (B,S,T) or None).
    """
    enc_input = ensure_onehot(enc_input, config, params)
    B, T, V = enc_input.shape
    dev = enc_input.device
    S = 2 * T if max_steps is None else max_steps
    depth = config.depth
    WIN = min(2 * config.window_width + 2, T)
    attended, states, u = encode(params, config, enc_input)
    dt = attended.dtype
    enc_mask = enc_input.ne(0).any(dim=2) if config.mask_padding else None
    top = params['decoder'][depth - 1]
    step = decode_step_fn(config)
    st = _GreedyState(enc_input, S, T, dt, return_alignments)
    feedback = torch.zeros((B, V), dtype=dt, device=dev)
    layers = list(states)
    aw = torch.zeros((B, WIN), dtype=dt, device=dev)
    astart = torch.zeros((B,), dtype=torch.int32, device=dev)
    while st.running():
        out, new_states = decoder_lower_stack(params, config, feedback,
                                              layers, step)
        h_prev, c_prev = layers[depth - 1]
        ctx, aw, astart = _windowed_attention(
            top, h_prev, aw, astart, attended, u, config.window_width,
            SHARED_WINDOW, exclude=st.done, enc_mask=enc_mask)
        feedback, hc = decoder_top_cell(params, config, out, ctx, h_prev,
                                        c_prev, step)
        layers = new_states + [hc]
        row = None
        if return_alignments:
            win_ix = torch.clamp(astart[:, None].long()
                                 + torch.arange(WIN, device=dev), max=T - 1)
            row = torch.zeros((B, T), dtype=aw.dtype, device=dev)
            row.scatter_add_(1, win_ix, aw)
        st.record(feedback, newline_idx, row)
    return st.result()
