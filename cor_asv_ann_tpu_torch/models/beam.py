"""A*-like beam search with rejection thresholding, batched on the device.

Port of the JAX package's ``models/beam.py`` (reference beam decoder
lib/seq2seq.py:1356-1544 `decode_sequence_beam`, `Node` trie
:1546-1608). The reference keeps an *unbounded best-first queue* of
hypothesis nodes and expands up to batch_size of them per iteration;
unexpanded nodes persist and can win later (A*). Here each line carries
a fixed **reservoir** of R node slots ordered by prospective cost; every
iteration the best K unexpanded nodes are stepped through the decoder
(lines-parallel and hypotheses-parallel), their K*C candidate children
are merged back into the reservoir (keep best R), and finished
hypotheses go to a bank of F solutions.

The local monotonic attention window (+-5 around the expected source
position) leaves at most 11 positions visible, so the beam carries only
the *windowed* alignment (WIN values + window start) per node, and each
step gathers just the WIN relevant rows of the encoder output and
projection. This is identical to the full computation (everything
outside the window is masked to zero anyway).

Semantics carried over from the reference:
- candidate admission per node: top `beam_width_in` by probability, cut
  at the relative threshold `highest * beam_threshold_in`
  (seq2seq.py:1472-1480); index 0 (underspecification) excluded,
- **rejection**: the input character at the currently aligned source
  position is boosted to `rejection_threshold` probability and
  guaranteed admission, when the hypothesis is still aligned
  (misalignment < 0.1) or the previous choice was a rejection; a
  rejection choice gets a one-hot alignment marker (seq2seq.py:1441-1496),
- decoder feedback for a candidate ranked r is the full (boosted) score
  vector with the r better-ranked maxima zeroed (seq2seq.py:1515-1520),
- node ordering by prospective cost cum + cost0*|length - len0| with
  cost0 = 3 (Node.pro_cost, seq2seq.py:1588-1595),
- termination after 2*len0 iterations, or early once strictly more than
  beam_width_out solutions exist and the best of them strictly beats the
  best queued node's prospective cost (seq2seq.py:1417-1419): the bank
  internally holds beam_width_out+1 slots for exactly this test.

Deviations from the reference, as in the JAX package: the queue is
bounded by R per line; `len0` is passed by the caller; per-step soft
alignments are recorded as windowed rows (WIN floats + a start offset);
finals popped past the bank's F best are dropped.

What differs from the JAX package, and why:
- row selection is ``torch.gather``/indexing, which is exact (the JAX
  one-hot matmuls exist for the TPU's matrix unit);
- ``jax.lax.top_k`` returns the lowest index first among equal values
  and the search depends on it (dead slots are all ``inf``, boosted
  candidates all sit at exactly the threshold): `_top_k` is a stable
  descending sort, since ``torch.topk`` promises no order among ties;
- the ``lax.while_loop`` is a Python loop that reads the number of
  lines not yet done on the host once per iteration (which the tracer
  of utils/profiling.py also counts), each iteration a
  ``decoders.beam_iteration`` span, and the reverse ``lax.scan``
  backtrace a loop on the device over the iterations that ran; on a
  CUDA device the loop's body, `_iteration`, is captured once per shape
  and model as a CUDA graph and each iteration is one replay of it
  (`_BEAM_GRAPH`): one graph launch and one host read an iteration in
  place of some 430 launches;
- the decoder step has a second route through the fused CUDA kernel
  K3 (ops/decode_step_kernel.py), see `_BEAM_STEP_KERNEL`, which reads
  the window rows by index instead of gathering them.
"""

import collections
import dataclasses
import threading

import torch

from ..ops.attention import NEG, softmax
from ..ops.decode_step_kernel import (fused_decode_step_indexed,
                                      fused_step_supported, pack_weights,
                                      step_covers)
from ..ops.lstm import mm
from ..utils import profiling
from . import seq2seq
from .config import Seq2SeqConfig
from .seq2seq import encode, ensure_onehot

INF = float('inf')
F32 = torch.float32
# The fused decode-step kernel K3 as the beam's step: 'auto' takes it
# where `fused_step_supported` holds and the parameters are bfloat16 (the
# rule of the fused greedy kernel: every byte-pinned golden is float32 and
# stays on the plain route), 'on' takes it for float32 parameters too
# (its plain version on CPU tensors, for tests) and raises for a model it
# does not cover, 'off' never launches it.
_BEAM_STEP_KERNEL = 'auto'
# The beam's iteration as a CUDA graph: 'auto' replays one captured
# iteration a step of the search on CUDA tensors (`_GraphCache`; calls
# with `return_trace`, and those the cache declines, run op by op), 'off'
# runs every iteration op by op. 'buffers' is for tests only: the graph
# route's static buffers and cache on any device, each replay run op by
# op (what the CPU tests hold against 'off').
_BEAM_GRAPH = 'auto'


@dataclasses.dataclass(frozen=True)
class BeamParams:
    reservoir: int = 64        # queued node slots R per line
    expand: int = 48           # nodes expanded per iteration K
    beam_width_in: int = 15    # max candidates admitted per node C
    beam_threshold_in: float = 0.2  # relative admission threshold
    beam_width_out: int = 16   # finished-hypothesis bank size F
    rejection_threshold: float = 0.3
    cost0: float = 3.0         # per-char cost for the length prior
    # rate hypotheses by an unconditioned LM readout (same weights, zero
    # attention context) while decoder scores control beam entry
    # (reference lm_predict, seq2seq.py:144-149, 1431-1434, 1488-1490)
    lm_predict: bool = False


def _top_k(x, k):
    """The k largest values along the last axis and their indices, the
    lowest index first among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _take(x, ix):
    """Rows x[b, ix[b, k]]: x (B, n, ...), ix (B, k) int64 -> (B, k, ...)."""
    tail = x.shape[2:]
    index = ix.reshape(ix.shape + (1,) * len(tail)).expand(ix.shape + tail)
    return torch.gather(x, 1, index)


def _step_kernel_route(params, config, with_lm):
    """Whether a step goes through K3 (see `_BEAM_STEP_KERNEL`; 'auto'
    takes bfloat16 buckets of every length, since the window positions
    that K3 receives are computed outside it)."""
    if _BEAM_STEP_KERNEL == 'off':
        return False
    if _BEAM_STEP_KERNEL == 'on':
        if not step_covers(config, with_lm):
            raise ValueError('_BEAM_STEP_KERNEL = "on": the fused decode '
                             'step covers depth 2 without residual '
                             'connections, with a local window and without '
                             'the LM readout only')
        return True
    return (params['char_embedding']['kernel'].dtype == torch.bfloat16
            and fused_step_supported(params, config, with_lm))


def beam_decoder_step(params, config, feedback, layer_states, aw, astart,
                      attended, u, with_lm=False, src_lengths=None,
                      step_weights=None):
    """One decoder step over (B, K) hypotheses with windowed attention.

    feedback (B,K,V); layer_states: sequence of (h, c) each (B,K,W);
    aw (B,K,WIN) windowed previous alignment with window starts astart
    (B,K). attended (B,T,A) and u (B,T,W) are shared per line.
    Returns (probs (B,K,V), new_layer_states, new_aw, new_astart,
    expected_pos (B,K) float32); with `with_lm` an unconditioned LM
    readout over the same input states (zero attention context,
    discarded LM states) is appended: (..., lm_probs (B,K,V)).

    On the K3 route (`_BEAM_STEP_KERNEL`) the (B, K) hypotheses are
    flattened to rows, line by line, and the rest of the step is one
    launch of `fused_decode_step_indexed`, which reads each row's window
    rows of `u` and `attended` by index (no gathered copy), with
    `step_weights` (its `pack_weights`, packed here when None); probs
    come back float32, the states and the alignment rounded once to the
    dtypes they came in. The per-op route gathers the window rows.
    """
    depth = config.depth
    ww = config.window_width
    B, K, V = feedback.shape
    T = attended.shape[1]
    WIN = aw.shape[-1]
    dev = attended.device
    # expected previous source position t0 = prev_a . arange + 1, in the
    # compute dtype, as the JAX beam computes it (bfloat16 rounding moves
    # window edges off float32's in every bucket)
    pdt = aw.dtype
    offs = torch.arange(WIN, dtype=pdt, device=dev)
    t0 = (aw * (astart[..., None].to(pdt) + offs)).sum(dim=-1) + 1.0
    # new window around t0
    new_start = torch.clamp(torch.floor(t0).long() - ww, 0, max(T - WIN, 0))
    win_ix = torch.clamp(new_start[..., None]
                         + torch.arange(WIN, device=dev), max=T - 1)
    win_f = win_ix.to(pdt)
    visible = torch.abs(t0[..., None] - win_f) <= ww
    if src_lengths is not None:
        visible = visible & (win_ix < src_lengths[:, None, None])
    new_start = new_start.to(torch.int32)

    def flat(x):
        return x.reshape((B * K,) + x.shape[2:])

    def unflat(x):
        return x.reshape((B, K) + x.shape[1:])

    if _step_kernel_route(params, config, with_lm):
        if step_weights is None:
            step_weights = pack_weights(
                params, params['char_embedding']['kernel'].dtype)
        (h1, c1), (h2, c2) = layer_states
        probs, h1n, c1n, h2n, c2n, align = fused_decode_step_indexed(
            flat(feedback), flat(h1), flat(c1), flat(h2), flat(c2), u,
            attended, K, flat(new_start), flat(visible), step_weights)
        exp_pos = (unflat(align).to(pdt) * win_f).sum(dim=-1).to(F32)
        new_states = ((unflat(h1n.to(h1.dtype)), unflat(c1n.to(c1.dtype))),
                      (unflat(h2n.to(h2.dtype)), unflat(c2n.to(c2.dtype))))
        return (unflat(probs), new_states, unflat(align.to(aw.dtype)),
                new_start, exp_pos)

    rows = torch.arange(B, device=dev)[:, None, None]
    u_w = u[rows, win_ix]                                  # (B,K,WIN,W)
    att_w = attended[rows, win_ix]                         # (B,K,WIN,A)
    step = seq2seq.decode_step_fn(config)
    states = [(flat(h), flat(c)) for h, c in layer_states]
    out, new_states = seq2seq.decoder_lower_stack(params, config,
                                                  flat(feedback), states, step)
    top = params['decoder'][depth - 1]
    h_prev, c_prev = states[depth - 1]
    vis = flat(visible)
    w_vec = mm(h_prev, top['W_a']) + top['b_UW']
    s_en = (mm(torch.tanh(w_vec[:, None, :] + flat(u_w)), top['v_a'])[..., 0]
            + top['b_v'])                                  # (N, WIN)
    s_en = torch.where(vis, s_en, torch.full_like(s_en, NEG))
    a_w = softmax(s_en, dim=-1)
    a_w = a_w * vis.any(dim=-1, keepdim=True).to(a_w.dtype)
    ctx = torch.einsum('nw,nwa->na', a_w.to(F32), flat(att_w).to(F32))
    probs, hc = seq2seq.decoder_top_cell(params, config, out, ctx, h_prev,
                                         c_prev, step)
    new_states.append(hc)
    exp_pos = (a_w.to(pdt) * flat(win_f)).sum(dim=-1).to(F32)
    result = (unflat(probs),
              tuple((unflat(h), unflat(c)) for h, c in new_states),
              unflat(a_w), new_start, unflat(exp_pos))
    if not with_lm:
        return result
    # LM readout: same layers and input states (so the same lower-stack
    # activation), zero attention context, states discarded
    lm_probs, _ = seq2seq.decoder_top_cell(params, config, out,
                                           torch.zeros_like(ctx), h_prev,
                                           c_prev, step)
    return result + (unflat(lm_probs),)


@dataclasses.dataclass(frozen=True, eq=False)
class _Search:
    """What one call of `decode_beam` holds fixed over its iterations:
    the model, the bounds, the sizes, the dtype of the states and the
    packed weights of K3 (None on the per-op route)."""
    params: dict
    config: Seq2SeqConfig
    bp: BeamParams
    newline_idx: int
    B: int
    T: int
    V: int
    R: int
    K: int
    F: int
    C: int
    S: int
    WIN: int
    dtype: torch.dtype
    return_alignments: bool
    step_weights: dict = None


def _initial_state(s, enc_input, states, len0):
    """The search's state before its first iteration, as a dict of
    tensors: the reservoir, the trie records, the bank, `done` and the
    iteration `t` (a device scalar)."""
    B, R, S, F, WIN = s.B, s.R, s.S, s.F, s.WIN
    dev, dt = enc_input.device, s.dtype
    i32, i64 = torch.int32, torch.int64

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def tile_r(x):  # (B, ...) -> (B, R, ...)
        return x[:, None].expand((B, R) + x.shape[1:])

    st = {}
    for n, (hh, cc) in enumerate(states):
        st['h%d' % n], st['c%d' % n] = tile_r(hh), tile_r(cc)
    # reservoir; slot 0 is the root node, others dead (pro = INF)
    root = torch.arange(R, device=dev) == 0
    root_cost = torch.where(root, 0.0, INF).to(F32)               # (R,)
    st.update(
        aw=zeros((B, R, WIN), dt),
        astart=zeros((B, R), i32),
        # rejection bookkeeping, separate from the attention state: the
        # reference stores the one-hot marker in the NODE's alignment
        # only, while the decoder state keeps the raw soft alignment
        # (seq2seq.py:1510-1521), so the attention keeps windowing on the
        # soft distribution even through rejection chains. book_pos =
        # expected source position of the bookkeeping alignment (src_pos
        # for rejection nodes, the soft expectation otherwise); book_max1
        # = max(bookkeeping alignment) == 1.0, the reference's
        # rejection-chain marker
        book_pos=zeros((B, R), F32),
        book_max1=zeros((B, R), torch.bool),
        feedback=zeros((B, R, s.V), dt),
        cum=root_cost[None].expand(B, R),
        pro=root_cost[None] + s.bp.cost0 * torch.abs(1.0 - len0[:, None]),
        nchars=zeros((B, R), i32),
        # finished (newline-terminated) hypotheses stay in the reservoir
        # and compete by prospective cost; they move to the bank exactly
        # when they would pop in the reference's best-first skim: when
        # they outrank the K-th active of an iteration
        # (seq2seq.py:1400-1415)
        is_fin=zeros((B, R), torch.bool),
        # backpointer trie: each iteration records, per post-merge slot,
        # its parent slot in the previous iteration's numbering and the
        # char it appended (-1 for carried-over slots); the texts are
        # rebuilt by one reverse walk after the loop
        rec_char=torch.full((B, S, R), -1, dtype=i32, device=dev),
        rec_p=zeros((B, S, R), dt),
        rec_ap=zeros((B, S, R), i32),
        rec_parent=zeros((B, S, R), i64),
        bank_cost=torch.full((B, F), INF, dtype=F32, device=dev),
        bank_cum=torch.full((B, F), INF, dtype=F32, device=dev),
        bank_len=zeros((B, F), i32),
        bank_t=zeros((B, F), i32),
        bank_parent=zeros((B, F), i64),
        done=~enc_input.reshape(B, -1).ne(0).any(dim=1),
        t=zeros((), i64))
    if s.return_alignments:
        st.update(rec_arow=zeros((B, S, R, WIN), dt),
                  rec_astart=zeros((B, S, R), i32))
    return st


def _iteration(s, inp, st, trace=None):
    """One iteration of the search: the state after it from the state
    `st` before it (`_initial_state`'s keys), over the call's inputs
    `inp` (the encoder's outputs, the source and its lengths, two
    constants). The trie records of iteration ``st['t']`` are written in
    place, into `st`'s buffers and `trace`'s; the result's other entries
    are new tensors. What it launches depends on `s` and the shapes
    alone, and it reads nothing on the host, so that `_BeamGraph` can
    capture it."""
    B, T, V, R, K, F, C = s.B, s.T, s.V, s.R, s.K, s.F, s.C
    CC = C + 1
    bp, dt = s.bp, s.dtype
    rt = bp.rejection_threshold
    dev = inp['attended'].device
    i32 = torch.int32
    inf, slots, len0 = inp['inf'], inp['slots'], inp['len0']
    src_top, src_any = inp['src_top'], inp['src_any']
    done, pro, cum, nchars = st['done'], st['pro'], st['cum'], st['nchars']
    is_fin, book_pos, book_max1 = st['is_fin'], st['book_pos'], st['book_max1']
    aw, astart, feedback = st['aw'], st['astart'], st['feedback']
    bank_cost, bank_cum, bank_len = (st['bank_cost'], st['bank_cum'],
                                     st['bank_len'])
    bank_t, bank_parent = st['bank_t'], st['bank_parent']
    h = [(st['h%d' % n], st['c%d' % n]) for n in range(s.config.depth)]
    t = st['t']
    at_t = t.reshape(1)

    def g1(x, ix):
        return torch.gather(x, 1, ix)

    def put(buf, value):
        """buf[:, t] = value, at the device's t."""
        buf.index_copy_(1, at_t, value.unsqueeze(1).to(buf.dtype))

    # --- pick the K best ACTIVE nodes per line for expansion ----------
    # (the reference pops best-first, skimming '\n' nodes into
    # final_beam along the way, until the fringe holds batch_size
    # actives, seq2seq.py:1400-1415: finals never consume expansion
    # slots, and exactly the finals that outrank the K-th active pop
    # before the fringe fills)
    active_pro = torch.where(is_fin, inf, pro)
    neg, exp_ix = _top_k(-active_pro, K)                          # (B, K)
    exp_pro = -neg
    exp_ok = torch.isfinite(exp_pro) & ~done[:, None]
    e_cum = g1(cum, exp_ix)
    e_nchars = g1(nchars, exp_ix)

    # --- bank queued finals that pop before the fringe fills ----------
    # a final pops iff it ranks better than the K-th active; when the
    # queue holds fewer than K actives the reference drains it
    # completely, banking every final
    kth = torch.where(torch.isfinite(exp_pro).all(dim=1),
                      exp_pro[:, -1], inf)                        # (B,)
    fin_bank = (is_fin & torch.isfinite(pro) & (pro < kth[:, None])
                & ~done[:, None])
    fin_cost = torch.where(fin_bank, pro, inf)                    # (B, R)
    neg3, bsel = _top_k(-torch.cat([bank_cost, fin_cost], dim=1), F)
    nb_cost = -neg3
    b_old = bsel < F
    b_oix = torch.clamp(bsel, max=F - 1)
    bk = torch.clamp(bsel - F, min=0)                     # (B, F) into R

    def bfield(old, new_r):
        return torch.where(b_old, g1(old, b_oix), g1(new_r, bk))

    nb_cum = bfield(bank_cum, cum)
    nb_len = bfield(bank_len, nchars)
    # the banked node's text is its trie chain up to iteration t: the
    # backtrace starts at its start-of-t slot index
    nb_t = bfield(bank_t, t.to(i32).expand(B, R))
    nb_parent = bfield(bank_parent, slots)

    # --- reference early stop (seq2seq.py:1417-1419): strictly more
    # --- than beam_width_out finals found AND the best final strictly
    # --- beats the best active selected this iteration ----------------
    bank_full = torch.isfinite(nb_cost[:, -1])
    best_active = torch.where(exp_ok[:, 0], exp_pro[:, 0], inf)
    stop = bank_full & (nb_cost[:, 0] < best_active)
    e_bpos = g1(book_pos, exp_ix)
    e_wasrej = g1(book_max1, exp_ix)

    # --- decoder step for the expansion set ---------------------------
    step_out = beam_decoder_step(
        s.params, s.config, _take(feedback, exp_ix),
        [(_take(hh, exp_ix), _take(cc, exp_ix)) for hh, cc in h],
        _take(aw, exp_ix), g1(astart, exp_ix), inp['attended'], inp['u'],
        with_lm=bp.lm_predict, src_lengths=inp['lengths'],
        step_weights=s.step_weights)
    probs, n_h, a_w, a_start, new_exp = step_out[:5]

    # --- rejection candidate (seq2seq.py:1441-1470) -------------------
    # the previous position comes from the BOOKKEEPING alignment
    # (src_pos for rejection nodes, the soft expectation otherwise),
    # new_exp is this step's soft expectation: the reference's
    # prev_source_pos/source_pos pair
    first = e_nchars == 0
    misal = torch.where(first, torch.zeros_like(new_exp),
                        torch.abs(new_exp - e_bpos - 1.0))
    rounded = torch.round(new_exp).long()
    src_pos = torch.where(e_wasrej, e_bpos.long() + 1, rounded)
    src_pos = torch.clamp(torch.where(first, torch.zeros_like(src_pos),
                                      src_pos), 0, T - 1)
    rej_idx = g1(src_top, src_pos)
    # an unmapped source char is index 0 (underspecification), which the
    # reference never admits as a candidate, not even via the rejection
    # path (seq2seq.py:1504-1506)
    rej_ok = ((rt > 0) & ((misal < 0.1) | e_wasrej | first)
              & g1(src_any, src_pos) & (rej_idx != 0))
    # candidate SCORING runs in float32 even under bfloat16 compute: the
    # boost clamps candidates to exactly the threshold, and a bfloat16
    # clamp value (0.30078125 for 0.3) would drift a clamped chain's cost
    # by n*0.0026 against float32 serving. With thresholds, ordering and
    # admission in float32 the tie structure matches float32 serving
    probs_f = probs.to(F32)
    rej_p = torch.gather(probs_f, 2, rej_idx[..., None])[..., 0]
    boost = rej_ok & (rej_p < rt)
    clamp = (torch.arange(V, device=dev) == rej_idx[..., None]) \
        & boost[..., None]
    probs_adj = probs_f.masked_fill(clamp, rt)
    # the feedback copy stays in the model's dtype (it re-enters the
    # decoder step like the reference's score vector)
    probs_adj_fb = probs.to(dt).masked_fill(clamp, rt)

    # --- candidate admission ------------------------------------------
    # top-C by (boosted) probability plus one dedicated slot for the
    # rejection candidate: the reference admits it *in addition* to
    # every threshold-admitted candidate (seq2seq.py:1480-1501). The
    # underspecification char (index 0) stays IN the ranking: the
    # reference scans it, counts it against the beam width, lets it
    # define `highest`, and only then skips it
    cand_p, cand_idx = _top_k(probs_adj, C)                       # (B, K, C)
    valid = ((cand_p >= cand_p[..., :1] * bp.beam_threshold_in)
             & (cand_idx != 0))
    in_top = ((cand_idx == rej_idx[..., None]) & valid).any(dim=-1)
    cand_idx = torch.cat([cand_idx, rej_idx[..., None]], dim=-1)
    cand_p = torch.cat([cand_p, torch.clamp(rej_p, min=rt)[..., None]],
                       dim=-1)                                    # (B, K, CC)
    # admitted rejection candidates inside the top-C also bypass the
    # relative threshold; the dedicated slot is used only when the top-C
    # holds no admitted copy (the top-C copy wins)
    is_rej = rej_ok[..., None] & (cand_idx == rej_idx[..., None])
    valid = torch.cat([valid | is_rej[..., :C],
                       (rej_ok & ~in_top)[..., None]], dim=-1)

    if bp.lm_predict:
        # the LM probability rates the hypothesis globally; decoder
        # scores still control beam entry (seq2seq.py:1488-1490)
        rate_p = torch.gather(step_out[5], 2, cand_idx)
    else:
        rate_p = cand_p
    cand_cost = -torch.log(torch.clamp(rate_p.to(F32), min=1e-30))
    c_cum = e_cum[..., None] + cand_cost
    c_nchars = (e_nchars + 1)[..., None].expand(B, K, CC)
    c_pro = c_cum + bp.cost0 * torch.abs(
        (c_nchars + 1).to(F32) - len0[:, None, None])
    ok = valid & exp_ok[..., None] & torch.isfinite(c_cum)
    c_pro = torch.where(ok, c_pro, inf)
    # newline candidates enter the reservoir like all others (flagged
    # final); they reach the bank only via a later top-K selection
    c_fin = (cand_idx == s.newline_idx) & ok
    # per-candidate alignment center (rejection -> one-hot marker)
    c_center = torch.where(
        is_rej, src_pos[..., None],
        torch.clamp(rounded, 0, T - 1)[..., None]).to(i32)

    # --- merge candidates into the reservoir --------------------------
    # every popped node leaves the queue: actives by expansion, finals
    # by banking
    res_pro = pro.scatter(1, exp_ix, torch.where(exp_ok, inf,
                                                 g1(pro, exp_ix)))
    res_pro = torch.where(fin_bank, inf, res_pro)
    neg2, sel = _top_k(
        -torch.cat([res_pro, c_pro.reshape(B, K * CC)], dim=1), R)
    new_pro = -neg2
    is_old = sel < R
    old_ix = torch.clamp(sel, max=R - 1)
    j = torch.clamp(sel - R, min=0)
    par_k = j // CC
    rank = j % CC

    def cand_of(x):                                       # (B,K,CC) -> (B,R)
        return g1(x.reshape(B, K * CC), j)

    def merge(old, new_k):
        """Post-merge slots of a per-node tensor: carried over from `old`
        (B, R, ...) or taken from the parent's step result `new_k` (B, K,
        ...), rounded to the carried dtype."""
        pick = is_old.reshape(is_old.shape + (1,) * (old.dim() - 2))
        return torch.where(pick, _take(old, old_ix),
                           _take(new_k, par_k).to(old.dtype))

    new_cum = torch.where(is_old, g1(cum, old_ix), cand_of(c_cum))
    new_cum = torch.where(torch.isfinite(new_pro), new_cum, inf)
    new_nchars = merge(nchars, e_nchars + 1)
    # attention state: ALWAYS the raw soft alignment rows, through
    # rejections too (the one-hot marker lives only in the node's
    # bookkeeping alignment, seq2seq.py:1510-1521)
    sel_isrej = cand_of(is_rej)
    sel_srcpos = cand_of(src_pos[..., None].expand(B, K, CC))
    new_aw = merge(aw, a_w)
    new_astart = merge(astart, a_start)
    # bookkeeping: rejection candidates record the one-hot position
    # (marker), normal candidates the step's soft expectation and
    # whether the soft row saturated to exactly 1.0
    step_max1 = a_w.amax(dim=-1) == 1.0                            # (B, K)
    new_bpos = torch.where(
        is_old, g1(book_pos, old_ix),
        torch.where(sel_isrej, sel_srcpos.to(F32), g1(new_exp, par_k)))
    new_bmax1 = torch.where(is_old, g1(book_max1, old_ix),
                            sel_isrej | g1(step_max1, par_k))
    new_h = [(merge(h[n][0], n_h[n][0]), merge(h[n][1], n_h[n][1]))
             for n in range(len(n_h))]
    # trie records for this iteration's post-merge slots: parent in
    # previous-iteration numbering; char/p/center only for new nodes
    put(st['rec_parent'], torch.where(is_old, old_ix, g1(exp_ix, par_k)))
    put(st['rec_char'], torch.where(is_old, -1, cand_of(cand_idx)))
    put(st['rec_p'], torch.where(is_old, 0.0, cand_of(cand_p)))
    put(st['rec_ap'], torch.where(is_old, 0, cand_of(c_center)))
    if s.return_alignments:
        # bookkeeping alignment row per new node: one-hot at src_pos for
        # rejection candidates (window start = src_pos, weight 1 at
        # offset 0), the step's raw soft windowed row otherwise
        onehot0 = (torch.arange(s.WIN, device=dev) == 0).to(dt)
        rows = torch.where(sel_isrej[..., None], onehot0,
                           _take(a_w, par_k).to(dt))
        put(st['rec_arow'], torch.where(is_old[..., None],
                                        torch.zeros_like(rows), rows))
        put(st['rec_astart'], torch.where(
            is_old, 0, torch.where(sel_isrej, sel_srcpos.to(i32),
                                   g1(a_start, par_k))))

    # feedback for new nodes: the parent's boosted probs with the
    # better-ranked *admitted* candidate maxima zeroed (the reference
    # zeroes the candidates it actually enqueued, seq2seq.py:1515-1520)
    zero_c = ((torch.arange(CC, device=dev) < rank[..., None])
              & _take(valid, par_k))                               # (B, R, CC)
    n_zero = torch.zeros((B, R, V), dtype=F32, device=dev).scatter_add_(
        2, _take(cand_idx, par_k), zero_c.to(F32))
    cand_feedback = _take(probs_adj_fb, par_k).masked_fill(n_zero > 0, 0.0)
    new_feedback = torch.where(is_old[..., None], _take(feedback, old_ix),
                               cand_feedback)
    # the finality flag travels with the merged nodes
    new_isfin = torch.where(is_old, g1(is_fin, old_ix), cand_of(c_fin))

    if trace is not None:
        put(trace['rec_exp'], torch.where(exp_ok, exp_ix, -1))
        put(trace['rec_cidx'], cand_idx)
        put(trace['rec_cp'], cand_p)
        put(trace['rec_cvalid'], valid)
        put(trace['rec_misal'], misal)
        put(trace['rec_srcpos'], src_pos)
        put(trace['rec_rejok'], rej_ok)
        put(trace['rec_rejp'], rej_p)

    # --- termination --------------------------------------------------
    no_live = ~torch.isfinite(new_pro).any(dim=1)
    over = (t + 1).to(F32) >= 2.0 * len0
    new = dict(st)
    for n, (hh, cc) in enumerate(new_h):
        new['h%d' % n], new['c%d' % n] = hh, cc
    new.update(aw=new_aw, astart=new_astart, feedback=new_feedback,
               book_pos=new_bpos, book_max1=new_bmax1, is_fin=new_isfin,
               cum=new_cum, pro=new_pro, nchars=new_nchars,
               bank_cost=nb_cost, bank_cum=nb_cum, bank_len=nb_len,
               bank_t=nb_t, bank_parent=nb_parent,
               done=done | stop | no_live | over, t=t + 1)
    return new


# eager runs of a captured iteration before its capture (lazy set-up of
# cuBLAS, K3's library and its shared-memory attributes)
_GRAPH_WARMUP = 2
# the share of a card's memory that the entries' static buffers may hold
# together; the least recently used go beyond it
_GRAPH_MEMORY_SHARE = 1 / 16
# one capture at a time: the entries of a stream share a memory pool
_CAPTURE_LOCK = threading.Lock()


def _static(tensors):
    """Buffers of the shapes and dtypes of `tensors` (a dict; None stays
    None), contiguous, outside any graph's pool."""
    return {k: None if v is None else torch.empty(v.shape, dtype=v.dtype,
                                                  device=v.device)
            for k, v in tensors.items()}


def _nbytes(*dicts):
    """The bytes of `_static` buffers of the tensors of `dicts`."""
    return sum(v.numel() * v.element_size() for d in dicts
               for v in d.values() if v is not None)


class _BeamGraph:
    """The graph route's unit: one iteration of the search for one key,
    over static inputs and state that each call loads, and, once
    captured, a CUDA graph that replays it (without one, each replay
    runs the iteration op by op on the same buffers: the tests'
    stand-in). `lock` is held by the call that uses it; `nbytes` is
    what its static buffers hold."""

    def __init__(self, s, inputs, state, pool):
        self.lock = threading.Lock()
        self.s = dataclasses.replace(
            s, step_weights=None if s.step_weights is None
            else _static(s.step_weights))
        self.inputs = _static(inputs)
        self.state = _static(state)
        self.nbytes = _nbytes(self.inputs, self.state,
                              self.s.step_weights or {})
        self.pool = pool
        self.graph = None

    def load(self, s, inputs, state):
        """Copy a call's inputs, initial state and packed weights in."""
        for src, dst in ((inputs, self.inputs), (state, self.state),
                         (s.step_weights or {}, self.s.step_weights or {})):
            for k, v in src.items():
                if v is not None:
                    dst[k].copy_(v)

    def _step(self):
        new = _iteration(self.s, self.inputs, self.state)
        for k, v in new.items():
            if v is not self.state[k]:
                self.state[k].copy_(v)

    def capture(self):
        """Warm the iteration up on a side stream, then capture it. The
        warm-up advances the state: load it again before a replay. The
        kernels' launch counters count the warm-up's and the capture's
        launches; a replay launches no wrapper."""
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(_GRAPH_WARMUP):
                    self._step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode='thread_local'):
                self._step()
        self.graph = graph
        profiling.count('decoders.beam_graph_captures')

    def replay(self):
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()


class _GraphCache:
    """The captured iterations by what they bake in. Their static
    buffers hold at most `max_bytes` together (None: `_GRAPH_MEMORY_SHARE`
    of the card's memory, no bound on the CPU), the least recently used
    evicted beyond it (its buffers and graph go with the last reference);
    a key whose buffers alone pass it runs op by op. An entry holds its
    model, so that the identity of `params` in its key stays its own. The
    entries of one device and stream share a graph memory pool: the
    stream orders their replays."""

    def __init__(self, max_bytes=None):
        self.max_bytes = max_bytes
        self.nbytes = 0
        self._entries = collections.OrderedDict()
        self._pools = {}
        self._lock = threading.Lock()

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._pools.clear()
            self.nbytes = 0

    def _budget(self, dev):
        if self.max_bytes is not None:
            return self.max_bytes
        if dev.type != 'cuda':
            return INF
        return (torch.cuda.get_device_properties(dev).total_memory
                * _GRAPH_MEMORY_SHARE)

    def _drop(self, key):
        self.nbytes -= self._entries.pop(key).nbytes

    def acquire(self, s, inputs, state, capture):
        """The entry of this call's key with its lock held, loaded with
        `inputs`, `state` and `s`'s packed weights and, with `capture`,
        its iteration captured; None where the call runs eager: another
        call holds the entry, its buffers alone pass the budget, or a
        capture is due while a profiler runs (a capture must not run
        under the profiler)."""
        dev = inputs['attended'].device
        stream = (torch.cuda.current_stream(dev).cuda_stream
                  if dev.type == 'cuda' else None)
        key = (dev, stream, capture, s.dtype, s.B, s.T, s.V, s.R, s.K,
               s.C, s.F, s.S, s.WIN, s.return_alignments, s.bp,
               s.newline_idx, s.config, id(s.params),
               s.step_weights is not None)
        with self._lock:
            entry = self._entries.get(key)
            fresh = entry is None
            if fresh:
                if capture and profiling.profiler_running():
                    return None
                budget = self._budget(dev)
                if _nbytes(inputs, state, s.step_weights or {}) > budget:
                    return None
                pool = None
                if capture:
                    pool = self._pools.get(key[:2])
                    if pool is None:
                        pool = self._pools[key[:2]] = \
                            torch.cuda.graph_pool_handle()
                entry = _BeamGraph(s, inputs, state, pool)
                entry.lock.acquire()
                while self._entries and self.nbytes + entry.nbytes > budget:
                    self._drop(next(iter(self._entries)))
                self._entries[key] = entry
                self.nbytes += entry.nbytes
            else:
                self._entries.move_to_end(key)
                if not entry.lock.acquire(blocking=False):
                    return None
        try:
            entry.load(s, inputs, state)
            if fresh and capture:
                with _CAPTURE_LOCK:
                    entry.capture()
                entry.load(s, inputs, state)
        except BaseException:
            with self._lock:
                if self._entries.get(key) is entry:
                    self._drop(key)
            entry.lock.release()
            raise
        return entry


_GRAPHS = _GraphCache()


def decode_beam(params, config: Seq2SeqConfig, bp: BeamParams, enc_input,
                newline_idx, src_len, max_steps=None,
                return_alignments=False, return_trace=False):
    """Beam-decode a batch of lines on the device of `params`.

    enc_input: (B, T, V) source vectors or a compact (B, T) index batch;
    src_len: (B,) per-line source lengths used for the length prior
    (len0). Returns a dict with the finished bank, best-first: 'idx'
    (B,F,S) int32, 'prob' (B,F,S), 'length' (B,F), 'cost' (B,F)
    prospective cost, 'cum' (B,F) cumulative -log p, 'count' (B,), and
    per-step alignment centers 'align_pos' (B,F,S).

    With `return_alignments`, also 'align_row' (B,F,S,WIN) windowed soft
    alignment rows and 'align_start' (B,F,S) their window offsets: the
    per-step bookkeeping alignments (one-hot for rejection steps, the
    raw soft attention row otherwise, reference seq2seq.py:1495/1510).
    With `return_trace`, 'trace' holds the raw per-iteration records and
    the final reservoir, for debugging tools.

    The search runs as a host loop of `_iteration`s that reads, once an
    iteration, the number of lines not done. On CUDA tensors (without
    `return_trace`) each iteration is the replay of a CUDA graph of
    `_iteration`, captured once per shape, bounds and model (see
    `_BEAM_GRAPH`); otherwise the iteration runs op by op. The returned
    tensors are the call's own either way.
    """
    dev = params['char_embedding']['kernel'].device
    enc_input = ensure_onehot(torch.as_tensor(enc_input).to(dev), config,
                              params)
    B, T, V = enc_input.shape
    R = bp.reservoir
    S = max_steps or 2 * T
    attended, states, u = encode(params, config, enc_input)
    emb_dt = params['char_embedding']['kernel'].dtype
    s = _Search(params, config, bp, newline_idx, B, T, V, R,
                # expand cannot exceed the reservoir (top-K is taken over
                # R slots)
                K=min(bp.expand, R),
                # the bank holds one slot more than beam_width_out: the
                # reference's early stop requires *more than*
                # beam_width_out finished solutions
                F=bp.beam_width_out + 1,
                # cannot admit more than the vocab
                C=min(bp.beam_width_in, V), S=S,
                WIN=min(2 * config.window_width + 2, T),
                dtype=attended.dtype, return_alignments=return_alignments,
                step_weights=(pack_weights(params, emb_dt)
                              if _step_kernel_route(params, config,
                                                    bp.lm_predict)
                              else None))
    src_any = enc_input.ne(0).any(dim=2)                          # (B, T)
    # costs and the length prior accumulate in float32 even in bfloat16
    # compute: 8 bits of mantissa are too coarse to order summed -log p
    len0 = torch.as_tensor(src_len).to(dev).to(F32)                # (B,)
    inputs = dict(attended=attended, u=u, src_any=src_any,
                  src_top=torch.argmax(enc_input, dim=2),         # (B, T)
                  lengths=(src_any.sum(dim=1) if config.mask_padding
                           else None),
                  len0=len0,
                  slots=torch.arange(R, device=dev)[None].expand(B, R),
                  inf=torch.full((), INF, dtype=F32, device=dev))
    state = _initial_state(s, enc_input, states, len0)
    trace = None
    if return_trace:
        i32, K, CC = torch.int32, s.K, s.C + 1
        trace = dict(
            rec_exp=torch.full((B, S, K), -1, dtype=i32, device=dev),
            rec_cidx=torch.full((B, S, K, CC), -1, dtype=i32, device=dev),
            rec_cp=torch.zeros((B, S, K, CC), dtype=F32, device=dev),
            rec_cvalid=torch.zeros((B, S, K, CC), dtype=torch.bool,
                                   device=dev),
            rec_misal=torch.zeros((B, S, K), dtype=F32, device=dev),
            rec_srcpos=torch.full((B, S, K), -1, dtype=i32, device=dev),
            rec_rejok=torch.zeros((B, S, K), dtype=torch.bool, device=dev),
            rec_rejp=torch.zeros((B, S, K), dtype=F32, device=dev))
    entry = None
    if not return_trace and (_BEAM_GRAPH == 'buffers' or (
            _BEAM_GRAPH == 'auto' and dev.type == 'cuda')):
        entry = _GRAPHS.acquire(s, inputs, state,
                                capture=_BEAM_GRAPH == 'auto')
    try:
        if entry is not None:
            state = entry.state
        t = 0
        # one host read an iteration: the number of lines not yet done,
        # which ends the loop and feeds the beam_live_rows counter
        tracing = profiling.tracer.active()
        live = B - int(state['done'].sum())
        while live and t < S:
            with profiling.span('decoders.beam_iteration'):
                if tracing:
                    profiling.count('decoders.beam_iterations')
                    profiling.count('decoders.beam_rows', B)
                    profiling.count('decoders.beam_live_rows', live)
                if entry is None:
                    state = _iteration(s, inputs, state, trace)
                else:
                    entry.replay()
                    if tracing:
                        profiling.count('decoders.beam_graph_iterations')
                t += 1
                live = t < S and B - int(state['done'].sum())
        out = _backtrace(s, state, t)
    finally:
        if entry is not None:
            entry.lock.release()
    if return_trace:
        out['trace'] = dict(rec_parent=state['rec_parent'],
                            rec_char=state['rec_char'], rec_p=state['rec_p'],
                            pro=state['pro'], cum=state['cum'],
                            nchars=state['nchars'], is_fin=state['is_fin'],
                            t=t, **trace)
    return out


def _backtrace(s, st, t):
    """`decode_beam`'s results from the state after `t` iterations: the
    banked texts rebuilt from the trie, in new tensors (none is a view
    of `st`'s)."""
    B, F, S, WIN, dt = s.B, s.F, s.S, s.WIN, s.dtype
    dev = st['done'].device
    i32 = torch.int32

    def g1(x, ix):
        return torch.gather(x, 1, ix)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    bank_cost, bank_len = st['bank_cost'], st['bank_len']
    count = torch.isfinite(bank_cost).sum(dim=1)

    # --- backtrace: rebuild the banked texts from the trie -------------
    # each bank entry holds (t, parent slot); walk the per-iteration
    # (parent, char) records backwards, emitting chars right-to-left.
    # The banked node's own newline record is part of its chain, so the
    # walk emits the complete text. Position S of the output buffers
    # takes the writes of entries that emit nothing at an iteration.
    with profiling.span('decoders.backtrace'):
        valid_f = torch.isfinite(bank_cost)
        idx = zeros((B, F, S + 1), i32)
        prob = zeros((B, F, S + 1), dt)
        ap = zeros((B, F, S + 1), i32)
        if s.return_alignments:
            arow = zeros((B, F, S + 1, WIN), dt)
            ast = zeros((B, F, S + 1), i32)
        pos = st['bank_parent']
        outpos = bank_len.long() - 1
        for tt in range(t - 1, -1, -1):
            rc = g1(st['rec_char'][:, tt], pos)                    # (B, F)
            active = valid_f & (tt < st['bank_t'])
            emit = active & (rc >= 0) & (outpos >= 0)
            wpos = torch.where(emit, outpos, S)[..., None]
            idx.scatter_(2, wpos, rc[..., None])
            prob.scatter_(2, wpos, g1(st['rec_p'][:, tt], pos)[..., None])
            ap.scatter_(2, wpos, g1(st['rec_ap'][:, tt], pos)[..., None])
            if s.return_alignments:
                arow.scatter_(2, wpos[..., None].expand(B, F, 1, WIN),
                              _take(st['rec_arow'][:, tt], pos)[:, :, None])
                ast.scatter_(2, wpos,
                             g1(st['rec_astart'][:, tt], pos)[..., None])
            outpos = outpos - emit.long()
            pos = torch.where(active, g1(st['rec_parent'][:, tt], pos), pos)
    # expose only beam_width_out solutions (the extra internal slot
    # exists for the reference's early-stop rule)
    Fo = s.bp.beam_width_out
    out = dict(idx=idx[:, :Fo, :S], prob=prob[:, :Fo, :S],
               length=bank_len[:, :Fo].clone(),
               cost=bank_cost[:, :Fo].clone(),
               cum=st['bank_cum'][:, :Fo].clone(),
               count=torch.clamp(count, max=Fo), align_pos=ap[:, :Fo, :S])
    if s.return_alignments:
        out['align_row'] = arow[:, :Fo, :S]
        out['align_start'] = ast[:, :Fo, :S]
    return out
