"""The reference's reading of served beam paths.

A beam search with rejection returns, for each line, one path of
characters and the probability it gave each character. This module
follows such a path through the plain model (``reference/model.py``)
step by step, as the search's rules define the step (the reference's
``decode_sequence_beam``, lib/seq2seq.py:1356-1544), and says at every
position whether the search may admit that character there and with
which probability:

- the decoder's input is the previous step's probability vector (after
  the rejection boost) with the better-ranked admitted candidates of the
  previous choice set to 0 (seq2seq.py:1515-1520); the first input is 0;
- the **rejection** candidate is the OCR's best character at the source
  position the hypothesis is aligned to: the first position at the first
  step, one past the last rejection's position after a rejection (or
  after an alignment saturated to one position), else the rounded
  expected position; it is allowed while the expected position moved by
  one within 0.1 (or after a rejection, or at the first step), boosted
  to `rejection_threshold` and admitted besides the others
  (seq2seq.py:1441-1501); where a served character could be either
  copy, the better-ranked one is read;
- the other candidates are the `beam_width_in` most probable characters
  (the lowest index first among equal probabilities), cut at
  `beam_threshold_in` times the best; index 0 never counts.

`read_paths` does this for a batch of lines at once, all in float32 on
the device it is given (TF32 as the caller sets it).
"""

import torch

from . import model


def read_paths(p, x, src_len, t_clamp, paths, bp, window):
    """Follow served paths.

    p: flat parameters; x (B, T, V) the lines' input vectors (zero past
    each line); src_len (B,) positions of each line; t_clamp (B,) the
    padded length the program ran each line at (a source position is
    clamped below it); paths (B, L) long, the served characters, -1
    past each path's end; bp: dict of rejection_threshold,
    beam_width_in, beam_threshold_in.

    Returns (probs (B, L) float32: the probability the search gives each
    served character, nan past the end; admitted (B, L) bool; rows
    (B, L, T): the alignment the search records for each served
    character, one-hot at the source position for a rejection, else the
    attention row).
    """
    B, T, V = x.shape
    dev = x.device
    L = paths.shape[1]
    rt = float(bp['rejection_threshold'])
    C = min(int(bp['beam_width_in']), V)
    thr = float(bp['beam_threshold_in'])
    pos = torch.arange(T, device=dev)
    mask = pos[None, :] < src_len[:, None]
    attended, states, u = model.encode(p, x, mask)
    src_top = torch.argmax(x, dim=2)
    src_any = x.ne(0).any(dim=2)
    rows = torch.arange(B, device=dev)
    feedback = x.new_zeros((B, V))
    prev_a = x.new_zeros((B, T))
    book_pos = x.new_zeros(B)
    book_max1 = torch.zeros(B, dtype=torch.bool, device=dev)
    probs_out = torch.full((B, L), float('nan'), device=dev)
    admitted = torch.zeros((B, L), dtype=torch.bool, device=dev)
    rows_out = x.new_zeros((B, L, T))
    for t in range(L):
        y = paths[:, t]
        live = y >= 0
        if not bool(live.any()):
            break
        y = y.clamp(min=0)
        probs, states, a = model.decoder_step(p, feedback, states, prev_a,
                                              attended, u, mask, window)
        prev_a = a
        exp_pos = a @ pos.float()
        first = t == 0
        misal = (torch.zeros_like(exp_pos) if first
                 else torch.abs(exp_pos - book_pos - 1.0))
        src_pos = torch.where(book_max1, book_pos.long() + 1,
                              torch.round(exp_pos).long())
        if first:
            src_pos = torch.zeros_like(src_pos)
        src_pos = torch.minimum(src_pos.clamp(min=0), t_clamp - 1)
        in_x = src_pos < T
        at = src_pos.clamp(max=T - 1)
        rej_idx = torch.where(in_x, src_top[rows, at], 0)
        rej_ok = (rt > 0) & ((misal < 0.1) | book_max1 | first) \
            & in_x & src_any[rows, at] & (rej_idx != 0)
        rej_p = probs[rows, rej_idx]
        boost = rej_ok & (rej_p < rt)
        adj = probs.clone()
        adj[rows[boost], rej_idx[boost]] = rt
        cand_p, cand_idx = torch.sort(adj, dim=1, descending=True,
                                      stable=True)
        cand_p, cand_idx = cand_p[:, :C], cand_idx[:, :C]
        is_rej = rej_ok[:, None] & (cand_idx == rej_idx[:, None])
        valid = (cand_p >= cand_p[:, :1] * thr) & (cand_idx != 0)
        # a rejection candidate among the admitted top ones takes no
        # second slot; one below the cut is admitted in both
        in_top = ((cand_idx == rej_idx[:, None]) & valid).any(dim=1)
        valid = valid | is_rej
        hit = cand_idx == y[:, None]
        y_in_top = hit.any(dim=1)
        rank = torch.where(y_in_top, hit.float().argmax(dim=1),
                           torch.full_like(y, C))
        y_rej = rej_ok & (y == rej_idx)
        ok = torch.where(y_in_top, (valid & hit).any(dim=1),
                         y_rej & ~in_top)
        probs_out[:, t] = torch.where(live, adj[rows, y], probs_out[:, t])
        admitted[:, t] = live & ok
        onehot = torch.nn.functional.one_hot(at, T).to(a.dtype)
        rows_out[:, t] = torch.where(y_rej[:, None], onehot, a)
        # the next input: zero the admitted candidates ranked above y
        above = (torch.arange(C, device=dev)[None, :] < rank[:, None]) \
            & valid
        feedback = adj.clone()
        feedback[rows[:, None].expand(B, C)[above], cand_idx[above]] = 0.0
        book_pos = torch.where(y_rej, src_pos.float(), exp_pos)
        book_max1 = y_rej | (a.amax(dim=1) == 1.0)
    return probs_out, admitted, rows_out
