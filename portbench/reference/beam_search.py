"""The reference's beam search with rejection.

The search that the reference's ``decode_sequence_beam``
(lib/seq2seq.py:1356-1544) defines, run on the plain model
(``reference/model.py``) for a batch of lines at once, with its queue
bounded per line: a best-first search over hypotheses (nodes) that
expands the `expand` best queued nodes of each line an iteration and
keeps the `reservoir` best of what is queued. It gives, for each line,
the prospective cost of the best solution it finds, which the served
line's cost is held against.

- A node's prospective cost is its cumulative ``-log p`` plus
  ``cost0 * |n + 1 - len0|`` for its n characters and the line's source
  length len0 (Node.pro_cost, seq2seq.py:1588-1595).
- An expanded node's candidates follow the rules of
  ``reference/beam_path.py``: the `beam_width_in` most probable
  characters cut at `beam_threshold_in` times the best (index 0 never),
  and the rejection candidate at its source position, boosted to
  `rejection_threshold` and admitted besides; a child's decoder input is
  the parent's boosted probabilities with the better-ranked admitted
  candidates set to 0.
- A candidate that closes the line (the newline) is a solution. It
  stays queued until it ranks better than the last node an iteration
  expands (or fewer nodes are queued than it expands); it then leaves
  the queue for the solutions.
- A line ends once more than `beam_width_out` solutions are found and
  the best of them beats the best node expanded that iteration
  (seq2seq.py:1417-1419), once nothing is queued, or after 2 * len0
  iterations.

Ties are broken by order (the lowest queue slot or candidate rank
first), all in float32 on the device it is given.
"""

import torch

from . import model

INF = float('inf')


def _first(x, k):
    """The k smallest values along dim 1 and their indices, the lowest
    index first among equal values."""
    values, idx = torch.sort(x, dim=1, stable=True)
    return values[:, :k], idx[:, :k]


def _rows(x, ix):
    """x[b, ix[b, k]] for x (B, n, ...) and ix (B, k)."""
    tail = x.shape[2:]
    return torch.gather(x, 1, ix.reshape(ix.shape + (1,) * len(tail))
                        .expand(ix.shape + tail))


def search(p, x, src_len, t_clamp, sp, window, newline):
    """Search a batch of lines.

    p: flat parameters; x (B, T, V) the lines' input vectors (zero past
    each line); src_len (B,) positions of each line (len0); t_clamp (B,)
    the padded length the program ran each line at; sp: dict of
    rejection_threshold, beam_width_in, beam_threshold_in, reservoir,
    expand, beam_width_out, cost0; newline: the newline's index.

    Returns (cost (B,): the prospective cost of each line's best
    solution, inf where none was found; paths (B, S) long: its
    characters, -1 past its end).
    """
    B, T, V = x.shape
    dev = x.device
    R, K = int(sp['reservoir']), min(int(sp['expand']), int(sp['reservoir']))
    F = int(sp['beam_width_out']) + 1
    C = min(int(sp['beam_width_in']), V)
    CC = C + 1
    rt = float(sp['rejection_threshold'])
    thr = float(sp['beam_threshold_in'])
    cost0 = float(sp['cost0'])
    len0 = src_len.float()
    S = 2 * int(t_clamp.max()) + 1
    pos = torch.arange(T, device=dev)
    mask = pos[None, :] < src_len[:, None]
    attended, states, u = model.encode(p, x, mask)
    src_top = torch.argmax(x, dim=2)
    src_any = x.ne(0).any(dim=2)
    line = torch.arange(B, device=dev)

    # the queue: slot 0 holds the root, the others nothing (cost inf)
    root = torch.arange(R, device=dev) == 0
    pro = torch.where(root[None], cost0 * torch.abs(1.0 - len0)[:, None],
                      torch.full((B, R), INF, device=dev))
    cum = torch.where(root[None], 0.0, INF).expand(B, R).clone()
    nchars = torch.zeros((B, R), dtype=torch.long, device=dev)
    final = torch.zeros((B, R), dtype=torch.bool, device=dev)
    st = [tuple(s[:, None].expand(B, R, s.shape[1]).clone() for s in hc)
          for hc in states]
    prev_a = x.new_zeros((B, R, T))
    feedback = x.new_zeros((B, R, V))
    book_pos = x.new_zeros((B, R))
    book_max1 = torch.zeros((B, R), dtype=torch.bool, device=dev)
    path = torch.full((B, R, S), -1, dtype=torch.long, device=dev)
    # the solutions found, best first
    sol_cost = torch.full((B, F), INF, device=dev)
    sol_path = torch.full((B, F, S), -1, dtype=torch.long, device=dev)
    done = ~src_any.any(dim=1)
    it = 0
    while it < S and not bool(done.all()):
        # the K best queued nodes that are not solutions
        exp_pro, ex = _first(torch.where(final, INF, pro), K)
        exp_ok = torch.isfinite(exp_pro) & ~done[:, None]
        # solutions that rank better than the K-th expanded node leave
        # the queue
        kth = torch.where(torch.isfinite(exp_pro).all(dim=1),
                          exp_pro[:, -1], INF)
        leave = final & torch.isfinite(pro) & (pro < kth[:, None]) \
            & ~done[:, None]
        both = torch.cat([sol_cost, torch.where(leave, pro, INF)], dim=1)
        sol_cost, pick = _first(both, F)
        sol_path = _rows(torch.cat([sol_path, path], dim=1), pick)
        stop = torch.isfinite(sol_cost[:, -1]) & (
            sol_cost[:, 0] < torch.where(exp_ok[:, 0], exp_pro[:, 0], INF))

        # one decoder step of the expanded nodes (B * K rows)
        n = B * K
        of = line[:, None].expand(B, K).reshape(n)
        probs, new_st, a = model.decoder_step(
            p, _rows(feedback, ex).reshape(n, V),
            [tuple(_rows(s, ex).reshape(n, -1) for s in hc) for hc in st],
            _rows(prev_a, ex).reshape(n, T), attended[of], u[of], mask[of],
            window)
        probs, a = probs.reshape(B, K, V), a.reshape(B, K, T)
        exp_pos = a @ pos.float()
        e_n = torch.gather(nchars, 1, ex)
        e_bpos = torch.gather(book_pos, 1, ex)
        e_max1 = torch.gather(book_max1, 1, ex)
        first = e_n == 0
        misal = torch.where(first, 0.0, torch.abs(exp_pos - e_bpos - 1.0))
        src_pos = torch.where(e_max1, e_bpos.long() + 1,
                              torch.round(exp_pos).long())
        src_pos = torch.where(first, 0, src_pos).clamp(min=0)
        src_pos = torch.minimum(src_pos, t_clamp[:, None] - 1)
        in_x = src_pos < T
        at = src_pos.clamp(max=T - 1)
        rej_idx = torch.where(in_x, torch.gather(src_top, 1, at), 0)
        rej_ok = (rt > 0) & ((misal < 0.1) | e_max1 | first) & in_x \
            & torch.gather(src_any, 1, at) & (rej_idx != 0)
        rej_p = torch.gather(probs, 2, rej_idx[..., None])[..., 0]
        boost = (rej_ok & (rej_p < rt))[..., None] & (
            torch.arange(V, device=dev) == rej_idx[..., None])
        adj = probs.masked_fill(boost, rt)
        cand_p, cand = torch.sort(adj, dim=2, descending=True, stable=True)
        cand_p, cand = cand_p[..., :C], cand[..., :C]
        valid = (cand_p >= cand_p[..., :1] * thr) & (cand != 0)
        in_top = ((cand == rej_idx[..., None]) & valid).any(dim=2)
        cand = torch.cat([cand, rej_idx[..., None]], dim=2)
        cand_p = torch.cat([cand_p, rej_p.clamp(min=rt)[..., None]], dim=2)
        is_rej = rej_ok[..., None] & (cand == rej_idx[..., None])
        valid = torch.cat([valid | is_rej[..., :C],
                           (rej_ok & ~in_top)[..., None]], dim=2)
        c_cum = torch.gather(cum, 1, ex)[..., None] \
            - torch.log(cand_p.clamp(min=1e-30))
        c_n = (e_n + 1)[..., None].expand(B, K, CC)
        ok = valid & exp_ok[..., None] & torch.isfinite(c_cum)
        c_pro = torch.where(ok, c_cum + cost0 * torch.abs(
            (c_n + 1).float() - len0[:, None, None]), INF)

        # the queue keeps its R best: what was queued and not taken out,
        # then the children
        kept = pro.scatter(1, ex, torch.where(
            exp_ok, INF, torch.gather(pro, 1, ex)))
        kept = torch.where(leave, INF, kept)
        pro, sel = _first(torch.cat([kept, c_pro.reshape(B, K * CC)],
                                    dim=1), R)
        old = sel < R
        oi = sel.clamp(max=R - 1)
        j = (sel - R).clamp(min=0)
        par, rank = j // CC, j % CC

        def child(x_k):          # (B, K, CC) -> (B, R)
            return torch.gather(x_k.reshape(B, K * CC), 1, j)

        def node(x_r, x_k):      # per-node (B, R, ...) from parent (B, K, ...)
            pick = old.reshape(old.shape + (1,) * (x_r.dim() - 2))
            return torch.where(pick, _rows(x_r, oi), _rows(x_k, par))

        cum = torch.where(torch.isfinite(pro),
                          torch.where(old, torch.gather(cum, 1, oi),
                                      child(c_cum)), INF)
        char = child(cand)
        nchars = node(nchars, e_n + 1)
        final = torch.where(old, torch.gather(final, 1, oi),
                            child(cand == newline) & torch.isfinite(pro))
        st = [tuple(node(s, ns.reshape(B, K, -1)) for s, ns in zip(hc, nhc))
              for hc, nhc in zip(st, new_st)]
        prev_a = node(prev_a, a)
        c_rej = child(is_rej)
        book_pos = torch.where(old, torch.gather(book_pos, 1, oi),
                               torch.where(c_rej, child(src_pos[..., None]
                                                        .expand(B, K, CC))
                                           .float(),
                                           torch.gather(exp_pos, 1, par)))
        book_max1 = torch.where(old, torch.gather(book_max1, 1, oi),
                                c_rej | torch.gather(a.amax(dim=2) == 1.0,
                                                     1, par))
        # a child's input: the parent's boosted probabilities with the
        # admitted candidates ranked above it set to 0
        above = (torch.arange(CC, device=dev) < rank[..., None]) \
            & _rows(valid, par)
        zero = torch.zeros((B, R, V), device=dev).scatter_add_(
            2, _rows(cand, par), above.float()) > 0
        feedback = torch.where(old[..., None], _rows(feedback, oi),
                               _rows(adj, par).masked_fill(zero, 0.0))
        path = node(path, _rows(path, ex))
        new = ~old & torch.isfinite(pro)
        at_n = (nchars - 1).clamp(0, S - 1)[..., None]
        path.scatter_(2, at_n, torch.where(
            new, char, torch.gather(path, 2, at_n)[..., 0])[..., None])
        done = done | stop | ~torch.isfinite(pro).any(dim=1) \
            | (float(it + 1) >= 2.0 * len0)
        it += 1
    return sol_cost[:, 0], sol_path[:, 0]
