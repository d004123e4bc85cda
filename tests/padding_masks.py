"""The padding masks the masked LSTM scan and teacher layer tests share
(plain, emulated and on the card), so that every suite runs the same
mask cases."""

import numpy as np
import torch


def padding_mask(B, T, seed):
    """(B, T) bool, true at valid steps: right padding at random lengths,
    row 0 whole, row 1 all padding, row 2 with gaps inside (every third
    step from the second). B is at least 3."""
    rng = np.random.default_rng(seed)
    m = np.arange(T)[None] < rng.integers(1, T + 1, B)[:, None]
    m[0] = True
    m[1] = False
    m[2] = np.arange(T) % 3 != 1
    return m


def kernel_mask(T, B, seed):
    """`padding_mask` as K4/K5 take it: (T, B) uint8, contiguous."""
    return torch.from_numpy(
        np.ascontiguousarray(padding_mask(B, T, seed).T).astype(np.uint8))


def teacher_mask(B, T, seed, ww):
    """`padding_mask` as K6/K7 take it, (B, T) uint8, contiguous, and
    with B > 3 row 3 valid only from position ww + 2 on. The attention
    window of a row's first step covers positions 0 to ww + 1, and a
    window that held a valid position always leads to one that holds
    another (the next centre lies within ww of the alignment's valid
    positions), so rows 1 and 3 are the rows whose every window is
    empty: their alignment stays zero and their window centre 1."""
    m = padding_mask(B, T, seed)
    if B > 3:
        m[3] = np.arange(T) >= ww + 2
    return torch.from_numpy(np.ascontiguousarray(m).astype(np.uint8))
