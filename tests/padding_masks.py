"""The padding masks the masked LSTM scan tests share (plain, emulated
and on the card), so that every suite runs the same mask cases."""

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
