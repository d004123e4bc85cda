"""Parameter trees as tensors.

The port keeps the JAX package's parameter layout (models/config.py):
nested dicts and lists whose leaves are arrays. ``params_from_numpy``
turns such a tree of numpy arrays into the same tree of tensors on one
device, so both packages can be fed the same numbers in the tests;
``params_to_numpy`` is the way back, for saving a model or a training
state and for comparing with the JAX package leaf by leaf.
"""

import numpy as np
import torch


def params_from_numpy(tree, device, dtype=None):
    """Copy a numpy parameter tree to tensors on `device` (the tensors
    never share memory with the arrays).

    With `dtype` (e.g. ``torch.bfloat16``) every float32 leaf is cast to
    it and other leaves keep their type — the bf16 serving copy of the
    JAX package's ``Sequence2Sequence._infer_params``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    # a copy even on the CPU: training updates the tensors in place, and
    # ``torch.from_numpy`` alone would write through to the caller's arrays
    t = torch.from_numpy(np.array(tree, order='C')).to(device)
    if dtype is not None and t.dtype == torch.float32:
        t = t.to(dtype)
    return t


def params_to_numpy(tree):
    """Copy a tree of tensors (or arrays) to float32 numpy arrays in the
    same layout; leaves that are not floating point keep their type."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.is_floating_point():
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(tree)


def tree_leaves(tree):
    """The leaves of a parameter tree in a fixed order: dict keys sorted,
    lists in sequence (the order of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """The layout of `tree` with `leaves` (in `tree_leaves` order) in
    place of its own."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            # keys in sorted order, as `tree_leaves` visits them
            done = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [rebuild(v) for v in t]
        return next(it)

    return rebuild(tree)


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf by leaf over trees of one layout; dicts and lists
    are rebuilt, tuples come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
