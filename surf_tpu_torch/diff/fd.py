"""Finite-difference gradients (port of ``surf_tpu.diff.fd``).

Central differences of the same fixed-seed estimator that autograd
differentiates: every random decision is a function of the uint32 seed
lattice, so f(θ+h) and f(θ-h) share their sample paths and the quotient
converges to the derivative of the estimator, except where a discrete
decision flips inside [θ-h, θ+h].
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_flatten(tree):
    """(leaves, unflatten) of a tree of NamedTuples, in JAX's order (fields
    in order, depth first); whatever is not a NamedTuple is a leaf.
    ``unflatten(new_leaves)`` rebuilds the tree around new leaves."""
    if not hasattr(tree, "_fields"):
        return [tree], lambda leaves: leaves[0]
    parts = [tree_flatten(x) for x in tree]

    def unflatten(leaves):
        leaves, out = list(leaves), []
        for sub, unf in parts:
            out.append(unf(leaves[:len(sub)]))
            leaves = leaves[len(sub):]
        return type(tree)(*out)

    return [leaf for sub, _ in parts for leaf in sub], unflatten


def finite_difference(f: Callable, theta, h: float = 1e-3,
                      indices: list[tuple] | None = None):
    """Central-difference gradient of the scalar ``f`` with respect to the
    tree ``theta`` (a NamedTuple of tensors, nested ones included).

    ``indices``: an optional list of (leaf index, element index) pairs,
    leaves numbered in JAX's flattening order and elements as tuples
    (``()`` for a scalar leaf), to probe a subset; by default every
    element is probed.  Each probe evaluates ``f`` on the tree with that
    one element moved by ±h (the leaf rounded to float32, on its device).
    Returns the float64 gradients as NumPy arrays in theta's structure."""
    leaves, unflatten = tree_flatten(theta)
    grads = []
    for li, leaf in enumerate(leaves):
        base = leaf.detach().cpu().numpy().astype(np.float64)
        g = np.zeros_like(base)
        for idx in np.ndindex(base.shape):
            if indices is not None and (li, idx) not in indices:
                continue
            fs = []
            for step in (h, -h):
                moved = base.copy()
                moved[idx] += step
                new = list(leaves)
                new[li] = torch.as_tensor(moved.astype(np.float32), device=leaf.device)
                fs.append(float(f(unflatten(new))))
            g[idx] = (fs[0] - fs[1]) / (2 * h)
        grads.append(g)
    return unflatten(grads)
