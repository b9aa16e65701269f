"""Arithmetic on parameter trees (nested dicts of tensors) for federated
aggregation (port of ``fedml_tpu/core/tree.py``'s ``tree_weighted_mean``
and ``tree_select``)."""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of dicts with one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_weighted_mean(stacked, weights):
    """Weighted mean over the leading (client) dim of a stacked tree:
    weights ``[C]`` normalised (sum clamped at 1e-12), each leaf summed in
    f32 and cast back to its dtype."""
    w = weights.float()
    w = w / torch.clamp(w.sum(), min=1e-12)
    return tree_map(
        lambda p: torch.einsum("c,c...->...", w, p.float()).to(p.dtype),
        stacked)


def tree_select(pred, on_true, on_false):
    """Leafwise ``torch.where`` on a scalar predicate (gates optimizer
    updates on padded, empty batches so padding never perturbs state)."""
    return tree_map(lambda t, f: torch.where(pred, t, f), on_true, on_false)
