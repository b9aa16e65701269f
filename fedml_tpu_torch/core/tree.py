"""Arithmetic on parameter trees (nested dicts of tensors) for federated
aggregation, and the client-stacked state of the "custom" carry protocol
(port of ``fedml_tpu/core/tree.py``'s ``tree_weighted_mean``,
``tree_select``, ``gather_stacked`` and ``scatter_stacked``).

A client stack (:func:`client_stack`) holds one row per client plus a
last DUSTBIN row: :func:`scatter_stacked` routes the slots it must drop
there, the port's form of JAX's out-of-bounds ``mode="drop"`` scatter.
The write stays in place, deterministic and free of host syncs, so it can
be captured in a CUDA graph; :func:`client_rows` is the ``[N, ...]``
view of the clients."""

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


def client_stack(tree, n: int):
    """``n`` client copies of every leaf of ``tree`` plus the dustbin row:
    ``[n + 1, ...]`` leaves (see the module docstring)."""
    return tree_map(lambda t: t.unsqueeze(0).expand(n + 1, *t.shape).clone(),
                    tree)


def client_rows(stack):
    """The clients' ``[N, ...]`` rows of a :func:`client_stack` (views)."""
    return tree_map(lambda t: t[:-1], stack)


def gather_stacked(stacked, idx):
    """The slots ``idx [k]`` (int64, on the stack's device) of a
    client-stacked tree: ``[k, ...]`` leaves, copies."""
    return tree_map(lambda p: p.index_select(0, idx), stacked)


def scatter_stacked(stacked, idx, values, umask):
    """Writes ``values`` (``[k, ...]`` leaves) into the rows ``idx [k]`` of
    a :func:`client_stack`, IN PLACE, and returns it; a slot whose
    ``umask`` is 0 is dropped. Padding may repeat ``idx[0]`` with mask 0:
    a gated write would then put two writes on one row, in an order CUDA
    leaves undefined, so a masked slot goes to the dustbin row instead,
    and the rows of real clients each take at most one write."""
    leaves = tree_leaves(stacked)
    if not leaves:  # an empty tree (a model without trained state)
        return stacked
    dustbin = leaves[0].shape[0] - 1
    target = torch.where(umask > 0, idx, torch.full_like(idx, dustbin))
    return tree_map(lambda old, new: old.index_copy_(0, target,
                                                     new.to(old.dtype)),
                    stacked, values)
