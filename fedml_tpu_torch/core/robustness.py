"""Robust-aggregation defense primitives (port of
``fedml_tpu/core/robustness.py``; reference:
fedml_core/robustness/robust_aggregation.py).

``norm_diff_clipping`` (:36-47) projects a client update ``w_i - w_g``
onto an L2 ball before averaging, and ``add_gaussian_noise`` (:49-53)
adds weak-DP Gaussian noise to the aggregate. The noise is drawn from
``core/keys.py``, not threefry: the same mechanism, other bits.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import tree_leaves, tree_map


def tree_global_norm(tree):
    """The L2 norm over every leaf (in f32) of a tree."""
    return torch.sqrt(sum((t.float() * t.float()).sum()
                          for t in tree_leaves(tree)))


def norm_diff_clipping(client_params, global_params, norm_bound: float):
    """``w_g + clip(w_i - w_g)``: the diff scaled by
    ``1 / max(1, ||diff|| / norm_bound)``, its norm the global L2 over
    every leaf (the reference's ``weight_diff / max(1, ||diff||/bound)``)."""
    diff = tree_map(torch.sub, client_params, global_params)
    scale = 1.0 / torch.clamp(tree_global_norm(diff) / norm_bound, min=1.0)
    return tree_map(lambda g, d: g + d * scale, global_params, diff)


def gaussian_tree(like, key, stddev: float, batch_dims: int = 0):
    """``stddev`` x standard normals shaped as each leaf of ``like``, leaf
    ``i`` drawn from child ``i`` of ``key``; ``key`` has ``batch_dims``
    leading dims (one stream per client), which the leaves share."""
    leaves = tree_leaves(like)
    leaf_keys = keys.split(key, len(leaves))
    draws = iter([stddev * keys.normal(leaf_keys[..., i],
                                       p.shape[batch_dims:], p.dtype)
                  for i, p in enumerate(leaves)])
    return tree_map(lambda _: next(draws), like)


def add_gaussian_noise(params, key, stddev: float):
    """The weak-DP Gaussian mechanism on the aggregated model: each leaf
    plus ``stddev`` x a standard normal from its own child of ``key``."""
    return tree_map(torch.add, params, gaussian_tree(params, key, stddev))
