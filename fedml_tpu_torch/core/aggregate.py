"""Server-side aggregation primitives (port of
``fedml_tpu/core/aggregate.py``): the sample-count-weighted average and
the FedOpt pseudo-gradient, over parameter trees (dicts of tensors)."""

from __future__ import annotations

import torch

from fedml_tpu_torch.core.tree import tree_map, tree_weighted_mean


def weighted_average(stacked_params, sample_counts):
    """FedAvg: the client params ``[C, ...]`` averaged with weights the
    true local sample counts (FedAVGAggregator.py:78-82)."""
    return tree_weighted_mean(stacked_params, torch.as_tensor(sample_counts))


def pseudo_gradient(old_params, avg_params):
    """The server pseudo-gradient ``old - avg`` of the FedOpt family
    (fedml_api/distributed/fedopt/FedOptAggregator.py:95-109)."""
    return tree_map(torch.sub, old_params, avg_params)
