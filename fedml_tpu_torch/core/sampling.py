"""Seeded client sampling, reproducing the reference's semantics exactly
(port of ``fedml_tpu/core/sampling.py``, numpy only).

``FedAVGAggregator.client_sampling`` (fedml_api/distributed/fedavg/
FedAVGAggregator.py:90-99) does ``np.random.seed(round_idx)`` then
``np.random.choice(range(total), num, replace=False)``; with full
participation it returns ``range(total)``. The port keeps its own copy:
importing the original would pull in jax through ``fedml_tpu.core``.
"""

from __future__ import annotations

import numpy as np


def sample_clients(round_idx: int, client_num_in_total: int,
                   client_num_per_round: int) -> np.ndarray:
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int32)
    num_clients = min(client_num_per_round, client_num_in_total)
    # Legacy RandomState(seed) generates the same stream as np.random.seed.
    rng = np.random.RandomState(round_idx)
    return rng.choice(client_num_in_total, num_clients,
                      replace=False).astype(np.int32)


def sample_clients_weighted(round_idx: int, client_num_in_total: int,
                            num: int, counts) -> np.ndarray:
    """Data-fraction-proportional candidate draw without replacement
    (Power-of-Choice, Cho et al. 2020), seeded by ``round_idx``; the
    uniform reference stream when fewer than ``num`` clients hold data."""
    if client_num_in_total == num:
        return np.arange(client_num_in_total, dtype=np.int32)
    num = min(num, client_num_in_total)
    counts = np.asarray(counts, dtype=np.float64)
    if counts.shape != (client_num_in_total,):
        raise ValueError(
            f"counts shape {counts.shape} != ({client_num_in_total},); "
            "client_num_in_total must match the federated dataset")
    if np.count_nonzero(counts > 0) < num:
        return sample_clients(round_idx, client_num_in_total, num)
    p = counts / counts.sum()
    rng = np.random.RandomState(round_idx)
    return rng.choice(client_num_in_total, num, replace=False,
                      p=p).astype(np.int32)


def pad_to_multiple(indices: np.ndarray, multiple: int):
    """Pad a sampled index list to a multiple; padded slots repeat index 0
    and carry weight 0. Returns ``(padded_indices, weight_mask)``."""
    n = len(indices)
    if multiple <= 1 or n % multiple == 0:
        return indices, np.ones((n,), dtype=np.float32)
    pad = multiple - (n % multiple)
    padded = np.concatenate(
        [indices, np.full((pad,), indices[0], dtype=indices.dtype)])
    mask = np.concatenate([np.ones((n,), np.float32),
                           np.zeros((pad,), np.float32)])
    return padded, mask
