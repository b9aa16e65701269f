"""Federated partitioners (host-side numpy; port of
``fedml_tpu/data/partition.py``'s ``partition_homo`` and
``partition_dirichlet``). All return ``{client_id: sample indices}``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def partition_homo(n_samples: int, n_clients: int,
                   seed: int = 0) -> Dict[int, np.ndarray]:
    """Uniform split of a seeded permutation (cifar10/data_loader.py:118-121)."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part)
            for i, part in enumerate(np.array_split(idxs, n_clients))}


def partition_dirichlet(labels: np.ndarray, n_clients: int, alpha: float,
                        min_size: int = 10, seed: int = 0,
                        max_retries: int = 1000) -> Dict[int, np.ndarray]:
    """Label-Dirichlet (LDA) partition with the reference's min-size retry
    loop and balancing tweak (noniid_partition.py:6-97): per class,
    p ~ Dir(alpha) over clients, zeroed for clients already holding
    >= n/n_clients samples; retried until every client has ``min_size``."""
    labels = np.asarray(labels).ravel()
    n = len(labels)
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)

    for _ in range(max_retries):
        idx_batch = [[] for _ in range(n_clients)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, n_clients))
            proportions = np.array([
                p * (len(idx_j) < n / n_clients)
                for p, idx_j in zip(proportions, idx_batch)])
            s = proportions.sum()
            if s <= 0:
                proportions = np.ones(n_clients) / n_clients
            else:
                proportions = proportions / s
            cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for j, part in enumerate(np.split(idx_k, cuts)):
                idx_batch[j].extend(part.tolist())
        if min(len(b) for b in idx_batch) >= min_size:
            break
    else:
        raise ValueError(
            f"partition_dirichlet: could not satisfy min_size={min_size} for "
            f"{n_clients} clients over {n} samples (alpha={alpha}) in "
            f"{max_retries} retries; lower min_size or n_clients")

    out = {}
    for j in range(n_clients):
        arr = np.array(idx_batch[j], dtype=np.int64)
        rng.shuffle(arr)
        out[j] = arr
    return out
