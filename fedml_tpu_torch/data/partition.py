"""Federated partitioners (host-side numpy; port of
``fedml_tpu/data/partition.py``): uniform, label-Dirichlet and power-law
splits, and the per-client class histogram. The partitioners return
``{client_id: sample indices}``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def partition_homo(n_samples: int, n_clients: int,
                   seed: int = 0) -> Dict[int, np.ndarray]:
    """Uniform split of a seeded permutation
    (cifar10/data_loader.py:118-121)."""
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


def partition_power_law(
    n_samples: int,
    n_clients: int,
    seed: int = 0,
    sigma: float = 2.0,
    min_size: int = 2,
) -> Dict[int, np.ndarray]:
    """Heavy-tailed client sizes drawn from a lognormal, normalised to cover
    the dataset once (LEAF-style power-law split)."""
    rng = np.random.RandomState(seed)
    # min_size must be feasible; otherwise relax it to an even split.
    min_size = min(min_size, n_samples // n_clients)
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=n_clients) + 1e-9
    sizes = np.maximum((raw / raw.sum() * n_samples).astype(int), min_size)
    # Fix rounding drift so sizes sum exactly to n_samples. Increments go to
    # the largest clients first; decrements stop at min_size (always feasible
    # because n_clients * min_size <= n_samples).
    drift = n_samples - int(sizes.sum())
    order = np.argsort(-sizes)
    i = 0
    while drift != 0:
        j = order[i % n_clients]
        step = 1 if drift > 0 else -1
        if sizes[j] + step >= min_size:
            sizes[j] += step
            drift -= step
        i += 1
    idxs = rng.permutation(n_samples)
    out, pos = {}, 0
    for j in range(n_clients):
        out[j] = np.sort(idxs[pos : pos + sizes[j]])
        pos += sizes[j]
    return out


def record_data_stats(labels: np.ndarray,
                      net_dataidx_map: Dict[int, np.ndarray]):
    """Per-client class histogram (noniid_partition.py:98-102)."""
    labels = np.asarray(labels).ravel()
    stats = {}
    for client, idxs in net_dataidx_map.items():
        unq, counts = np.unique(labels[idxs], return_counts=True)
        stats[client] = {int(u): int(c) for u, c in zip(unq, counts)}
    return stats
