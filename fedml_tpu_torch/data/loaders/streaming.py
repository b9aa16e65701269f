"""Streaming datasets for decentralized online learning (UCI SUSY / Room-
Occupancy), reference ``fedml_api/data_preprocessing/UCI/
data_loader_for_susy_and_ro.py:7-126`` (port of
``fedml_tpu/data/loaders/streaming.py``).

The reference's DataLoader reads a CSV, optionally clusters features with
k-means to create heterogeneous client streams ("adversarial" mode) or
shuffles uniformly ("stochastic"), then deals samples round-robin to
clients as an online stream. Same semantics here, numpy-only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np


def _kmeans(x: np.ndarray, k: int, iters: int = 20, seed: int = 0) -> np.ndarray:
    """Tiny k-means (scipy-free) for the adversarial stream ordering."""
    rng = np.random.RandomState(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    assign = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            m = assign == j
            if m.any():
                centers[j] = x[m].mean(0)
    return assign


class StreamingDataLoader:
    """``load_datastream()`` → per-client list of (x, y) sample streams.

    mode="stochastic": uniform shuffle then round-robin deal;
    mode="adversarial": sort by k-means cluster so each client sees a
    drifting distribution (reference read_csv_file_for_cluster:92-120).
    """

    def __init__(
        self,
        data_name: str = "SUSY",
        data_path: str | None = None,
        client_list: List[int] | None = None,
        sample_num_in_total: int = 2000,
        beta: float = 0.5,
        mode: str = "stochastic",
        n_features: int = 18,
        seed: int = 0,
    ):
        self.data_name = data_name
        self.client_list = client_list or list(range(8))
        self.n = sample_num_in_total
        self.beta = beta
        self.mode = mode
        rng = np.random.RandomState(seed)
        if data_path and os.path.isfile(data_path):
            raw = np.genfromtxt(data_path, delimiter=",", max_rows=self.n)
            self.y = raw[:, 0].astype(np.float32)
            self.x = raw[:, 1:].astype(np.float32)
        else:
            w = rng.randn(n_features)
            self.x = rng.randn(self.n, n_features).astype(np.float32)
            self.y = (self.x @ w > 0).astype(np.float32)
        self.x = (self.x - self.x.mean(0)) / (self.x.std(0) + 1e-6)

    def load_datastream(self) -> Dict[int, List[Tuple[np.ndarray, np.ndarray]]]:
        k = len(self.client_list)
        rng = np.random.RandomState(1)
        if self.mode == "adversarial":
            order = np.argsort(_kmeans(self.x, k, seed=2), kind="stable")
        else:
            order = rng.permutation(len(self.x))
        streams: Dict[int, List] = {c: [] for c in self.client_list}
        for i, idx in enumerate(order):
            c = self.client_list[i % k]
            streams[c].append((self.x[idx], self.y[idx]))
        return streams

    def stream_arrays(self):
        """Rectangular [clients, T, d] / [clients, T] arrays for the
        on-device gossip simulator (truncated to the min stream length)."""
        streams = self.load_datastream()
        t = min(len(v) for v in streams.values())
        xs = np.stack([np.stack([s[0] for s in streams[c][:t]]) for c in self.client_list])
        ys = np.stack([np.stack([s[1] for s in streams[c][:t]]) for c in self.client_list])
        return xs, ys
