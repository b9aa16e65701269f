"""Topology managers for decentralized FL (a numpy copy of
``fedml_tpu/core/topology.py``; the port imports nothing of ``fedml_tpu``).

Parity: fedml_core/distributed/topology/ — ring (Watts–Strogatz k=2 p=0)
plus random symmetric/asymmetric extra links, row-normalized into a mixing
matrix (symmetric_topology_manager.py:22-52, asymmetric variant). The
seeded ``np.random.RandomState`` draws are the JAX package's, so the
matrices are bit-equal to its.

The topology is a dense ``[n, n]`` mixing matrix ``W``, so one round of
neighbor gossip over ALL clients is one product ``W @ stacked`` per
parameter leaf (``algos/decentralized.py``), where the reference sends
one MPI message per neighbor (decentralized_worker_manager.py:29-39).
"""

from __future__ import annotations

import numpy as np


class BaseTopologyManager:
    """ABC parity: base_topology_manager.py:4-28."""

    topology: np.ndarray  # [n, n] row-stochastic mixing weights

    def get_in_neighbor_idx_list(self, node_index: int):
        return [
            j for j in range(self.n) if self.topology[j][node_index] > 0 and j != node_index
        ]

    def get_out_neighbor_idx_list(self, node_index: int):
        return [
            j for j in range(self.n) if self.topology[node_index][j] > 0 and j != node_index
        ]

    def get_in_neighbor_weights(self, node_index: int):
        return [self.topology[j][node_index] for j in range(self.n)]

    def get_out_neighbor_weights(self, node_index: int):
        return [self.topology[node_index][j] for j in range(self.n)]

    def mixing_matrix(self) -> np.ndarray:
        return self.topology


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring + undirected random links, row-normalized
    (symmetric_topology_manager.py:22-52)."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = n
        self.neighbor_num = min(neighbor_num, max(n - 1, 1))
        self.seed = seed
        self.generate_topology()

    def generate_topology(self):
        n, k = self.n, self.neighbor_num
        # Explicit ring (±1 mod n) so connectivity never silently degrades
        # (watts_strogatz with odd/clamped k can drop links — e.g. n=2
        # would otherwise yield an edgeless graph and gossip would be a
        # no-op with no warning).
        topo = np.eye(n)
        for i in range(n):
            topo[i, (i + 1) % n] = 1.0
            topo[i, (i - 1) % n] = 1.0
        # sprinkle undirected random links like the reference's
        # "np.random.seed + random positions" loop
        rng = np.random.RandomState(self.seed)
        k_extra = max(k - 2, 0)
        for i in range(n):
            if k_extra == 0:
                break
            js = rng.choice(n, k_extra, replace=False)
            topo[i, js] = 1.0
            topo[js, i] = 1.0
        row_sums = topo.sum(axis=1, keepdims=True)
        self.topology = topo / row_sums


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed ring + random out-links, row-normalized (asymmetric variant,
    fedml_core/distributed/topology/asymmetric_topology_manager.py)."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = n
        self.neighbor_num = min(neighbor_num, max(n - 1, 1))
        self.seed = seed
        self.generate_topology()

    def generate_topology(self):
        n = self.n
        topo = np.eye(n)
        for i in range(n):
            topo[i, (i + 1) % n] = 1.0  # directed ring
        rng = np.random.RandomState(self.seed)
        for i in range(n):
            extra = rng.choice(n, self.neighbor_num, replace=False)
            topo[i, extra] = 1.0
        self.topology = topo / topo.sum(axis=1, keepdims=True)


def column_stochastic(topology: np.ndarray) -> np.ndarray:
    """Column-normalized variant (PushSum needs column-stochastic weights)."""
    return topology / topology.sum(axis=0, keepdims=True)
