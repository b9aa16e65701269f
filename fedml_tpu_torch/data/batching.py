"""Rectangular client-batched layout (port of ``fedml_tpu/data/batching.py``).

Every client's data is padded into one rectangular block of tensors

    x: [num_clients, steps_per_epoch, batch, ...]   (images NHWC)
    y: [num_clients, steps_per_epoch, batch]
    mask: [num_clients, steps_per_epoch, batch]   (1.0 = real sample)
    counts: [num_clients]                          (true local sample count)

on one device, so a round gathers its cohort with ``index_select`` on the
card and local training walks ``steps`` with every client batched along
the leading dim. Masks keep losses and the sample-count-weighted average
exact despite padding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class FederatedArrays:
    x: torch.Tensor  # [C, S, B, ...]
    y: torch.Tensor  # [C, S, B] int64 labels
    mask: torch.Tensor  # [C, S, B] float32
    counts: torch.Tensor  # [C] int32 true sample counts

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def steps_per_epoch(self) -> int:
        return self.x.shape[1]

    @property
    def batch_size(self) -> int:
        return self.x.shape[2]

    @property
    def device(self) -> torch.device:
        return self.x.device


@dataclasses.dataclass
class WindowBatch:
    """W rounds' cohorts stacked on a leading round dim: the superbatch
    that the windowed tier moves in one host-to-device copy per field
    (``data.store.FederatedStore.gather_window`` builds it). Round ``w``'s
    slice is the ``FederatedArrays`` that the host loop would have
    gathered for that round, at the window's step bucket."""

    x: torch.Tensor  # [W, C, S, B, ...]
    y: torch.Tensor  # [W, C, S, B] int64 labels
    mask: torch.Tensor  # [W, C, S, B] float32
    counts: torch.Tensor  # [W, C] int32 true sample counts

    @property
    def num_rounds(self) -> int:
        return self.x.shape[0]

    @property
    def num_clients(self) -> int:
        return self.x.shape[1]

    def round_arrays(self, w: int) -> FederatedArrays:
        """One round's cohort as a ``FederatedArrays`` (views)."""
        return FederatedArrays(x=self.x[w], y=self.y[w], mask=self.mask[w],
                               counts=self.counts[w])


def build_federated_arrays(x: np.ndarray, y: np.ndarray,
                           client_indices: Dict[int, np.ndarray],
                           batch_size: int, max_steps: Optional[int] = None,
                           dtype=None, device=None) -> FederatedArrays:
    """Pack per-client index lists over a global (x, y) store into the
    rectangular layout on ``device`` (``None`` → cuda). Padding replicates
    each client's first sample, masked out."""
    dev = resolve_device(device)
    n_clients = len(client_indices)
    counts = np.array([len(client_indices[c]) for c in range(n_clients)],
                      np.int32)
    steps = int(np.ceil(max(int(counts.max()), 1) / batch_size))
    if max_steps is not None:
        steps = min(steps, max_steps)
    cap = steps * batch_size

    xs = np.zeros((n_clients, cap) + x.shape[1:], dtype or x.dtype)
    ys = np.zeros((n_clients, cap) + y.shape[1:], y.dtype)
    mask = np.zeros((n_clients, cap), np.float32)
    for c in range(n_clients):
        idx = np.asarray(client_indices[c])[:cap]
        k = len(idx)
        if k == 0:
            continue
        xs[c, :k] = x[idx]
        ys[c, :k] = y[idx]
        mask[c, :k] = 1.0
        if k < cap:  # pad with the client's own first sample (masked)
            xs[c, k:] = x[idx[0]]
            ys[c, k:] = y[idx[0]]
    counts = np.minimum(counts, cap)

    def split(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape((n_clients, steps, batch_size) + a.shape[2:]))).to(dev)

    return FederatedArrays(x=split(xs), y=split(ys.astype(np.int64)),
                           mask=split(mask),
                           counts=torch.from_numpy(counts).to(dev))


def gather_clients(fed: FederatedArrays, indices) -> FederatedArrays:
    """On-device gather of a sampled client subset. ``indices`` is a host
    sequence or array (copied to the device), or an int64 tensor on
    ``fed``'s device, taken as it is: no host round trip, so the gather can
    run inside a captured CUDA graph."""
    if torch.is_tensor(indices):
        if indices.dtype != torch.int64 or indices.device != fed.device:
            raise ValueError(
                f"a tensor of client indices must be int64 on {fed.device}, "
                f"got {indices.dtype} on {indices.device}")
        idx = indices
    else:
        idx = torch.as_tensor(np.asarray(indices), dtype=torch.long,
                              device=fed.device)
    return FederatedArrays(x=fed.x.index_select(0, idx),
                           y=fed.y.index_select(0, idx),
                           mask=fed.mask.index_select(0, idx),
                           counts=fed.counts.index_select(0, idx))


def batch_global(x: np.ndarray, y: np.ndarray, batch_size: int,
                 device=None):
    """Pad + reshape a flat (test) set into ``[steps, batch, ...]`` tensors
    with a mask, on ``device`` (``None`` → cuda)."""
    dev = resolve_device(device)
    n = len(x)
    steps = int(np.ceil(n / batch_size))
    cap = steps * batch_size
    pad = cap - n
    xs = np.concatenate([x, np.repeat(x[:1], pad, axis=0)]) if pad else x
    ys = np.concatenate([y, np.repeat(y[:1], pad, axis=0)]) if pad else y
    mask = np.concatenate([np.ones((n,), np.float32),
                           np.zeros((pad,), np.float32)])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (put(xs.reshape((steps, batch_size) + x.shape[1:])),
            put(ys.reshape((steps, batch_size) + y.shape[1:]).astype(
                np.int64)),
            put(mask.reshape(steps, batch_size)))
