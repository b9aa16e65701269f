"""Sharded client directory — the million-client storage tier (port of
``fedml_tpu/data/directory.py``, numpy only).

``FederatedStore`` keeps the whole federation as one in-RSS CSR array
pair: host memory is O(dataset) though a round touches a cohort. This
module splits the store into G shards behind the SAME gather contract,
bit-identically:

- ``ClientDirectory`` is the sampling and metadata service: the client to
  shard map, per-client counts and per-shard tallies (O(clients)
  integers, never the samples). It samples from the counts alone, so a
  round's cohort is the same for any sharding (test-pinned).
- ``ShardedFederatedStore`` subclasses ``FederatedStore`` and overrides
  only the storage primitive ``_fill_rows``: each cohort slot maps to
  (shard, local row range) and is filled by a per-shard fancy-index
  gather. Bucketing, masks, the staging buffers, the copies to the
  device, the gathers and the prefetchers are inherited; a sharded
  gather is byte-identical to the flat store's.
- Shards can be ``np.memmap``-backed (``spill_dir``): the samples live in
  read-only ``.npy`` files and only the pages a gather touches become
  resident. ``from_shard_builder`` builds one shard at a time (generate,
  spill, drop), so even the build's peak RSS is one shard's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.core.sampling import (sample_clients,
                                           sample_clients_weighted)
from fedml_tpu_torch.data.store import FederatedStore


class ClientDirectory:
    """Client→shard map + count metadata: the part of a federation a
    cohort SAMPLER needs, decoupled from the sample arrays.

    ``counts[c]`` is client c's sample count (already capped by any
    ``max_steps`` truncation), ``shard_of[c]`` its shard. Within a shard,
    clients are stored in ascending global-id order, so
    ``local_row_start[c]`` (the first row of client c inside its shard's
    arrays) is the exclusive cumsum of the shard's counts in id order.
    """

    def __init__(self, counts, shard_of, num_shards: Optional[int] = None):
        counts = np.asarray(counts, np.int64)
        shard_of = np.asarray(shard_of, np.int32)
        if counts.shape != shard_of.shape:
            raise ValueError(
                f"counts {counts.shape} and shard_of {shard_of.shape} must "
                "have one entry per client")
        n = len(counts)
        g = int(num_shards if num_shards is not None
                else (shard_of.max() + 1 if n else 0))
        if n and (shard_of.min() < 0 or shard_of.max() >= g):
            raise ValueError(
                f"shard ids must be in [0, {g}); got "
                f"[{shard_of.min()}, {shard_of.max()}]")
        self.counts = counts.astype(np.int32)
        self.shard_of = shard_of
        self.num_clients = n
        self.num_shards = g
        self.shard_clients = np.bincount(shard_of, minlength=g).astype(
            np.int64)
        self.shard_rows = (np.bincount(shard_of, weights=counts,
                                       minlength=g).astype(np.int64)
                           if n else np.zeros(g, np.int64))
        # local_row_start in ONE grouped pass (a per-shard boolean scan
        # would be O(G·N) — minutes at 1M clients with thousands of
        # shards): order clients by (shard, id), take the global
        # exclusive row cumsum in that order, and subtract each shard's
        # starting row.
        self.local_row_start = np.zeros(n, np.int64)
        if n:
            order = np.argsort(shard_of, kind="stable")  # id-sorted within
            excl = np.concatenate([[0], np.cumsum(counts[order])[:-1]])
            shard_row_start = np.concatenate(
                [[0], np.cumsum(self.shard_rows)[:-1]])
            self.local_row_start[order] = \
                excl - shard_row_start[shard_of[order]]

    # -- the sampling service -------------------------------------------
    # Both draws consume ONLY directory metadata (never sample arrays)
    # and delegate to core/sampling's reference-seeded streams, so the
    # cohort a round samples is a pure function of (seed, total, num) —
    # identical for the flat store and ANY sharding of it (the
    # re-sharding determinism invariant, pinned in tests/test_torch_directory).

    def sample_cohort(self, round_idx: int, num: int) -> np.ndarray:
        """Seeded-uniform cohort draw (the reference's
        ``np.random.seed(round_idx)`` stream, ``core/sampling``)."""
        return sample_clients(round_idx, self.num_clients, num)

    def sample_cohort_weighted(self, round_idx: int, num: int) -> np.ndarray:
        """Data-fraction-proportional draw over the directory's counts
        (Power-of-Choice candidate sampling) — still no sample arrays."""
        return sample_clients_weighted(
            round_idx, self.num_clients, num, self.counts)

    def shard_histogram(self, indices) -> np.ndarray:
        """``[G]`` — how many of ``indices`` live on each shard (gather
        planning / hot-shard accounting)."""
        return np.bincount(self.shard_of[np.asarray(indices)],
                           minlength=self.num_shards)

    def agg_shard_of(self, indices, num_agg_shards: int):
        """Aggregator-shard assignment for the sharded aggregation plane
        (the JAX package's comm/shardplane.py): fold the ``G`` DATA
        shards onto ``M`` aggregator shards by modulo, so clients that share a data shard
        share an aggregator shard whenever ``M`` divides ``G`` — upload
        locality follows storage locality. Scalar in → scalar out;
        array in → int32 array."""
        m = int(num_agg_shards)
        if m < 1:
            raise ValueError(f"num_agg_shards={num_agg_shards} must be >= 1")
        if np.isscalar(indices):
            return int(self.shard_of[int(indices)]) % m
        return (self.shard_of[np.asarray(indices)] % m).astype(np.int32)

    def nbytes(self) -> int:
        return (self.counts.nbytes + self.shard_of.nbytes
                + self.local_row_start.nbytes + self.shard_clients.nbytes
                + self.shard_rows.nbytes)


def _spill(arr: np.ndarray, path: str) -> np.ndarray:
    """Write ``arr`` to a ``.npy`` memmap and reopen READ-ONLY: the dirty
    build pages are unmapped on close (RSS drops back), and subsequent
    gathers fault in only the pages they touch."""
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                   shape=arr.shape)
    mm[...] = arr
    mm.flush()
    del mm
    return np.load(path, mmap_mode="r")


class StoreShard:
    """One shard's sample storage: rows of its clients in ascending
    global-client-id order (``x [rows, ...]``, ``y [rows, ...]`` — plain
    ndarray or read-only memmap)."""

    __slots__ = ("x", "y")

    def __init__(self, x: np.ndarray, y: np.ndarray):
        if len(x) != len(y):
            raise ValueError(f"shard x/y row mismatch: {len(x)} vs {len(y)}")
        self.x = x
        self.y = y


class ShardedFederatedStore(FederatedStore):
    """G-sharded ``FederatedStore``: same gather contract, bit-identical
    output, host RSS O(cohort + hot shards). Construct via
    :meth:`from_flat` (split an in-memory federation; tests,
    medium scale) or :meth:`from_shard_builder` (per-shard generation +
    memmap spill; million-client scale)."""

    def __init__(self, shards: Sequence[StoreShard],
                 directory: ClientDirectory, batch_size: int,
                 max_steps: Optional[int] = None, device=None):
        if len(shards) != directory.num_shards:
            raise ValueError(
                f"{len(shards)} shards vs directory.num_shards="
                f"{directory.num_shards}")
        for s, sh in enumerate(shards):
            if len(sh.x) != directory.shard_rows[s]:
                raise ValueError(
                    f"shard {s} holds {len(sh.x)} rows; directory expects "
                    f"{int(directory.shard_rows[s])}")
        self._shards = list(shards)
        self.directory = directory
        ref = shards[0].x if shards else np.zeros((0, 1), np.float32)
        refy = shards[0].y if shards else np.zeros((0,), np.int64)
        self._init_meta(directory.counts, batch_size, max_steps,
                        ref.shape[1:], ref.dtype, refy.shape[1:], device)

    # -- the storage primitive ------------------------------------------
    def _fill_rows(self, idx: np.ndarray, cap: int,
                   xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        """Per-shard fancy-index gather: each cohort slot's rows come
        from ``local_row_start[client] + position`` inside its shard
        (positions past the count repeat the first row — the same pad
        rule as the flat CSR row map). Empty slots are left for the
        caller to zero, exactly the flat contract. On memmap shards the
        fancy index reads only the touched rows' pages."""
        d = self.directory
        flat = idx.reshape(-1)
        n = (self.offsets[flat + 1] - self.offsets[flat]).astype(np.int64)
        lo = d.local_row_start[flat]
        pos = np.arange(cap, dtype=np.int64)
        rows = lo[:, None] + np.where(pos < n[:, None], pos, 0)
        empty = n == 0
        sid = d.shard_of[flat]
        xf = xs.reshape((-1, cap) + self._sample_shape)
        yf = ys.reshape((-1, cap) + self._label_shape)
        for s in np.unique(sid):
            m = (sid == s) & ~empty
            if not m.any():
                continue
            sh = self._shards[s]
            xf[m] = sh.x[rows[m]]
            yf[m] = sh.y[rows[m]]
        return empty.reshape(idx.shape)

    def _gather_cohort_loop(self, indices, steps=None):
        raise NotImplementedError(
            "the scalar copy-loop reference lives on the flat "
            "FederatedStore; sharded gathers are pinned bit-equal to the "
            "flat store's instead (tests/test_torch_directory.py)")

    def nbytes(self) -> int:
        """Total DATASET bytes across shards (memmap shards count their
        file size, not their resident pages)."""
        return sum(sh.x.nbytes + sh.y.nbytes for sh in self._shards)

    @property
    def memmapped(self) -> bool:
        return any(isinstance(sh.x, np.memmap) for sh in self._shards)

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_flat(cls, x: np.ndarray, y: np.ndarray,
                  client_indices: Dict[int, np.ndarray], batch_size: int,
                  num_shards: int = 1, shard_of=None,
                  max_steps: Optional[int] = None,
                  spill_dir: Optional[str] = None,
                  device=None) -> "ShardedFederatedStore":
        """Split an in-memory federation (the ``FederatedStore``
        constructor signature plus sharding controls). ``shard_of``
        assigns clients to shards arbitrarily (per group / per host);
        default is ``num_shards`` contiguous client blocks. With
        ``spill_dir`` each shard is memmap-spilled."""
        n_clients = len(client_indices)
        counts = np.array(
            [len(client_indices[c]) for c in range(n_clients)], np.int64)
        if max_steps is not None:
            counts = np.minimum(counts, max_steps * batch_size)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if shard_of is None:
            shard_of = ((np.arange(n_clients) * num_shards)
                        // max(n_clients, 1)).astype(np.int32)
        else:
            # An explicit num_shards larger than the map's max id keeps
            # its trailing EMPTY shards (mirroring a host layout where
            # some hosts currently hold no clients) instead of being
            # silently discarded.
            shard_of = np.asarray(shard_of, np.int32)
            num_shards = max(num_shards,
                             int(shard_of.max()) + 1 if n_clients else 0)
        directory = ClientDirectory(counts, shard_of, num_shards)
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        shards = []
        for s in range(num_shards):
            cl = np.flatnonzero(shard_of == s)  # ascending global id
            order = (np.concatenate(
                [np.asarray(client_indices[c])[: counts[c]] for c in cl])
                if cl.size and counts[cl].sum() else np.zeros((0,), np.int64))
            sx = np.ascontiguousarray(x[order])
            sy = np.ascontiguousarray(y[order].astype(np.int64))
            if spill_dir is not None:
                sx = _spill(sx, os.path.join(spill_dir, f"shard{s:05d}_x.npy"))
                sy = _spill(sy, os.path.join(spill_dir, f"shard{s:05d}_y.npy"))
            shards.append(StoreShard(sx, sy))
        return cls(shards, directory, batch_size, max_steps=max_steps,
                   device=device)

    @classmethod
    def from_shard_builder(
            cls,
            builder: Callable[[int], Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]],
            num_shards: int, batch_size: int, spill_dir: str,
            progress: Optional[Callable[[int], None]] = None,
            device=None) -> "ShardedFederatedStore":
        """Build one shard at a time: ``builder(s) -> (x_s, y_s,
        counts_s)`` where ``counts_s`` are the per-client sample counts
        of shard s's clients and shard s owns the NEXT ``len(counts_s)``
        global client ids (contiguous blocks, in shard order). Each
        shard is generated, memmap-spilled, and DROPPED before the next
        is built, so construction peak RSS is O(one shard).
        ``progress(s)`` is called before
        each shard build (deadline checks / logging)."""
        os.makedirs(spill_dir, exist_ok=True)
        shards: List[StoreShard] = []
        count_parts: List[np.ndarray] = []
        for s in range(num_shards):
            if progress is not None:
                progress(s)
            sx, sy, scounts = builder(s)
            scounts = np.asarray(scounts, np.int64)
            if len(sx) != int(scounts.sum()):
                raise ValueError(
                    f"builder({s}) returned {len(sx)} rows but counts sum "
                    f"to {int(scounts.sum())}")
            shards.append(StoreShard(
                _spill(np.ascontiguousarray(sx),
                       os.path.join(spill_dir, f"shard{s:05d}_x.npy")),
                _spill(np.ascontiguousarray(np.asarray(sy, np.int64)),
                       os.path.join(spill_dir, f"shard{s:05d}_y.npy"))))
            count_parts.append(scounts)
            del sx, sy  # peak RSS stays O(one shard)
        counts = (np.concatenate(count_parts) if count_parts
                  else np.zeros((0,), np.int64))
        shard_of = (np.repeat(np.arange(num_shards, dtype=np.int32),
                              [len(p) for p in count_parts])
                    if count_parts else np.zeros((0,), np.int32))
        directory = ClientDirectory(counts, shard_of, num_shards)
        return cls(shards, directory, batch_size, device=device)
