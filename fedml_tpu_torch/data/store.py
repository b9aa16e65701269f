"""Host-resident federated dataset with per-round cohort streaming (port
of ``fedml_tpu/data/store.py``).

The resident ``FederatedArrays`` layout pads every client to the largest
one and keeps the whole dataset on the card: fine at 128 clients, not at
the reference's client counts (FederatedEMNIST's 3,400 writers,
StackOverflow's 342,477 users), and on power-law partitions one giant
client inflates every client's padded rows.

``FederatedStore`` keeps the dataset as host numpy in CSR form (one flat
sample array sorted by client, and offsets) and puts only the sampled
cohort on the device each round:

- device memory per round is cohort × cohort steps × batch, whatever the
  total client count;
- a cohort is padded to ITS OWN largest count, bucketed to a power of two
  steps, so the captured rounds see a handful of shapes;
- ``gather_cohort`` returns a regular ``FederatedArrays``, which the
  rounds consume as they consume the resident gather;
- ``gather_window`` stacks W rounds' cohorts into one ``[W, k, S, B,
  ...]`` superbatch (one fancy-index gather into reused staging buffers
  and one host-to-device copy per field) for the windowed tier;
- ``CohortPrefetcher`` and ``WindowPrefetcher`` run the next round's (or
  window's) gather and copy on a worker thread while the card trains.

On the card the host buffers are pinned (``torch.empty(...,
pin_memory=True)``) and filled in place (``np.take(..., out=)``); each
copy is ``non_blocking`` on a copy stream of its own (the prefetcher's,
or the store's for a direct call), with an event that the consuming
stream waits on before it reads the tensors. A window's staging buffers
are reused, so the staging lock is held until its copy's event has
completed: the next window refills them. The device work of a copy holds
``core.graph.capture_lock``, so it never runs inside a capture of another
thread. On the CPU the put is a copy: it never aliases the staging
buffers.

``data/directory.py``'s ``ShardedFederatedStore`` overrides only the
storage primitive :meth:`FederatedStore._fill_rows`.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.graph import capture_lock
from fedml_tpu_torch.data.batching import FederatedArrays, WindowBatch


def _bucket_steps(steps: int) -> int:
    """Round up to a power of two: at most log2(max_steps) + 1 distinct
    cohort shapes, hence captured graphs."""
    steps = max(int(steps), 1)
    return 1 << (steps - 1).bit_length()


def bucket_steps_for_counts(counts, batch_size: int) -> np.ndarray:
    """:func:`_bucket_steps` of every client's step need, vectorized
    (exact bit-twiddling round-up, no float log2)."""
    steps = np.maximum(
        -(-np.asarray(counts, np.int64) // int(batch_size)),
        1).astype(np.uint64)
    v = steps - 1
    for shift in (1, 2, 4, 8, 16, 32):
        v |= v >> np.uint64(shift)
    return (v + 1).astype(np.int64)


class _Staged:
    """Tensors on their way to the device: ``value`` (a ``FederatedArrays``
    or ``WindowBatch``) and the copy's ``event`` (None on the CPU)."""

    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value, self.event = value, event


class FederatedStore:
    """CSR host store over a federated dataset. ``client_indices`` maps
    client id (0..C-1) to index arrays into ``(x, y)``, as for
    ``build_federated_arrays``; the samples are copied into client order
    once, so each client's block is one contiguous slice. Labels are kept
    as int64, the resident layout's dtype. Cohorts go to ``device``
    (``None`` → cuda)."""

    def __init__(self, x: np.ndarray, y: np.ndarray,
                 client_indices: Dict[int, np.ndarray], batch_size: int,
                 max_steps: Optional[int] = None, device=None):
        n_clients = len(client_indices)
        counts = np.array(
            [len(client_indices[c]) for c in range(n_clients)], np.int64)
        if max_steps is not None:
            counts = np.minimum(counts, max_steps * batch_size)
        order = np.concatenate(
            [np.asarray(client_indices[c])[: counts[c]]
             for c in range(n_clients)]) if counts.sum() else \
            np.zeros((0,), np.int64)
        self._x = np.ascontiguousarray(x[order])
        self._y = np.ascontiguousarray(y[order].astype(np.int64))
        self._init_meta(counts, batch_size, max_steps, x.shape[1:], x.dtype,
                        y.shape[1:], device)

    def _init_meta(self, counts, batch_size, max_steps, sample_shape,
                   sample_dtype, label_shape, device):
        """Everything about the store that is not its sample storage;
        ``ShardedFederatedStore`` shares it."""
        counts = np.asarray(counts, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.counts = counts.astype(np.int32)
        self.batch_size = int(batch_size)
        self.max_steps = max_steps
        self.num_clients = len(counts)
        self.device = resolve_device(device)
        self._sample_shape = tuple(sample_shape)
        self._sample_dtype = np.dtype(sample_dtype)
        self._label_shape = tuple(label_shape)
        self._label_dtype = np.dtype(np.int64)
        # One reused host staging buffer per (field, shape, dtype) for the
        # window superbatches, under a lock held until their copy is done.
        self._staging: Dict[tuple, torch.Tensor] = {}
        self._staging_lock = threading.Lock()
        self._stream = None

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def example_input(self) -> np.ndarray:
        """One zero batch of the store's sample shape and dtype."""
        return np.zeros((self.batch_size,) + self._sample_shape,
                        self._sample_dtype)

    def nbytes(self) -> int:
        return self._x.nbytes + self._y.nbytes

    def cohort_steps(self, indices) -> int:
        """The power-of-two step bucket a cohort needs, without gathering
        it (the windowed tier plans its windows with it)."""
        ccounts = self.counts[np.asarray(indices)]
        return _bucket_steps(
            int(np.ceil(max(int(ccounts.max()), 1) / self.batch_size)))

    def _resolve_steps(self, ccounts: np.ndarray, steps: Optional[int]):
        bs = self.batch_size
        need = _bucket_steps(int(np.ceil(max(int(ccounts.max()), 1) / bs)))
        if steps is None:
            return need
        if steps < need:
            raise ValueError(
                f"forced steps {steps} < cohort need {need} "
                f"(max client count {int(ccounts.max())}, batch {bs})")
        return int(steps)

    def _rowmap(self, idx: np.ndarray, cap: int):
        """For every cohort slot and sample position, the row of the flat
        CSR arrays to copy; positions past a client's count repeat its
        first row (the masked own-first-sample pad rule). Returns ``(rows
        [*idx.shape, cap], empty [*idx.shape])``: the rows of an empty
        client point at row 0 and are zeroed after the gather."""
        lo = self.offsets[idx].astype(np.int64)
        n = (self.offsets[idx + 1] - self.offsets[idx]).astype(np.int64)
        pos = np.arange(cap, dtype=np.int64)
        rows = lo[..., None] + np.where(pos < n[..., None], pos, 0)
        empty = n == 0
        if empty.any():
            rows = np.where(empty[..., None], 0, rows)
        return rows, empty

    def _fill_rows(self, idx: np.ndarray, cap: int, xs: np.ndarray,
                   ys: np.ndarray) -> np.ndarray:
        """The storage primitive behind both gathers: fill ``xs [*idx.shape,
        cap, ...]`` and ``ys`` with each slot's rows and return the bool
        mask of empty slots (whose rows the caller zeroes)."""
        rows, empty = self._rowmap(idx, cap)
        np.take(self._x, rows, axis=0, out=xs)
        np.take(self._y, rows, axis=0, out=ys)
        return empty

    # --- host buffers and the copy to the device -------------------------
    def _host(self, shape, dtype) -> torch.Tensor:
        """A fresh host buffer, filled in place through its ``.numpy()``
        view: pinned on the card (the caching host allocator keeps it
        until the copies that read it are done), plain on the CPU."""
        dtype = _torch_dtype(dtype)
        if not self._cuda:
            return torch.empty(shape, dtype=dtype)
        with capture_lock:
            return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _staged(self, field: str, shape: tuple, dtype) -> torch.Tensor:
        """The reused staging buffer of ``(field, shape, dtype)``: windows of
        the same bucket refill the same memory. Caller holds
        ``_staging_lock``."""
        key = (field, shape, np.dtype(dtype).str)
        buf = self._staging.get(key)
        if buf is None:
            buf = self._staging[key] = self._host(shape, dtype)
        return buf

    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _put(self, tensors, stream, wait: bool) -> tuple:
        """Host tensors on the device: on the card, non-blocking copies on
        ``stream`` and an event recorded after them (``wait`` blocks until
        it completes); on the CPU, copies. Returns ``(tensors, event)``."""
        if not self._cuda:
            return tuple(t.clone() for t in tensors), None
        with capture_lock, torch.cuda.stream(stream):
            out = tuple(torch.empty(t.shape, dtype=t.dtype,
                                    device=self.device).copy_(
                                        t, non_blocking=True)
                        for t in tensors)
            event = torch.cuda.Event()
            event.record(stream)
            if wait:
                event.synchronize()
        return out, event

    def _fields(self, idx, ccounts, cap, xs, ys):
        """Fills ``xs``/``ys`` (host tensors) with the slots' rows, zeroes
        the empty slots', and returns the mask and the counts as host
        tensors."""
        xn, yn = xs.numpy(), ys.numpy()
        empty = self._fill_rows(idx, cap, xn, yn)
        if empty.any():
            xn[empty] = 0
            yn[empty] = 0
        mask = self._host(ccounts.shape + (cap,), np.float32)
        mask.numpy()[...] = np.arange(cap) < ccounts[..., None]
        counts = self._host(ccounts.shape, np.int32)
        counts.numpy()[...] = ccounts
        return mask, counts

    def _ready(self, staged: _Staged):
        """``staged.value`` for the calling thread's current stream: the
        stream waits for the copy, and the tensors are recorded on it, so
        the caching allocator keeps them until its work is done."""
        if staged.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.event)
            v = staged.value
            for t in (v.x, v.y, v.mask, v.counts):
                t.record_stream(cur)
        return staged.value

    # --- the gathers -------------------------------------------------------
    def gather_cohort(self, indices, steps: Optional[int] = None
                      ) -> FederatedArrays:
        """The sampled clients as a ``FederatedArrays`` on the store's
        device, padded to the cohort's own largest count (a power-of-two
        step bucket). Duplicate indices are fine. One vectorized
        fancy-index gather per field, byte-identical to
        :meth:`_gather_cohort_loop`. ``steps`` forces the step bucket (it
        must cover the cohort's need)."""
        stream = self._copy_stream() if self._cuda else None
        return self._ready(self._gather_cohort_staged(indices, steps,
                                                      stream))

    def _gather_cohort_staged(self, indices, steps, stream) -> _Staged:
        idx = np.asarray(indices)
        k = len(idx)
        ccounts = self.counts[idx]
        steps = self._resolve_steps(ccounts, steps)
        cap = steps * self.batch_size
        xs = self._host((k, cap) + self._sample_shape, self._sample_dtype)
        ys = self._host((k, cap) + self._label_shape, self._label_dtype)
        mask, counts = self._fields(idx, ccounts, cap, xs, ys)
        lead = (k, steps, self.batch_size)
        (x, y, m, c), event = self._put(
            (xs.view(lead + self._sample_shape),
             ys.view(lead + self._label_shape), mask.view(lead), counts),
            stream, wait=False)
        return _Staged(FederatedArrays(x=x, y=y, mask=m, counts=c), event)

    def _gather_cohort_loop(self, indices,
                            steps: Optional[int] = None) -> FederatedArrays:
        """The per-client copy loop, kept as the scalar REFERENCE that
        :meth:`gather_cohort` is pinned byte-identical to; no hot path uses
        it. Returns CPU tensors."""
        idx = np.asarray(indices)
        k = len(idx)
        ccounts = self.counts[idx]
        steps = self._resolve_steps(ccounts, steps)
        cap = steps * self.batch_size
        xs = np.zeros((k, cap) + self._x.shape[1:], self._x.dtype)
        ys = np.zeros((k, cap) + self._y.shape[1:], self._y.dtype)
        mask = np.zeros((k, cap), np.float32)
        for j, c in enumerate(idx):
            lo, hi = int(self.offsets[c]), int(self.offsets[c + 1])
            n = hi - lo
            if n == 0:
                continue
            xs[j, :n] = self._x[lo:hi]
            ys[j, :n] = self._y[lo:hi]
            mask[j, :n] = 1.0
            if n < cap:  # pad with the client's own first sample (masked)
                xs[j, n:] = self._x[lo]
                ys[j, n:] = self._y[lo]

        def split(a):
            return torch.from_numpy(
                a.reshape((k, steps, self.batch_size) + a.shape[2:]))

        return FederatedArrays(x=split(xs), y=split(ys), mask=split(mask),
                               counts=torch.from_numpy(ccounts.copy()))

    def window_weights(self, window_indices, wmask) -> np.ndarray:
        """``[W, k]`` float32 aggregation weights of a window: the slots'
        sample counts, zeroed at padded slots (``wmask``) — the host
        loop's ``counts * wmask``."""
        idx = np.asarray(window_indices)
        return (self.counts[idx].astype(np.float32)
                * np.asarray(wmask, np.float32))

    def window_trained_mask(self, window_indices, wmask) -> np.ndarray:
        """``[W, k]`` float32: 1 where a slot trains in its round (active
        and not empty), the scatter gate of client-stacked state."""
        idx = np.asarray(window_indices)
        return (np.asarray(wmask, np.float32)
                * (self.counts[idx] > 0).astype(np.float32))

    def gather_window(self, window_indices, steps: int) -> WindowBatch:
        """W rounds' cohorts as ONE ``[W, k, S, B, ...]`` superbatch on the
        device: one fancy-index gather per field into reused staging
        buffers and one copy per field. ``window_indices`` is ``[W, k]``;
        ``steps`` the window's shared bucket, which must cover every
        round's need. A round whose own bucket is smaller gets more masked
        pad rows: its slice equals ``gather_cohort(idx, steps=steps)``, and
        training on it is a no-op beyond its own bucket (the trainer's
        shuffle is prefix-stable in the step count, and all-masked steps
        are gated)."""
        stream = self._copy_stream() if self._cuda else None
        return self._ready(self._gather_window_staged(window_indices, steps,
                                                      stream))

    def _gather_window_staged(self, window_indices, steps, stream
                              ) -> _Staged:
        idx = np.asarray(window_indices)
        if idx.ndim != 2:
            raise ValueError(f"window_indices must be [W, k], got {idx.shape}")
        w, k = idx.shape
        ccounts = self.counts[idx]
        steps = self._resolve_steps(ccounts, steps)
        cap = steps * self.batch_size
        lead = (w, k, steps, self.batch_size)
        with self._staging_lock:
            xs = self._staged("x", (w, k, cap) + self._sample_shape,
                              self._sample_dtype)
            ys = self._staged("y", (w, k, cap) + self._label_shape,
                              self._label_dtype)
            mask, counts = self._fields(idx, ccounts, cap, xs, ys)
            # The copy completes inside the lock: the next window refills
            # xs and ys once it is released.
            (x, y, m, c), event = self._put(
                (xs.view(lead + self._sample_shape),
                 ys.view(lead + self._label_shape), mask.view(lead), counts),
                stream, wait=True)
        return _Staged(WindowBatch(x=x, y=y, mask=m, counts=c), event)


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, dtype)).dtype


class CohortPrefetcher:
    """Double buffer: round r + 1's cohort (host gather and copy) prepared
    on a worker thread while round r trains. ``get`` waits for the worker
    only if it has not finished; a failed or mismatched prefetch is
    gathered again in the caller, where a real failure then raises."""

    def __init__(self, store: FederatedStore):
        self.store = store
        self._pending: Dict[int, threading.Thread] = {}
        self._ready: Dict[int, tuple] = {}  # round -> (indices, staged)
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(store.device) if store._cuda
                        else None)

    def prefetch(self, round_idx: int, indices) -> None:
        indices = np.asarray(indices)

        def work():
            try:
                staged = self.store._gather_cohort_staged(indices, None,
                                                          self._stream)
            except BaseException:  # get() gathers again, raising there
                staged = None
            with self._lock:
                if staged is not None:
                    self._ready[round_idx] = (indices, staged)
                self._pending.pop(round_idx, None)

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            if round_idx in self._pending or round_idx in self._ready:
                return
            self._pending[round_idx] = t
        t.start()

    def get(self, round_idx: int, indices) -> FederatedArrays:
        # Stale rounds' workers are waited out too, so that none of them
        # lands its cohort after the drop below.
        with self._lock:
            waits = [t for r, t in self._pending.items() if r <= round_idx]
        for t in waits:
            t.join()
        with self._lock:
            hit = self._ready.pop(round_idx, None)
            # Stale rounds (a caller skipping rounds) must not leak.
            for r in [r for r in self._ready if r < round_idx]:
                self._ready.pop(r)
        # Valid only for the exact index list the caller now wants.
        if hit is not None and np.array_equal(hit[0], np.asarray(indices)):
            return self.store._ready(hit[1])
        return self.store.gather_cohort(indices)


class WindowPrefetcher:
    """Double buffer for window superbatches: window w + 1's gather and
    copy on a worker thread while window w trains. A worker's exception
    is kept and raised in the caller's ``get`` — never a deadlock, never
    a silently dropped window — and the prefetcher stays usable (a later
    ``get`` gathers in the caller)."""

    def __init__(self, store: FederatedStore):
        self.store = store
        self._pending: Dict[int, threading.Thread] = {}
        # key -> ("ok", (indices, steps, staged)) | ("err", exception)
        self._done: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(store.device) if store._cuda
                        else None)

    def prefetch(self, key: int, window_indices, steps: int) -> None:
        indices = np.asarray(window_indices)

        def work():
            try:
                res = ("ok", (indices, steps, self.store._gather_window_staged(
                    indices, steps, self._stream)))
            except BaseException as e:  # raised in get(), not lost
                res = ("err", e)
            with self._lock:
                self._done[key] = res
                self._pending.pop(key, None)

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            if key in self._pending or key in self._done:
                return
            self._pending[key] = t
        t.start()

    def get(self, key: int, window_indices, steps: int) -> WindowBatch:
        with self._lock:  # stale windows' workers too, as CohortPrefetcher
            waits = [t for k, t in self._pending.items() if k <= key]
        for t in waits:
            t.join()
        with self._lock:
            hit = self._done.pop(key, None)
            for stale in [s for s in self._done if s < key]:
                self._done.pop(stale)  # skipped windows must not leak
        if hit is not None:
            tag, val = hit
            if tag == "err":
                raise val
            pidx, psteps, staged = val
            if psteps == steps and np.array_equal(
                    pidx, np.asarray(window_indices)):
                return self.store._ready(staged)
        return self.store.gather_window(window_indices, steps)
