"""Parallel server-ingest pool: decode workers + associative-exact folds
(port of ``fedml_tpu/comm/ingest.py``).

The wall this module breaks: every upload funnels through
ONE single-threaded dispatch loop doing codec decode + delta
reconstruction + accumulator fold, so the dispatch thread's occupancy
(``ingest_occupancy``) is the serving ceiling — the software analogue of the server-side ingest bottleneck PAPERS.md
"Performance Improvement of Federated Learning Server using Smart NIC"
(arXiv:2307.06561) names as *the* FL scaling limit. The decode and fold
are pure numpy over model-sized arrays — exactly the work CPython
releases the GIL for — so a bounded pool of threads pulls them off the
dispatch path while the control plane (dedupe, membership, heartbeats,
replies) stays single-threaded and unchanged.

**Why the fold can be parallel at all.** A floating-point running sum is
not associative: per-worker partial accumulators merged at flush would
regroup the additions and drift from the single-threaded fold by a few
ulps per upload — and WHICH worker folded WHICH upload depends on thread
scheduling, so the drift would be nondeterministic. The pool therefore
accumulates in **fixed-point int64** (:data:`SCALE_BITS` fraction bits):
each weighted contribution ``w * x`` is computed in float64 and rounded
ONCE onto the fixed-point grid — a per-upload operation with no order
dependence — and everything after that is integer addition, which IS
associative and commutative. Any partitioning of uploads across any
number of workers, folded in any interleaving, merges to the identical
bits; the permutation-matrix tests in tests/test_ingest_pool.py pin
pooled == serial across arrival orders × worker counts. The cost is a
one-time quantization of each contribution to ``2**-SCALE_BITS``
absolute resolution (~1e-9; far below fp32's own rounding at the
magnitudes model updates live at), paid identically by the 1-worker
"serial" pool — ``ingest_workers=1`` is the reference arm the bit-equal
pins compare against, and ``ingest_workers=0`` keeps the legacy inline
float path untouched.

Failure containment: a task that raises (a corrupt codec frame —
``CodecError``) is recorded with its metadata and surfaced to the
dispatch thread at the next :meth:`IngestPool.drain` barrier; the server
tiers apply their evict-and-release refusal policy there, so a poisoned
frame can never wedge the pool or silently zero into the mean.

Observability: each task runs under an ``ingest.pool`` span (worker id +
the upload's correlation key) in the installed tracer, task latency
lands in the owning server's ``pool_task_ms`` registry histogram, and
:meth:`IngestPool.profile` reports per-worker busy seconds / occupancy +
task counts for ``ingest_profile()`` (docs/OBSERVABILITY.md).

All of it is numpy on the host, as in the JAX package: for the same
decoded leaves the int64 totals are the JAX package's, bit for bit, for
any number of workers. The finalize boundary flattens the reference tree
in the JAX package's leaf order (``core/tree.sorted_flatten``); a
reference leaf that is a tensor gets its mean back as a tensor of its
dtype on its device (the server's net lives on the card).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.comm import pytree
from fedml_tpu_torch.core.tree import (sorted_flatten, sorted_leaves,
                                      sorted_unflatten)

log = logging.getLogger(__name__)

#: Fixed-point fraction bits of the exact accumulator grid. 2**-30 ≈
#: 9.3e-10 absolute resolution per contribution.
SCALE_BITS = 30
_SCALE = float(2 ** SCALE_BITS)
#: Per-contribution saturation bound: |w * x| caps at 2**(50-30) ≈ 1e6,
#: leaving 2**13 uploads of headroom before an int64 partial could
#: overflow (the serving tiers flush every round / every buffer_k — far
#: below that).
_CLIP = float(2 ** 50)


def quantize_contribution(x: np.ndarray, weight: float = 1.0) -> np.ndarray:
    """One contribution → the int64 fixed-point grid: compute
    ``float32(x) * float32(weight * 2^SCALE_BITS)`` (single-precision —
    the inputs are fp32 model updates, so the product carries their own
    precision at half the memory traffic of an f64 pipeline), clamp,
    then TRUNCATE toward zero (the C cast). Truncation instead of
    round-to-nearest keeps the hot fold free of ``np.rint`` at the cost
    of ≤1 grid step of bias per contribution. Non-finite entries map to
    0 deterministically (the buffered tier's nan_guard already
    weight-zeroes non-finite deltas; this keeps an unguarded NaN from
    turning the exact integer sum into platform-defined garbage) and the
    magnitude saturates at ``_CLIP``. The reference semantics of
    :meth:`PartialAccumulator.add` — every step is a deterministic
    elementwise function of ONE contribution, which is what makes the
    integer accumulation order-invariant."""
    q = np.asarray(x, np.float32) * np.float32(weight * _SCALE)
    q = np.nan_to_num(q, nan=0.0, posinf=_CLIP, neginf=-_CLIP)
    return np.clip(q, -_CLIP, _CLIP).astype(np.int64)


def quantize_weight(w: float) -> int:
    w = float(w)
    if not np.isfinite(w):
        return 0
    return int(np.clip(np.rint(w * _SCALE), 0.0, _CLIP))


def finalize_partial_mean(total: "PartialAccumulator", ref_tree, dtype=None):
    """The ONE place a fixed-point partial becomes a float mean: return
    ``(mean_tree, count)`` — the weighted mean ``Σ w·x / Σ w`` as numpy
    leaves shaped/ordered by ``ref_tree``, cast to each reference leaf's
    dtype (or ``dtype`` for every leaf). ``mean_tree`` is ``None`` when
    nothing (or only weight-zero contributions) accumulated.

    Module-level because TWO finalize sites must agree to the bit:
    :meth:`IngestPool.finalize_mean` (the in-process pool) and the shard
    coordinator's wire merge (``comm/shardplane.py``), whose bit-equality
    contract is "same int64 totals → same mean" BY CONSTRUCTION — both
    call here, so there is no second copy of the division to drift.
    A tensor reference leaf gets a tensor of its dtype on its device."""
    count = total.count
    if total.leaves is None or total.wsum <= 0:
        return None, count
    ref_leaves, treedef = sorted_flatten(ref_tree)
    if len(ref_leaves) != len(total.leaves):
        raise ValueError(
            f"pooled accumulator holds {len(total.leaves)} leaves but "
            f"the reference model has {len(ref_leaves)}")
    inv = 1.0 / (total.wsum / _SCALE)
    out = []
    for r, acc in zip(ref_leaves, total.leaves):
        mean = ((acc / _SCALE) * inv).reshape(tuple(np.shape(r)))
        if isinstance(r, torch.Tensor):
            if dtype is not None:
                t = torch.from_numpy(np.ascontiguousarray(mean.astype(dtype)))
            elif r.dtype == torch.bfloat16:
                t = torch.from_numpy(mean).to(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(mean.astype(
                    torch.empty(0, dtype=r.dtype).numpy().dtype)))
            out.append(t.to(r.device))
            continue
        d = dtype if dtype is not None else np.asarray(r).dtype
        out.append(mean.astype(d))
    return sorted_unflatten(treedef, out), count


class FixedContribution:
    """A contribution ALREADY on the int64 fixed-point grid — the masked
    secure-aggregation frames (``comm/secagg.py``): the client quantized
    ``w·x`` with :func:`quantize_contribution` semantics itself, then
    added pairwise masks that span the FULL int64 range, so the server
    fold must be a raw modular int64 add — re-quantizing, clipping, or
    range-checking a pre-cancellation masked frame would break the exact
    mask cancellation (and leak that a value was large). ``qweight`` is
    the already-quantized weight (:func:`quantize_weight`), ``count``
    the membership delta (0 for a server-side mask correction, which
    adds leaves without representing an upload), ``clipped`` the
    client-counted envelope saturations to roll into ``saturated`` (the
    client runs the same quantization clip the server pool would, and
    ships the count in the clear — it is weight metadata, not update
    content)."""

    __slots__ = ("leaves", "qweight", "count", "clipped")

    def __init__(self, leaves: List[np.ndarray], qweight: int,
                 count: int = 1, clipped: int = 0):
        self.leaves = leaves
        self.qweight = int(qweight)
        self.count = int(count)
        self.clipped = int(clipped)


def upload_fold_task(payload, weight: float, anchor, *,
                     codec=None, legacy_decode=None, wcodec=None,
                     wire_decode=None, is_delta: bool = False,
                     masked: bool = False, secagg_on: bool = False,
                     clipped: int = 0,
                     refusal: str = "masked upload without --secagg"
                     ) -> Callable[[], object]:
    """One upload's decode+fold task for an :class:`IngestPool`: what
    the single server's and each aggregator shard's pool fold.

    A masked (secagg) frame is ALREADY exact int64 fixed point (the
    client ran the identical quantize path before masking): it folds
    modularly as a :class:`FixedContribution`, no decode, no re-clip; on
    a manager without secagg it is refused with ``refusal``. Otherwise
    ``legacy_decode(codec, payload)`` (the legacy ``compress`` codecs),
    ``wire_decode(wcodec, payload)`` (the negotiated wire codec) or a
    raw frame stamped ``is_delta`` gives a delta, which the fold adds
    to ``anchor`` (``w*(anchor + delta)`` in the accumulator's
    preallocated scratch, no model-sized temporary on the task path); a
    plain frame folds as it is. The caller passes the round's anchor
    at submit time, so a late task cannot reconstruct against the next
    round's net."""

    def task():
        if masked:
            if not secagg_on:
                raise ValueError(refusal)
            return FixedContribution(
                [np.ascontiguousarray(l, np.int64) for l in payload],
                quantize_weight(weight), 1, int(clipped))
        if codec:
            delta = legacy_decode(codec, payload)
        elif wcodec:
            delta = wire_decode(wcodec, payload)
        elif is_delta:
            delta = payload  # raw tensor-framed delta
        else:
            delta = None
        if delta is None:
            return ([pytree.np_leaf(l) for l in sorted_leaves(payload)],
                    weight)
        return ([pytree.np_leaf(d) for d in sorted_leaves(delta)], weight,
                [pytree.np_leaf(a) for a in sorted_leaves(anchor)])

    return task


class PartialAccumulator:
    """One worker's running Σ w_i·x_i (int64 leaves) + Σ w_i (int).
    Single-writer (its owning pool worker); merged under the pool lock at
    the drain barrier.

    Allocation-free on the hot path: per-leaf float64 scratch buffers are
    allocated once (first contribution) and every later fold runs
    in-place (``out=`` / ``copyto``). This is a throughput requirement,
    not a nicety — a model-sized temporary per numpy op crosses glibc's
    mmap threshold, and the resulting page-fault + allocator churn both
    dominates the fold cost and serializes the pool on the allocator's
    GIL-held sections.

    The computed contribution is ``trunc((x [+ base]) * w * 2^SCALE_BITS)``
    evaluated in float32 (:func:`quantize_contribution`) — a per-upload
    value with NO dependence on fold order — then clamped (non-finite →
    0, magnitude → ±2^50) and added in int64, where addition is exact
    and associative. ``base`` lets the sync tier fold
    ``w * (broadcast_anchor + delta)`` without materializing the
    reconstruction."""

    __slots__ = ("leaves", "wsum", "count", "saturated", "_buf", "_ibuf",
                 "_bool")

    def __init__(self):
        self.leaves: Optional[List[np.ndarray]] = None
        self.wsum = 0
        self.count = 0
        #: Contributions whose FINITE values (or weight) exceeded the
        #: ±2^50 grid envelope and were clamped — silent clipping would
        #: mis-weight large-sample silos relative to the inline fold,
        #: so saturation is counted (surfaced via IngestPool.profile()
        #: + a once-per-pool warning) instead of swallowed.
        self.saturated = 0
        self._buf: Optional[List[np.ndarray]] = None
        self._ibuf: Optional[List[np.ndarray]] = None
        self._bool: Optional[List[np.ndarray]] = None

    def _ensure(self, leaves) -> None:
        if self.leaves is None:
            self.leaves = [np.zeros(np.shape(l), np.int64) for l in leaves]
            self._buf = [np.empty(np.shape(l), np.float32) for l in leaves]
            self._ibuf = [np.empty(np.shape(l), np.int64) for l in leaves]
            self._bool = [np.empty(np.shape(l), bool) for l in leaves]
        elif len(leaves) != len(self.leaves):
            raise ValueError(
                f"contribution has {len(leaves)} leaves, accumulator holds "
                f"{len(self.leaves)} — uploads must share one model")

    def add(self, leaves: List[np.ndarray], weight: float,
            base: Optional[List[np.ndarray]] = None) -> None:
        # quantize_contribution(leaf [+ base], w) per element, on
        # preallocated float32 scratch. The truncation to the grid
        # happens PER CONTRIBUTION (the int64 scratch cast) before the
        # exact int64 accumulate — truncating a running float sum
        # instead would make the result depend on fold order.
        w = float(weight)
        ws = np.float32(w * _SCALE)
        # At most ONE saturation count per contribution, whether the
        # weight or any value tripped the envelope.
        clipped = bool(np.isfinite(w) and abs(w) * _SCALE > _CLIP)
        self._ensure(leaves)
        for i, leaf in enumerate(leaves):
            buf, acc = self._buf[i], self.leaves[i]
            if base is not None:
                # The sync tier's w*(anchor + delta), summed at value
                # scale before scaling (best f32 conditioning).
                np.add(np.asarray(leaf), np.asarray(base[i]), out=buf,
                       casting="unsafe")
            else:
                np.copyto(buf, np.asarray(leaf), casting="unsafe")
            np.multiply(buf, ws, out=buf)
            # Deterministic containment: NaN → 0 (rare path — one bool
            # reduction gates it), ±inf/huge → saturate at the clip.
            fin = self._bool[i]
            np.isfinite(buf, out=fin)
            if not fin.all():
                np.nan_to_num(buf, copy=False, nan=0.0, posinf=_CLIP,
                              neginf=-_CLIP)
            elif not clipped and buf.size and \
                    float(np.max(np.abs(buf))) > _CLIP:
                # FINITE values beyond the grid envelope: the clip below
                # distorts this contribution's weight in the mean —
                # count it so the envelope is observable (non-finite
                # containment above is by design and not counted).
                clipped = True
            np.clip(buf, -_CLIP, _CLIP, out=buf)
            # Exact truncation onto the int grid, then exact int64 sum.
            ib = self._ibuf[i]
            np.copyto(ib, buf, casting="unsafe")
            np.add(acc, ib, out=acc)
        if clipped:
            self.saturated += 1
        self.wsum += quantize_weight(w)
        self.count += 1

    def add_fixed(self, fixed: FixedContribution) -> None:
        """Fold a :class:`FixedContribution`: raw MODULAR int64 leaf adds
        (the uint64 bit view — two's-complement wraparound with no numpy
        warning machinery in the loop), no float path, no clip, no
        envelope count. Masked secagg frames sit anywhere in the int64
        range by construction; clamping one would destroy the exact
        pairwise-mask cancellation the whole protocol rests on. The
        envelope becomes checkable only AFTER cancellation — see
        :meth:`envelope_overflow`, run by the finalize sites on the
        merged total."""
        leaves = fixed.leaves
        if leaves is not None:
            self._ensure(leaves)
            for i, leaf in enumerate(leaves):
                acc = self.leaves[i]
                lf = np.asarray(leaf)
                if lf.dtype != np.int64:
                    raise ValueError(
                        f"fixed contribution leaf {i} has dtype {lf.dtype}, "
                        "expected int64 — a masked frame that lost its grid "
                        "dtype on the wire cannot be folded")
                if lf.shape != acc.shape:
                    raise ValueError(
                        f"fixed contribution leaf {i} has shape {lf.shape}, "
                        f"accumulator holds {acc.shape}")
                np.add(acc.view(np.uint64),
                       np.ascontiguousarray(lf).view(np.uint64),
                       out=acc.view(np.uint64))
        self.wsum += fixed.qweight
        self.count += fixed.count
        self.saturated += fixed.clipped

    def envelope_overflow(self) -> int:
        """Post-cancellation envelope headroom check for the masked
        fold: once every pairwise mask has cancelled (or been corrected
        away), the merged total must satisfy ``|leaf| <= count * 2^50``
        — each of ``count`` contributions was clamped to ±2^50 at
        quantization, so a residual beyond that bound means uncancelled
        mask mass (a protocol bug, a forged frame) or genuine int64
        wraparound of the sum. COUNTED into ``saturated`` (one bump per
        check that found any overflow, mirroring the per-contribution
        convention of :meth:`add`), never clamped: the finalize sites
        report it through the same ``saturated`` rollup the shardplane
        wire frame already carries. Returns the number of offending
        elements."""
        if self.leaves is None or self.count <= 0:
            return 0
        bound = int(self.count) * int(_CLIP)
        over = 0
        for acc in self.leaves:
            over += int(np.count_nonzero(acc > bound)
                        + np.count_nonzero(acc < -bound))
        if over:
            self.saturated += 1
        return over

    def merge_into(self, other: "PartialAccumulator") -> None:
        """Exact merge: int64 leaf adds + scalar sums. The scalar tallies
        — ``wsum``, ``count`` AND ``saturated`` — propagate even when
        this partial never folded a leaf (an accumulator fresh off
        ``reset()`` still carries its monotone saturation count; dropping
        it at merge boundaries is how fleet-wide saturation used to
        vanish from pooled health reports)."""
        other.wsum += self.wsum
        other.count += self.count
        other.saturated += self.saturated
        if self.leaves is None:
            return
        if other.leaves is None:
            other.leaves = [l.copy() for l in self.leaves]
        else:
            for a, b in zip(other.leaves, self.leaves):
                a += b

    def reset(self) -> None:
        # Keep the allocated leaves/scratch (zeroed in place) — reset
        # runs at every flush, and reallocating model-sized buffers per
        # round would reintroduce the allocator churn documented above.
        # ``saturated`` survives resets: it is monotone telemetry, not
        # window state.
        if self.leaves is not None:
            for a in self.leaves:
                a.fill(0)
        self.wsum = 0
        self.count = 0


class IngestPool:
    """Bounded pool of decode+fold workers for the message-passing
    servers (``cfg.ingest_workers``).

    The dispatch thread stays the only control-plane writer: it
    ``submit``\\ s one task per accepted upload (the task closure does
    the codec decode / delta reconstruction and returns ``(leaves,
    weight)``), and at every round/buffer flush it calls :meth:`drain`
    (barrier) then :meth:`finalize_mean` (exact merge of the per-worker
    partials, the ONE division, cast back to the reference dtypes).
    Worker→upload assignment is whichever thread pops the queue first —
    irrelevant to the result, because the partial folds are
    associative-exact (module docstring).

    ``run`` is the synchronous escape hatch for tiers whose fold cannot
    be deferred (pure async mixes every arrival into the global
    immediately): the callable executes on a pool worker, the caller
    blocks for its result, and exceptions re-raise in the caller — the
    tier's existing inline refusal policy applies unchanged.
    """

    _STOP = object()

    def __init__(self, workers: int, registry=None, queue_cap: int = 0):
        workers = int(workers)
        if workers < 1:
            raise ValueError(f"ingest pool needs >= 1 worker, got {workers}")
        self.workers = workers
        self._q: "queue.Queue" = queue.Queue(
            maxsize=(queue_cap or workers * 8))
        self.partials = [PartialAccumulator() for _ in range(workers)]
        self._busy_s = [0.0] * workers
        self._tasks = [0] * workers
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None
        self._failures: List[Tuple[Dict, BaseException]] = []
        self._pending = 0
        self._cv = threading.Condition()
        self._lock = threading.Lock()  # stats + failures + merge
        self._h_task = (registry.histogram("pool_task_ms")
                        if registry is not None else None)
        self._warned_saturation = False
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True,
                             name=f"ingest-pool-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -- worker side ---------------------------------------------------------
    def _worker(self, i: int) -> None:
        from fedml_tpu_torch.obs import trace as obs_trace

        # Under the lock: resize() appends to self.partials concurrently
        # (worker i's own slot always exists before its thread starts).
        with self._lock:
            partial = self.partials[i]
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            fn, meta, sink = item
            t0 = time.perf_counter()
            with self._lock:
                if self._t0 is None:
                    self._t0 = t0
            try:
                with obs_trace.active().span("ingest.pool", cat="ingest",
                                             worker=i, **meta):
                    out = fn()
                    if sink is None:
                        if isinstance(out, FixedContribution):
                            # Already on the int64 grid (masked secagg
                            # frames / mask corrections): modular add,
                            # no float path, no clip.
                            partial.add_fixed(out)
                        else:
                            # (leaves, weight) or (leaves, weight, base)
                            # — base folds w*(base+leaf) without
                            # materializing the reconstruction (the sync
                            # tier's deltas).
                            if len(out) == 3:
                                leaves, w, base = out
                            else:
                                (leaves, w), base = out, None
                            partial.add(leaves, w, base=base)
            except BaseException as e:  # noqa: BLE001 — surfaced at drain
                if sink is not None:
                    sink["err"] = e
                else:
                    with self._lock:
                        self._failures.append((meta, e))
            else:
                if sink is not None:
                    sink["out"] = out
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self._busy_s[i] += t1 - t0
                    self._tasks[i] += 1
                    self._t1 = t1
                    if self._h_task is not None:
                        self._h_task.record((t1 - t0) * 1e3)
                if sink is not None:
                    sink["done"].set()
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    # -- dispatch side -------------------------------------------------------
    def submit(self, fn: Callable[[], Tuple[List[np.ndarray], float]],
               **meta) -> None:
        """Enqueue one upload's decode+fold. ``fn`` runs on a pool worker
        and returns ``(numpy leaves, weight)``; a raise is recorded with
        ``meta`` and surfaced at the next :meth:`drain`. Blocks when the
        bounded queue is full — natural backpressure on the dispatch
        thread."""
        if self._closed:
            raise RuntimeError("ingest pool is closed")
        with self._cv:
            self._pending += 1
        self._q.put((fn, meta, None))

    def run(self, fn: Callable, **meta):
        """Execute ``fn`` on a pool worker and block for its result
        (exceptions re-raise here). No fold — the synchronous decode
        path for the pure-async tier."""
        if self._closed:
            return fn()
        sink = {"done": threading.Event()}
        with self._cv:
            self._pending += 1
        self._q.put((fn, meta, sink))
        sink["done"].wait()
        if "err" in sink:
            raise sink["err"]
        return sink["out"]

    def drain(self) -> List[Tuple[Dict, BaseException]]:
        """Barrier: wait until every submitted task has completed, then
        return (and clear) the failure list — the flush-time hook where
        the server tiers apply their refusal policy."""
        with self._cv:
            while self._pending > 0:
                self._cv.wait()
        with self._lock:
            failures, self._failures = self._failures, []
        if not self._warned_saturation and any(
                p.saturated for p in self.partials):
            self.profile()  # emits the once-per-pool saturation warning
        return failures

    def queue_depth(self) -> int:
        return self._q.qsize()

    def resize(self, workers: int) -> None:
        """Grow the pool to ``workers`` (the autoscaling actuation).

        Growing is exact and safe mid-stream: a new worker gets its own
        ``PartialAccumulator`` + stats slots and starts pulling from the
        shared queue, and since the partial folds are associative-exact
        the merged mean is bit-identical for any worker count. SHRINK is
        refused — retiring a worker would strand its accumulated partial
        (or force a mid-round merge off the dispatch thread), so the
        actuation seam surfaces it as a named refusal instead."""
        workers = int(workers)
        if self._closed:
            raise RuntimeError("ingest pool is closed")
        if workers < self.workers:
            raise ValueError(
                f"ingest pool shrink unsupported ({self.workers} -> {workers}): "
                "a retiring worker would strand its partial accumulator")
        with self._lock:
            start = self.workers
            for i in range(start, workers):
                self.partials.append(PartialAccumulator())
                self._busy_s.append(0.0)
                self._tasks.append(0)
            self.workers = workers
        for i in range(start, workers):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True,
                                 name=f"ingest-pool-{i}")
            self._threads.append(t)
            t.start()

    def reset(self) -> None:
        """Drop all accumulated partials (callers drain first)."""
        for p in self.partials:
            p.reset()

    def merge_partials(self) -> PartialAccumulator:
        """Exact merge of the per-worker partials into ONE fresh
        accumulator, resetting the workers — the flush-time export for
        the sharded aggregation plane (``comm/shardplane.py``): the
        shard ships the merged int64 partial over the wire and the
        COORDINATOR finalizes, so the division happens exactly once per
        round no matter how many processes folded. Because the
        per-worker ``saturated`` tallies are monotone across resets, the
        returned total's ``saturated`` is the pool's LIFETIME saturation
        count at this flush (a gauge, not a delta). Callers must
        :meth:`drain` first."""
        total = PartialAccumulator()
        with self._lock:
            for p in self.partials:
                p.merge_into(total)
            self.reset()
        return total

    def finalize_mean(self, ref_tree, dtype=None):
        """Merge the per-worker partials exactly and return
        ``(mean_tree, count)``: the weighted mean ``Σ w·x / Σ w`` as
        numpy leaves shaped/ordered by ``ref_tree``, cast to each
        reference leaf's dtype (or ``dtype`` for every leaf — the
        buffered tier keeps its delta in float32). ``mean_tree`` is
        ``None`` when nothing (or only weight-zero contributions)
        accumulated — the caller keeps its previous net, the
        all-excluded contract. Resets the partials either way. Callers
        must :meth:`drain` first."""
        return finalize_partial_mean(self.merge_partials(), ref_tree,
                                     dtype=dtype)

    # -- observability -------------------------------------------------------
    def profile(self) -> Dict[str, object]:
        """Per-worker occupancy for ``ingest_profile()``: busy seconds ÷
        (first-task-start → last-task-end span), plus task counts."""
        with self._lock:
            span = ((self._t1 - self._t0)
                    if self._t0 is not None and self._t1 is not None
                    else 0.0)
            busy = list(self._busy_s)
            tasks = list(self._tasks)
        saturated = int(sum(p.saturated for p in self.partials))
        if saturated and not self._warned_saturation:
            self._warned_saturation = True
            log.warning(
                "ingest pool: %d contribution(s) had finite values or "
                "weights beyond the ±2^%d fixed-point envelope and were "
                "CLAMPED — their weight in the mean is distorted relative "
                "to the inline fold (huge sample counts or diverged "
                "updates; consider ingest_workers=0 or rescaling weights)",
                saturated, 50)
        return {
            "workers": self.workers,
            "tasks": int(sum(tasks)),
            "tasks_per_worker": tasks,
            "busy_s_per_worker": [round(b, 4) for b in busy],
            "occupancy_per_worker": ([round(b / span, 4) for b in busy]
                                     if span > 0 else None),
            "span_s": round(span, 4),
            "saturated_contributions": saturated,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._q.put(self._STOP)
        for t in self._threads:
            t.join(timeout=5.0)
