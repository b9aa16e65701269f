"""Buffered semi-synchronous aggregation (FedBuff-style) — the tier
between sync first-k and pure async (port of ``fedml_tpu/algos/fedbuff.py``).

Sync first-k (``algos/fedavg_distributed.py``) pays a round barrier; pure
async (``algos/fedasync.py``) pays maximal staleness. FedBuff (Nguyen et
al. 2022, "Federated Learning with Buffered Asynchronous Aggregation")
sits between: clients train continuously with no barrier, but the server
folds uploads into the global model only every ``buffer_k``-th arrival,
each update discounted polynomially in its staleness:

    disc_i = 1 / (1 + s_i)^a                 (s_i = versions since pull)
    delta  = Agg(stack(d_1..d_k), disc)       (cfg-pluggable aggregator)
    global <- global + alpha * delta          (alpha = server step size)

**Accumulate on arrival.** For the mean aggregator (the default) the
server never stores the buffered updates: it keeps one running
``acc += disc_i * d_i`` and ``wsum += disc_i`` on the card — O(model)
server memory whatever ``buffer_k`` or the fleet size. A non-mean
aggregator from :mod:`fedml_tpu_torch.core.robust_agg` needs the k updates
side by side, so that path keeps the k-deep buffer. A non-finite delta is
weight-zeroed (``guard_drops``), so robust-vs-Byzantine and
buffered-vs-stale compose.

Everything else — dedupe, recovery, the bounded terminal handshake, chaos
drills — is INHERITED from the async control plane:
:class:`FedBuffServerManager` overrides only the ``_ingest`` hook, and
:class:`FedBuffClientManager` only the wire payload (``net −
global_received``, formed on the worker's card). ``cfg.comm_round`` counts
server AGGREGATIONS (model versions).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.fedasync import (
    MSG_ARG_KEY_TASK_SEQ,
    FedAsyncClientManager,
    FedAsyncServerManager,
    staleness_weight,
)
from fedml_tpu_torch.algos import fedavg_distributed
from fedml_tpu_torch.algos.fedavg_distributed import (
    MSG_ARG_KEY_MODEL_PARAMS,
    _as_dict,
    _like,
    _tree_sub,
    check_device,
)
from fedml_tpu_torch.comm import codec as wire_codec
from fedml_tpu_torch.comm import pytree
from fedml_tpu_torch.comm.loopback import run_workers
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.resilience import ChaosSpec
from fedml_tpu_torch.core.graph import capture_lock
from fedml_tpu_torch.core.robust_agg import make_aggregator
from fedml_tpu_torch.core.tree import sorted_leaves, sorted_tree_map
from fedml_tpu_torch.ctrl.actuator import Knob
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.trainer.local import softmax_ce

log = logging.getLogger(__name__)


def _tree_finite(tree) -> bool:
    """Host-side finiteness gate for one arriving delta — the buffered
    tier's ``nan_guard``."""
    return all(bool(np.isfinite(pytree.np_leaf(l)).all())
               for l in sorted_leaves(tree))


class FedBuffServerManager(FedAsyncServerManager):
    """Aggregate every ``buffer_k`` accepted arrivals with polynomial
    staleness discounting; the model version counts AGGREGATIONS.

    ``alpha`` is the server step size on the aggregated delta (1.0 =
    apply the discounted-mean update as-is), NOT the async mixing rate;
    ``staleness_exp`` is the discount exponent shared with fedasync.
    ``aggregator`` is any :func:`core.robust_agg.make_aggregator` spec —
    ``mean`` keeps the O(model) accumulate-on-arrival fast path.
    ``cfg.agg_shards`` is refused (inherited)."""

    #: The buffered tier folds DELTAS; a full-model-stamped upload is
    #: refused instead of buffered as a delta.
    _accepts_delta_frames = True

    def __init__(self, args, net, cfg: FedConfig, size: int,
                 backend: str = "LOOPBACK", alpha: float = 1.0,
                 staleness_exp: float = 0.5, buffer_k: int = 2,
                 aggregator="mean", eval_fn=None, test_data=None, *,
                 nan_guard: bool = True,
                 done_timeout_s: Optional[float] = None,
                 metrics=None, flight_dir=None,
                 clock=time.monotonic, directory=None, device=None):
        super().__init__(args, net, cfg, size, backend=backend, alpha=alpha,
                         staleness_exp=staleness_exp, eval_fn=eval_fn,
                         test_data=test_data, done_timeout_s=done_timeout_s,
                         metrics=metrics, flight_dir=flight_dir,
                         clock=clock, directory=directory, device=device)
        if buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {buffer_k}")
        self.buffer_k = buffer_k
        self.aggregator = make_aggregator(aggregator)
        if self._pool is not None and not self.aggregator.is_mean:
            # The pool's worker threads are already running: close them
            # before refusing.
            self._pool.close()
            raise ValueError(
                f"ingest_workers={cfg.ingest_workers} needs the mean "
                f"aggregator: {self.aggregator.name!r} reduces the k-deep "
                "buffer side by side (stack-then-reduce), which is "
                "inherently serialized — run it with ingest_workers=0 "
                "(comm/ingest.py)")
        self.nan_guard = nan_guard
        self.guard_drops = 0  # non-finite deltas weight-zeroed out
        # Actuation discipline: buffer_k is read once per arrival, so
        # mutating it BETWEEN flushes only moves the next flush point; the
        # seam's busy probe refuses any actuation mid-flush.
        self._in_flush = False
        self.ctrl.add_knob(Knob(
            "buffer_k", lambda: self.buffer_k,
            lambda v: setattr(self, "buffer_k", v),
            1, max(1, size - 1), cast=int))
        # Mean fast path: running discounted sum + weight, O(model).
        self._acc = None
        self._wsum = 0.0
        # Robust path: the k-deep buffer of (delta, discount) pairs.
        self._pending: List[Tuple[object, float]] = []
        self._count = 0

    @property
    def aggregations(self) -> int:
        return self.version

    def health(self):
        """The async tier's health row plus the buffered tier's own
        observables: current buffer fill and nan-guard drops."""
        h = super().health()
        h["buffer_depth"] = self._count
        h["guard_drops"] = self.guard_drops
        return h

    def _ctrl_busy(self) -> Optional[str]:
        return "mid_flush" if self._in_flush else None

    def _defer_decode(self) -> bool:
        # With a pool, decode AND the discounted fold move into its task:
        # the net only changes at the flush, so deferral changes no reply.
        return self._pool is not None

    def _submit_buffered(self, msg: Message, disc: float) -> None:
        payload = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        wcodec = msg.get(wire_codec.CODEC_KEY)
        spec = self._spec
        guard = self.nan_guard
        sender = msg.get_sender_id()
        task_seq = msg.get(MSG_ARG_KEY_TASK_SEQ)

        def task():
            delta = (self._wire_decoders.decode(wcodec, payload, spec)
                     if wcodec else payload)
            leaves = [pytree.np_leaf(l) for l in sorted_leaves(delta)]
            w = disc
            if guard and not all(np.isfinite(l).all() for l in leaves):
                # Weight-zeroed; the exact accumulator maps non-finite
                # entries to 0, so a poisoned delta contributes nothing.
                with self._lock:
                    self.guard_drops += 1
                w = 0.0
            return leaves, w

        self._pool.submit(task, sender=sender,
                          **({"task_seq": int(task_seq)}
                             if task_seq is not None else {}))

    def _ingest(self, msg: Message, staleness: int) -> None:
        disc = staleness_weight(1.0, staleness, self.staleness_exp)
        if self._pool is not None:
            # Pooled path: the slot is consumed NOW (a frame that later
            # refuses weighs 0 in this window and its sender is
            # evict-and-released at the flush barrier).
            self._submit_buffered(msg, disc)
            self._count += 1
            if self._count >= self.buffer_k:
                self._flush()
            return
        delta = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        if self.nan_guard and not _tree_finite(delta):
            # The slot still fills its buffer position but is EXCLUDED
            # from the statistics: disc=0 is the participation gate.
            self.guard_drops += 1
            disc = 0.0
        w = float(np.float32(disc))
        with capture_lock:
            if self.aggregator.is_mean:
                if disc > 0.0:
                    d = pytree.to_device(delta, self.device)
                    self._acc = (
                        sorted_tree_map(lambda d_: w * d_.float(), d)
                        if self._acc is None
                        else sorted_tree_map(lambda a_, d_: a_ + w * d_.float(),
                                             self._acc, d))
                    self._wsum += disc
            else:
                if disc <= 0.0:
                    # 0 x NaN = NaN would still poison the weighted
                    # recombination: the dropped delta enters as zeros.
                    d = sorted_tree_map(
                        lambda r: torch.zeros(r.shape, dtype=torch.float32,
                                              device=self.device), self.net)
                else:
                    d = sorted_tree_map(lambda d_: d_.float(),
                                        pytree.to_device(delta, self.device))
                self._pending.append((d, disc))
        self._count += 1
        if self._count >= self.buffer_k:
            self._flush()

    def _flush(self) -> None:
        """Apply the buffered aggregate and bump the model version. An
        all-excluded buffer keeps the previous net; the version still
        advances (the k arrivals were consumed)."""
        flushed = self._count
        self._in_flush = True
        try:
            with obs_trace.active().span(
                    "round.commit", cat="round",
                    corr=obs_trace.corr(round=self.version),
                    buffered=flushed):
                self._flush_buffer()
        finally:
            self._in_flush = False
        # The depth the flush CONSUMED (normally buffer_k), the
        # meaningful per-version observable; health()'s buffer_depth is
        # the live fill.
        self.registry.gauge("buffer_depth").set(flushed)

    def _apply(self, delta) -> None:
        """``net += alpha · delta`` in f32 on the card, each leaf back in
        its own dtype (JAX's jitted ``_apply``); under ``capture_lock``."""
        s = float(np.float32(self.alpha))
        self.net = sorted_tree_map(
            lambda g, d: (g.float() + s * d.float()).to(g.dtype),
            self.net, delta)

    def _flush_buffer(self) -> None:
        if self._pool is not None:
            # Barrier on the window's decode+fold tasks, the shared
            # refusal policy on failures, then the exact partials merged:
            # mean delta = Σ disc·d / Σ disc, identical bits for any worker
            # count or interleaving.
            for meta, err in self._pool.drain():
                self._refuse_upload(int(meta.get("sender", -1)), err,
                                    task_seq=meta.get("task_seq"))
            with capture_lock:
                mean_delta, _ = self._pool.finalize_mean(self.net,
                                                         dtype=np.float32)
                if mean_delta is not None:
                    self._apply(mean_delta)
            self._count = 0
            with self._lock:
                self.version += 1
            return
        with capture_lock:
            if self.aggregator.is_mean:
                if self._wsum > 0.0:
                    inv = float(np.float32(1.0 / self._wsum))
                    self._apply(sorted_tree_map(lambda a_: inv * a_,
                                                self._acc))
                self._acc = None
                self._wsum = 0.0
            else:
                weights = torch.tensor([w for _, w in self._pending],
                                       dtype=torch.float32,
                                       device=self.device)
                if bool((weights > 0).any()):
                    stacked = sorted_tree_map(
                        lambda *ls: torch.stack(ls),
                        *[d for d, _ in self._pending])
                    self._apply(_like(stacked, self.aggregator(
                        _as_dict(stacked), weights)))
                self._pending = []
        self._count = 0
        with self._lock:
            self.version += 1


class FedBuffClientManager(FedAsyncClientManager):
    """The async client with a delta wire format: uploads ``net −
    global_received``. Because the payload IS a delta, the full wire-codec
    menu applies — top-k/randmask with per-worker error feedback included.
    ``corruptor`` (a :class:`core.faults.UpdateCorruptor`) marks this rank
    Byzantine: the trained model is corrupted BEFORE the delta is
    formed."""

    _payload_is_delta = True

    def __init__(self, *args_, corruptor=None, **kw):
        super().__init__(*args_, **kw)
        self.corruptor = corruptor

    def _upload_payload(self, net, global_net):
        if self.corruptor is not None:
            net = self.corruptor.corrupt(net, global_net)
        return pytree.host_tree(_tree_sub(net, global_net))


def FedML_FedBuff_distributed(
    model,
    train_fed: FederatedArrays,
    test_global,
    cfg: FedConfig,
    backend: str = "LOOPBACK",
    loss_fn=softmax_ce,
    alpha: float = 1.0,
    staleness_exp: float = 0.5,
    buffer_k: int = 2,
    aggregator="mean",
    *,
    wire_codec: str = "none",
    loopback_wire: str = "none",
    chaos: Optional[ChaosSpec] = None,
    done_timeout_s: Optional[float] = None,
    idle_timeout_s: float = 0.0,
    corrupt_ranks=(),
    corruptor=None,
    metrics=None,
    trace_dir=None,
    pretrained_params=None,
    controller=None,
    device=None,
):
    """Run the buffered federation: ``cfg.comm_round`` server
    AGGREGATIONS (each consuming ``buffer_k`` arrivals) across
    ``cfg.client_num_per_round`` workers, on ``device`` (``None`` → cuda).
    Returns the server manager (net, staleness/arrival history, test
    history, ``final_health``, ``adapter_holder``). ``corrupt_ranks`` +
    ``corruptor`` flag Byzantine workers for drills; ``aggregator`` is the
    server-side defense (core/robust_agg spec). ``metrics`` gets one ctrl/
    health row (buffer depth and staleness included) per aggregation;
    ``trace_dir`` arms the flight recorder + span tracer. ``controller``
    (a ``ctrl.FederationController``) steps after each buffer commit."""
    device = check_device(train_fed, device)
    size, net0, local_train, eval_fn, args = (
        fedavg_distributed.build_federation_setup(
            model, train_fed, test_global, cfg, backend, loss_fn, chaos=chaos,
            loopback_wire=loopback_wire, pretrained_params=pretrained_params))
    server = FedBuffServerManager(
        args, net0, cfg, size, backend=backend, alpha=alpha,
        staleness_exp=staleness_exp, buffer_k=buffer_k,
        aggregator=aggregator, eval_fn=eval_fn, test_data=test_global,
        done_timeout_s=done_timeout_s, metrics=metrics,
        flight_dir=trace_dir, device=device)
    if controller is not None:
        # Same-object portability: the controller that tuned its policies
        # in the fleet simulator drives this live run unchanged.
        server.attach_controller(controller)
    clients = [
        FedBuffClientManager(args, rank, size, train_fed, local_train, cfg,
                             backend=backend, wire_codec_spec=wire_codec,
                             idle_timeout_s=idle_timeout_s,
                             corruptor=(corruptor if rank in set(corrupt_ranks)
                                        else None))
        for rank in range(1, size)
    ]
    with obs_trace.tracing_to(trace_dir):
        run_workers([server.run] + [c.run for c in clients])
    server.final_health = server.health()
    server.adapter_holder = args.adapter_holder
    server.local_train = local_train
    return server
