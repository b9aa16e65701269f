"""Cross-silo distributed FedAvg over the message-passing comm layer (port
of ``fedml_tpu/algos/fedavg_distributed.py``).

Parity with the reference's distributed pipeline
(fedml_api/distributed/fedavg/FedAvgAPI.py:20, FedAVGAggregator.py,
FedAvgServerManager.py, FedAvgClientManager.py, message_define.py:1-12):
one server process + W client processes; per round the server samples
client indices (seeded, FedAVGAggregator.py:90-99), broadcasts the global
model, each worker runs local SGD on its assigned client's shard on the
card, and the server weighted-averages the returned trees on the card.

This path exists for TRUE federation (separate hosts/silos over loopback or
the native TCP transport). Simulated federation should use ``FedAvgAPI``,
where the cohort is a tensor dim of one captured round.

Where the work runs:

- a silo's local training is ONE ``core.graph.CapturedStep`` of the
  single-client step (JAX ``jit``\\ s it), shared by the silos of a
  process, captured once and replayed; on the CPU it runs eagerly;
- the server folds each upload into an f32 accumulator on the card (JAX
  ``jit``\\ s ``_lift``/``_accum``/``_finalize``) and evaluates there;
- the wire, the codecs and the ingest pool are numpy on the host, as in
  JAX: the server ships a host copy of the global net (one copy per
  round), a silo copies it to the card, trains, and uploads the host copy
  of its net (or of its delta, through a codec).

Every device call that the federation's threads make (a silo's replay
with the host copy of its outputs, the server's fold, finalize and eval)
runs under ``core.graph.capture_lock``: a capture in the ``"global"``
mode fails if another thread does CUDA work meanwhile, and a replay
overwrites the graph's static outputs. On one card that costs no
parallelism that JAX's single device stream had.

Fault-tolerant control plane (the reference's ``check_whether_all_receive``
blocks unconditionally — one dead worker hangs its server forever):

- **Heartbeat-driven membership** — workers piggyback liveness on
  uploads plus a lightweight beat while training long rounds; the
  server's watchdog runs the round deadline through
  ``HeartbeatMonitor.wait_all_or_failed`` and EVICTS silent ranks: their
  in-flight round is abandoned and aggregation proceeds over the
  surviving cohort. A returning rank is re-admitted through the
  stale-round catch-up path (or on a beat, when its upload/assignment was
  lost in transit).
- **Idempotent uploads** — a duplicated upload is detected by the
  per-worker round high-water mark and dropped without a reply, so the
  aggregator never double-counts and no worker ever holds two
  assignments.
- **Bounded termination** — done-handshakes are tracked per member and
  watched by the same watchdog, so a permanently dead rank can never
  hang the run.
- **Crash-resume** — the server checkpoints its run state every
  ``cfg.checkpoint_every`` rounds (``obs/checkpoint.py``'s format, written
  off the round's critical path) and stamps a monotonic EPOCH into every
  message; a restarted server restores the latest checkpoint, bumps the
  epoch, and deterministically rejects pre-crash uploads while workers
  adopt the new epoch from its re-broadcast assignments.

Adapter federations (``cfg.adapter_rank > 0``) put the LoRA adapters of a
frozen-base ``transformer_lm`` on the wire (:func:`build_federation_setup`);
the asynchronous tiers over these managers are ``algos/fedasync.py`` and
``algos/fedbuff.py``.

Secure aggregation (``cfg.secagg``, ``comm/secagg.py``): the silo quantizes
its host copy onto the ingest pool's int64 grid and adds pairwise masks
there; the masks cancel in the server's exact fold and a dropped silo's
are corrected away after a t-of-n seed reveal. The sharded aggregation
plane (``agg_shards``, ``comm/shardplane.py``) moves that fold onto M
shard ranks whose int64 partials the coordinator merges; an adaptive
controller (``controller=``, ``ctrl/policy.py``) steps at the server's
between-rounds boundary. All three are host-side, as in JAX: only the
silo's local step and the server's finalize and eval run on the card.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.comm import codec as wire_codec
from fedml_tpu_torch.comm import pytree
from fedml_tpu_torch.comm import secagg as secagg_mod
from fedml_tpu_torch.comm.ingest import (FixedContribution, PartialAccumulator,
                                         finalize_partial_mean,
                                         upload_fold_task)
from fedml_tpu_torch.comm.loopback import LoopbackNetwork, run_workers
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.resilience import ChaosSpec, HeartbeatSender
from fedml_tpu_torch.core import compression, keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.faults import HeartbeatMonitor
from fedml_tpu_torch.core.graph import CapturedStep, capture_lock
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.core.tree import sorted_leaves, sorted_tree_map
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.obs.registry import MetricsRegistry, payload_nbytes
from fedml_tpu_torch.trainer.local import (
    NetState,
    make_client_optimizer,
    make_eval_fn,
    make_local_train_fn_from_cfg,
    model_fns,
    softmax_ce,
)

# message_define.py:1-12 parity
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
# Control plane (no reference equivalent): worker liveness beats and the
# server watchdog's self-addressed deadline tick.
MSG_TYPE_C2S_HEARTBEAT = 4
MSG_TYPE_SRV_TICK = 5
# Secure-aggregation control plane (comm/secagg.py): pk handshake,
# roster/share distribution, and the dropout seed-reveal round. Kept
# clear of the shardplane block (20-25).
MSG_TYPE_C2S_SECAGG_PK = 30
MSG_TYPE_S2C_SECAGG_ROSTER = 31
MSG_TYPE_C2S_SECAGG_SHARES = 32
MSG_TYPE_S2C_SEED_REVEAL = 33
MSG_TYPE_C2S_SEED_SHARE = 34

MSG_ARG_KEY_MODEL_PARAMS = Message.MSG_ARG_KEY_MODEL_PARAMS
MSG_ARG_KEY_CLIENT_INDEX = Message.MSG_ARG_KEY_CLIENT_INDEX
MSG_ARG_KEY_NUM_SAMPLES = Message.MSG_ARG_KEY_NUM_SAMPLES
# Sharded aggregation plane (comm/shardplane.py): the assignment stamps
# the rank the worker must UPLOAD to. Absent (the single-server path)
# means rank 0 — the coordinator itself ingests.
MSG_ARG_KEY_SHARD_RANK = "shard_rank"

log = logging.getLogger(__name__)


def check_device(train_fed, device):
    """``device`` resolved (``None`` → cuda), refusing a ``train_fed``
    that lies elsewhere."""
    device = resolve_device(device)
    fd = train_fed.device
    if fd.type != device.type or (fd.index is not None and device.index
                                  is not None and fd.index != device.index):
        raise ValueError(f"train_fed lies on {train_fed.device}, the "
                         f"federation runs on {device}")
    return device


def _tree_add(a, b):
    return sorted_tree_map(lambda x, y: x + y, a, b)


def _tree_sub(a, b):
    return sorted_tree_map(lambda x, y: x - y, a, b)


def _as_dict(net):
    """A ``NetState`` as the nested dict the port's legacy compressors
    and robust aggregators walk (``core/compression.py``,
    ``core/robust_agg.py``); any other tree as it is."""
    if isinstance(net, NetState):
        return {"params": net.params, "model_state": net.model_state}
    return net


def _like(ref, tree):
    """``tree`` (from :func:`_as_dict`) back in ``ref``'s form (a
    decoded tree holds no entry for an empty ``model_state``)."""
    if isinstance(ref, NetState):
        return NetState(tree["params"], tree.get("model_state", {}))
    return tree


class FedAVGAggregator:
    """Server state with STREAMING ingest: every accepted upload is folded
    into an O(model) weighted f32 accumulator on the card ON ARRIVAL, so
    mean aggregation holds one model-sized buffer regardless of the fleet
    size. The reference instead buffers every worker's full model and
    reduces at the round barrier (FedAVGAggregator.py:44-88), O(clients x
    model) server memory.

    A non-mean ``aggregator`` spec (:func:`core.robust_agg.make_aggregator`
    — coord_median, trimmed mean, Krum, geometric median) needs the
    cohort side by side, so that path alone retains the stack-then-reduce
    buffer (O(cohort x model)). ``live_model_buffers`` is the O(model)
    pin's observable.

    ``net`` may be a ``NetState`` or a dict of arrays or tensors; it is
    held as tensors on ``device`` (``None`` → cuda). Uploads arrive as
    host arrays and are copied to the card once each."""

    def __init__(self, net, worker_num: int, cfg: FedConfig, eval_fn=None,
                 test_data=None, aggregator: str = "mean", device=None):
        from fedml_tpu_torch.core.robust_agg import make_aggregator

        self.device = resolve_device(device)
        self.net = pytree.to_device(net, self.device)
        self.worker_num = worker_num
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.test_data = test_data
        self.aggregator = make_aggregator(aggregator)
        self.model_dict: Dict[int, object] = {}  # non-mean stack path ONLY
        self.sample_num_dict: Dict[int, float] = {}
        self.test_history: List[dict] = []
        # Stamped by FedML_FedAvg_distributed after the run: the server's
        # final health() snapshot and its ingest profile.
        self.final_health: Dict[str, int] = {}
        self.ingest_profile: Dict[str, object] = {}
        # Mean fast path: running sample-weighted sum + weight, O(model).
        self._acc = None
        self._wsum = 0.0
        self._acc_indices: Set[int] = set()

    @property
    def live_model_buffers(self) -> int:
        """Model-sized trees the ingest path holds RIGHT NOW: the running
        accumulator counts one; only the non-mean stack path ever counts
        more."""
        return (1 if self._acc is not None else 0) + len(self.model_dict)

    def add_local_trained_result(self, index: int, model_params, sample_num) -> None:
        w = float(sample_num)
        if self.aggregator.is_mean:
            if index in self._acc_indices:
                # Idempotent ingest: the manager's round high-water mark
                # already dedupes wire duplicates; this guards direct
                # callers.
                return
            self._acc_indices.add(index)
            self.sample_num_dict[index] = w
            wf = float(np.float32(w))
            with capture_lock:
                p = pytree.to_device(model_params, self.device)
                if self._acc is None:
                    self._acc = sorted_tree_map(lambda p_: wf * p_.float(),
                                                p)
                else:
                    self._acc = sorted_tree_map(
                        lambda a_, p_: a_ + wf * p_.float(), self._acc, p)
            self._wsum += w
        else:
            with capture_lock:
                self.model_dict[index] = pytree.to_device(model_params,
                                                          self.device)
            self.sample_num_dict[index] = w

    def aggregate(self):
        return self.aggregate_from(range(self.worker_num))

    def aggregate_from(self, indices):
        """Aggregate over a subset of worker slots — the first-k
        straggler-tolerant mode aggregates only the workers that uploaded
        fresh results this round. An EMPTY index set (every sampled
        worker evicted/excluded) keeps the previous global net.

        On the streaming mean path the set must equal the accumulated
        arrivals — an O(model) accumulator cannot subset post-hoc, so a
        mismatch is a protocol bug and raises instead of silently
        mis-weighting."""
        indices = list(indices)
        if not indices:
            return self.net
        if self.aggregator.is_mean:
            if set(indices) != self._acc_indices:
                raise ValueError(
                    f"streaming ingest accumulated workers "
                    f"{sorted(self._acc_indices)} but was asked to "
                    f"aggregate {sorted(indices)}: the O(model) mean path "
                    "cannot subset after arrival")
            inv = float(np.float32(1.0 / max(self._wsum, 1e-12)))
            with capture_lock:
                self.net = sorted_tree_map(
                    lambda r_, a_: (inv * a_).to(r_.dtype), self.net,
                    self._acc)
            self._acc = None
            self._wsum = 0.0
            self._acc_indices = set()
            return self.net
        # Robust path: the cohort side by side (weights gate participation
        # in the order statistics, value-weight the mean-like reducers).
        with capture_lock:
            weights = torch.tensor(
                [self.sample_num_dict[i] for i in indices],
                dtype=torch.float32, device=self.device)
            stacked = sorted_tree_map(
                lambda *ls: torch.stack([l.float() for l in ls]),
                *[self.model_dict[i] for i in indices])
            agg = _like(stacked, self.aggregator(_as_dict(stacked), weights))
            self.net = sorted_tree_map(lambda r_, a_: a_.to(r_.dtype),
                                       self.net, agg)
        for i in indices:
            self.model_dict.pop(i, None)
        return self.net

    def aggregate_pooled(self, indices, pool, envelope_check=None):
        """The pooled-mean twin of :meth:`aggregate_from`: the ingest
        pool (comm/ingest.py) already holds ``Σ w·x`` in exact fixed
        point across its per-worker partials — merge, divide once, cast
        to the reference dtypes on the card. The pool's task count must
        equal the arrived set. An empty index set keeps the previous
        net. ``envelope_check`` (secagg rounds) runs on the merged total
        BETWEEN cancellation and the division — the only moment
        mask-domain saturation is observable (comm/ingest.py
        envelope_overflow)."""
        indices = list(indices)
        total = pool.merge_partials()
        if envelope_check is not None:
            envelope_check(total)
        with capture_lock:
            mean, count = finalize_partial_mean(total, self.net)
        if count != len(indices):
            raise ValueError(
                f"ingest pool folded {count} uploads but the round "
                f"arrived {len(indices)}: the pooled mean cannot subset "
                "after arrival")
        if not indices or mean is None:
            return self.net
        self.net = mean
        return self.net

    def client_sampling(self, round_idx: int) -> np.ndarray:
        return sample_clients(
            round_idx, self.cfg.client_num_in_total, self.cfg.client_num_per_round
        )

    def test_on_server(self, round_idx: int) -> Optional[dict]:
        """Global-test-set eval on the card (replaces the reference's
        per-client loop, FedAVGAggregator.py:110-161)."""
        if self.eval_fn is None or self.test_data is None:
            return None
        with capture_lock:
            m = self.eval_fn(self.net, *self.test_data)
            out = {"round": round_idx, **{k: float(v) for k, v in m.items()}}
        self.test_history.append(out)
        return out


class FedAVGServerManager(ServerManager):
    """Synchronous server. ``aggregate_k`` (0 = all workers) enables
    straggler-tolerant first-k rounds: the round aggregates as soon as
    ``k`` FRESH uploads arrive; a straggler's late upload for an older
    round is discarded and the worker is immediately reassigned to the
    current round ("catch-up"), so message flow stays strict
    request/response — every upload gets exactly one reply and no worker
    can hold two assignments.

    With ``round_timeout_s > 0`` the control plane is live: a watchdog
    thread runs each round's deadline through
    ``HeartbeatMonitor.wait_all_or_failed`` and posts a self-addressed
    TICK message, so evictions execute on the receive-dispatch thread
    like every other state change (handlers stay single-threaded).
    Evicted ranks leave the membership — the first-k threshold shrinks
    with it, a returning rank re-admits via catch-up — and the terminal
    done-handshake is watched the same way, so the run always ends.
    See the module docstring for the full failure model."""

    # The sharded coordinator (comm/shardplane.py) folds on its shard
    # ranks instead of a local ingest pool — it overrides this so the
    # secagg constructor check accepts a pool-less coordinator.
    _secagg_sharded = False

    def __init__(self, args, aggregator: FedAVGAggregator, cfg: FedConfig,
                 size: int, backend: str = "LOOPBACK", compress: str = "none",
                 aggregate_k: int = 0, *,
                 round_timeout_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 done_timeout_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 metrics=None, clock=time.monotonic,
                 flight_dir: Optional[str] = None):
        super().__init__(args, rank=0, size=size, backend=backend)
        if aggregate_k and not 1 <= aggregate_k <= size - 1:
            raise ValueError(
                f"aggregate_k={aggregate_k} outside [1, {size - 1}]")
        self.aggregator = aggregator
        self.cfg = cfg
        self.round_idx = 0
        self.aggregate_k = aggregate_k or (size - 1)
        self._arrived: Set[int] = set()
        self.straggler_drops = 0
        self.duplicate_drops = 0
        self.epoch_drops = 0
        self.codec_refusals = 0
        self.evictions = 0
        self.readmissions = 0
        self.aborted = False
        self._members: Set[int] = set(range(1, size))
        self._done_set: Set[int] = set()
        self._last_upload_round: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._stopped = False
        self._clock = clock
        self.metrics = metrics
        self.round_timeout_s = (cfg.round_timeout_s
                                if round_timeout_s is None else round_timeout_s)
        self.done_timeout_s = (done_timeout_s if done_timeout_s is not None
                               else (self.round_timeout_s or 0.0))
        self.heartbeat = HeartbeatMonitor(
            range(1, size),
            timeout_s=(heartbeat_timeout_s if heartbeat_timeout_s is not None
                       else (self.round_timeout_s or 30.0)),
            clock=clock)
        self._decoders = {}  # legacy compressor name → compressor
        self._wire_decoders = wire_codec.CodecCache()  # spec → WireCodec
        self._spec = wire_codec.tree_spec(aggregator.net)
        self._legacy_spec = compression.tree_spec(_as_dict(aggregator.net))
        self._host_cache = None
        # Ingest observability: per-upload decode/fold latency +
        # payload-size histograms and the dispatch-thread busy clock feed
        # ``ingest_profile()`` and the per-round ctrl/ metrics stream;
        # the flight recorder keeps the last control-plane events and
        # dumps them to ``flight_dir`` on eviction / abort / codec
        # refusal.
        self.registry = MetricsRegistry()
        self._h_decode = self.registry.histogram("decode_ms")
        self._h_fold = self.registry.histogram("fold_ms")
        self._h_bytes = self.registry.histogram("bytes_per_upload", lo=1.0)
        self._g_queue = self.registry.gauge("ingest_queue_depth")
        # Parallel ingest pool (comm/ingest.py, cfg.ingest_workers > 0):
        # decode + delta reconstruction + the mean fold move to worker
        # threads with per-worker associative-exact partial accumulators;
        # the round flush barriers on the pool and merges. Mean only.
        workers = int(getattr(cfg, "ingest_workers", 0) or 0)
        if workers > 0 and not aggregator.aggregator.is_mean:
            raise ValueError(
                f"ingest_workers={workers} needs the mean aggregator: "
                f"{aggregator.aggregator.name!r} retains the serialized "
                "stack-then-reduce cohort buffer — run it with "
                "ingest_workers=0 (comm/ingest.py)")
        if workers > 0:
            from fedml_tpu_torch.comm.ingest import IngestPool

            self._pool = IngestPool(workers, registry=self.registry)
            self._g_pool_queue = self.registry.gauge(
                "ingest_pool_queue_depth")
        else:
            self._pool = None
        # Secure aggregation (comm/secagg.py, cfg.secagg): masked uploads
        # ride the SAME fixed-point fold the pool (or the shard plane)
        # already runs — integer adds are the only ingest arithmetic
        # whose associativity cancels pairwise masks exactly.
        self.secagg: Optional[secagg_mod.SecAggServer] = None
        self.seed_reveals = 0
        self._secagg_waitroom: Set[int] = set()
        self._secagg_reveal_asked: Set[int] = set()
        self._secagg_reveal_t0: Dict[int, float] = {}
        if getattr(cfg, "secagg", False):
            if not aggregator.aggregator.is_mean:
                raise ValueError(
                    "cfg.secagg masks the pooled MEAN's fixed-point fold; "
                    f"aggregator {aggregator.aggregator.name!r} reduces "
                    "the cohort side by side and would see per-client "
                    "masked frames that never cancel")
            if aggregate_k:
                raise ValueError(
                    "cfg.secagg is all-or-reveal: aggregate_k first-k "
                    "rounds would orphan every straggler's masks and "
                    "force a seed reveal per round — run aggregate_k=0")
            if self._pool is None and not self._secagg_sharded:
                raise ValueError(
                    "cfg.secagg needs the fixed-point ingest path: set "
                    "ingest_workers > 0 (comm/ingest.py) or agg_shards "
                    "> 0 (comm/shardplane.py)")
            self._secagg_init()
        self.flight = obs_trace.FlightRecorder(
            clock=clock,
            path=(os.path.join(flight_dir, "flight_recorder.jsonl")
                  if flight_dir else None))
        # Crash-resume: restore the latest checkpoint (if any) and run
        # under a BUMPED epoch — every message carries it, so pre-crash
        # uploads are deterministically rejected.
        self.epoch = 0
        self._ckpt = None
        if checkpoint_dir:
            from fedml_tpu_torch.obs.checkpoint import (CheckpointManager,
                                                        allocate_epoch,
                                                        restore_federation)

            self._ckpt = CheckpointManager(checkpoint_dir)
            restored = restore_federation(self._ckpt, aggregator.net)
            # allocate_epoch, not restored["epoch"] + 1: two crashes
            # inside one checkpoint window would otherwise reuse an epoch
            # and let the previous incarnation's uploads through the
            # fence.
            self.epoch = allocate_epoch(
                self._ckpt, -1 if restored is None else restored["epoch"])
            if restored is not None:
                aggregator.net = restored["net"]
                self.round_idx = restored["round_idx"]
                log.info("server restored: round %d, epoch %d",
                         self.round_idx, self.epoch)
        # The net broadcast this round — compressed uploads are deltas
        # against it, so reconstruction must use the same anchor.
        self._broadcast_net = aggregator.net
        del compress  # server decodes by each frame's self-described codec
        # Actuation seam (fedml_tpu_torch.ctrl): validated, boundary-gated
        # knob setters tuned between rounds. Building it is inert.
        from fedml_tpu_torch.ctrl.actuator import ActuationSeam, Knob

        knobs = [
            Knob("aggregate_k", lambda: self.aggregate_k,
                 lambda v: setattr(self, "aggregate_k", v),
                 1, max(1, size - 1), cast=int),
        ]
        if self.round_timeout_s and self.round_timeout_s > 0:
            knobs.append(Knob(
                "round_timeout_s", lambda: self.round_timeout_s,
                self._set_round_timeout, 1e-3, 86400.0))
        if self.done_timeout_s and self.done_timeout_s > 0:
            knobs.append(Knob(
                "done_timeout_s", lambda: self.done_timeout_s,
                lambda v: setattr(self, "done_timeout_s", v),
                1e-3, 86400.0))
        if self._pool is not None:
            knobs.append(Knob(
                "ingest_workers", lambda: self._pool.workers,
                lambda v: self._pool.resize(v), 1, 64, cast=int,
                constraint=lambda v: ("pool_shrink_unsupported"
                                      if v < self._pool.workers else None)))
        self.ctrl = ActuationSeam(
            type(self).__name__, knobs, registry=self.registry,
            flight=self.flight, progress=lambda: self.round_idx)

    def _set_round_timeout(self, v: float) -> None:
        # The watchdog reads round_timeout_s live each pass; the
        # heartbeat silence threshold tracks it only when it defaulted
        # to the round deadline at construction.
        if self.heartbeat.timeout_s == self.round_timeout_s:
            self.heartbeat.timeout_s = v
        self.round_timeout_s = v

    def _host_of(self, net):
        """The host copy of a global net that messages carry (the JAX
        package's implicit ``device_get`` on send), made once per net."""
        cached = self._host_cache
        if cached is not None and cached[0] is net:
            return cached[1]
        with capture_lock:
            host = pytree.host_tree(net)
        self._host_cache = (net, host)
        return host

    # -- lifecycle ----------------------------------------------------------
    def run(self) -> None:
        self.register_message_receive_handlers()
        # Liveness clocks start when the RUN starts, not at construction.
        for r in self._members_snapshot():
            self.heartbeat.beat(r)
        self.send_init_msg()
        # Armed by EITHER deadline: done_timeout_s alone still bounds the
        # terminal handshake.
        if ((self.round_timeout_s and self.round_timeout_s > 0)
                or (self.done_timeout_s and self.done_timeout_s > 0)):
            threading.Thread(target=self._watchdog_loop, daemon=True).start()
        self.com_manager.handle_receive_message()

    def finish(self) -> None:
        self._stopped = True
        if self._pool is not None:
            self._pool.close()
        if self._ckpt is not None:
            try:
                self._save_checkpoint(wait=True)
            except Exception:  # noqa: BLE001 — shutdown must not re-raise
                log.exception("final checkpoint save failed")
            self._ckpt.close()
            self._ckpt = None
        super().finish()

    def send_init_msg(self) -> None:
        if self.round_idx >= self.cfg.comm_round:
            # Restored at (or past) the terminal round: nothing to train.
            for worker in self._members_snapshot():
                self._send_done(worker)
            return
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        for worker in self._members_snapshot():
            msg = Message(MSG_TYPE_S2C_INIT_CONFIG, 0, worker)
            msg.add(MSG_ARG_KEY_MODEL_PARAMS,
                    self._host_of(self.aggregator.net))
            ci = int(client_indexes[self._worker_slot(worker)])
            msg.add(MSG_ARG_KEY_CLIENT_INDEX, ci)
            msg.add("round", self.round_idx)
            msg.add("epoch", self.epoch)
            msg.add(wire_codec.OFFER_KEY, wire_codec.codec_offer())
            # Negotiated delta capability: this server decodes
            # delta-framed uploads against the round's broadcast anchor.
            msg.add(wire_codec.DELTA_OK_KEY, True)
            if self.secagg is not None:
                # Capability stage: no roster yet, so clients DEFER the
                # round and open the pk handshake; the assignment
                # re-arrives roster-stamped once the share matrix lands.
                msg.add(wire_codec.SECAGG_OK_KEY, True)
            self._stamp_routing(msg, ci)
            self._safe_send(msg, worker)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client,
        )
        self.register_message_receive_handler(
            MSG_TYPE_C2S_HEARTBEAT, self._handle_heartbeat)
        self.register_message_receive_handler(
            MSG_TYPE_SRV_TICK, self._handle_tick)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SECAGG_PK, self._handle_secagg_pk)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SECAGG_SHARES, self._handle_secagg_shares)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEED_SHARE, self._handle_seed_share)

    # -- snapshots (watchdog thread reads; handlers mutate under _lock) -----
    def _members_snapshot(self) -> List[int]:
        with self._lock:
            return sorted(self._members)

    def _arrived_snapshot(self) -> List[int]:
        with self._lock:
            return sorted(self._arrived)

    def _done_snapshot(self) -> List[int]:
        with self._lock:
            return sorted(self._done_set)

    def _round_snapshot(self) -> int:
        # round_idx commits on the dispatch thread (_complete_round);
        # the watchdog keys its deadline/eviction decisions off it and
        # must read the committed value, not a torn one.
        with self._lock:
            return self.round_idx

    def _k_effective(self) -> int:
        return max(1, min(self.aggregate_k, len(self._members)))

    def _worker_slot(self, worker: int) -> int:
        """Worker rank → its 0-based slot in the round's sampled
        ``client_indexes`` (also the aggregator's worker index). The
        sharded coordinator re-bases this — its worker ranks start after
        the M aggregator-shard ranks (comm/shardplane.py)."""
        return worker - 1

    def _stamp_routing(self, out: Message, client_index: int) -> None:
        """Hook for the sharded aggregation plane: stamp the shard rank
        this worker must upload to. The single-server path routes every
        upload to rank 0 — nothing to stamp."""

    def health(self) -> Dict[str, int]:
        """Control-plane counters, surfaced per round through the metrics
        logger and asserted on by the fault drills. ``bytes_tx``/
        ``bytes_rx`` are the transport's ByteLedger totals (comm/wire.py);
        0 on plain in-memory loopback. ``ingest_saturated`` is the
        lifetime count of clipped fixed-point contributions
        (comm/ingest.py) — the sharded coordinator overrides it with the
        fleet-wide sum over its shards' gauges."""
        ledger = getattr(self.com_manager, "bytes_ledger", None)
        saturated = 0
        if self._pool is not None:
            saturated = int(sum(p.saturated for p in self._pool.partials))
        with self._lock:
            return {
                "ingest_saturated": saturated,
                "members": len(self._members),
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "straggler_drops": self.straggler_drops,
                "duplicate_drops": self.duplicate_drops,
                "epoch_drops": self.epoch_drops,
                "codec_refusals": self.codec_refusals,
                "seed_reveals": self.seed_reveals,
                "epoch": self.epoch,
                "send_retries": getattr(self.com_manager, "retry_count", 0),
                "bytes_tx": ledger.total_tx if ledger is not None else 0,
                "bytes_rx": ledger.total_rx if ledger is not None else 0,
            }

    # -- fault-aware sends --------------------------------------------------
    def _safe_send(self, msg: Message, worker: int) -> bool:
        """Send; a transport-level failure (peer dead past the retry
        policy) EVICTS the worker instead of crashing the control plane."""
        try:
            self.send_message(msg)
            return True
        except (ConnectionError, OSError) as err:
            log.warning("send to worker %d failed (%s): evicting", worker, err)
            self._evict([worker])
            return False

    def _evict(self, ranks) -> None:
        # Evicted ranks STAY in the heartbeat monitor: an alive-but-slow
        # rank keeps beating and is re-admitted by _handle_heartbeat;
        # only ranks whose beats also stop are truly gone.
        evicted = []
        with self._lock:
            for w in ranks:
                if w in self._members:
                    self._members.discard(w)
                    self.evictions += 1
                    evicted.append(w)
        if evicted:
            # An eviction is a postmortem trigger: persist the recent
            # control-plane history NOW.
            self.flight.record("eviction", ranks=evicted,
                               round=self.round_idx)
            self.flight.dump()

    def _send_done(self, worker: int) -> None:
        out = Message(MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, worker)
        out.add(MSG_ARG_KEY_MODEL_PARAMS, self._host_of(self.aggregator.net))
        out.add("done", True)
        out.add("epoch", self.epoch)
        if self._safe_send(out, worker):
            with self._lock:
                self._done_set.add(worker)
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        with self._lock:
            done = self._done_set >= self._members
        if done and not self._stopped:
            self.finish()

    def _send_assignment(self, worker: int, client_indexes=None, *,
                         resend: bool = False) -> None:
        if client_indexes is None:
            client_indexes = self.aggregator.client_sampling(self.round_idx)
        out = Message(MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, worker)
        out.add(MSG_ARG_KEY_MODEL_PARAMS, self._host_of(self._broadcast_net))
        ci = int(client_indexes[self._worker_slot(worker)])
        out.add(MSG_ARG_KEY_CLIENT_INDEX, ci)
        out.add("round", self.round_idx)
        out.add("done", False)
        out.add("epoch", self.epoch)
        # Negotiation rides every assignment (not just init): a worker
        # re-admitted after the init was lost still learns the offer.
        out.add(wire_codec.OFFER_KEY, wire_codec.codec_offer())
        out.add(wire_codec.DELTA_OK_KEY, True)
        if self.secagg is not None:
            out.add(wire_codec.SECAGG_OK_KEY, True)
            members = self._members_snapshot()
            if self.secagg.setup_complete(members):
                # Stamp the per-round roster (first stamp wins; resends
                # re-ship the stored snapshot): every member of the
                # round masks against the same peer set, or nothing
                # cancels.
                roster = self.secagg.stamp_roster(self.round_idx, members)
                out.add("secagg_roster", [int(x) for x in roster])
        if resend:
            # Re-admission: the worker's upload (or our assignment) was
            # lost — a client that already trained this round should
            # RESEND its cached upload. Only flagged assignments trigger
            # that, so a plain transport duplicate of a normal assignment
            # is dropped instead of costing a model-sized resend.
            out.add("resend", True)
        self._stamp_routing(out, ci)
        self._safe_send(out, worker)

    # -- checkpointing ------------------------------------------------------
    def _save_checkpoint(self, wait: bool) -> None:
        from fedml_tpu_torch.obs.checkpoint import save_federation

        try:
            save_federation(self._ckpt, self.aggregator.net, self.round_idx,
                            self.epoch, wait=wait)
        except Exception:  # noqa: BLE001 — e.g. a save still in flight
            self._ckpt.wait()
            save_federation(self._ckpt, self.aggregator.net, self.round_idx,
                            self.epoch, wait=wait)

    # -- watchdog: round deadline + bounded done-handshake ------------------
    def _watchdog_loop(self) -> None:
        poll = max(0.005, min(
            0.05, (self.round_timeout_s or self.done_timeout_s) / 10))
        while not self._stopped:
            members = self._members_snapshot()
            if not members:
                # Either everyone is dead (the tick handler aborts) or an
                # eviction storm is healing through beat re-admissions —
                # keep watching either way.
                self._post_tick(self._round_snapshot(), [])
                time.sleep(max(poll, 0.1))
                continue
            r = self._round_snapshot()
            if r >= self.cfg.comm_round:
                if self.done_timeout_s and self.done_timeout_s > 0:
                    failed = self.heartbeat.wait_all_or_failed(
                        members, have=self._done_snapshot, poll_s=poll,
                        deadline_s=self.done_timeout_s)
                    if not self._stopped and failed:
                        self._post_tick(r, failed)
            elif self.round_timeout_s and self.round_timeout_s > 0:
                failed = self.heartbeat.wait_all_or_failed(
                    members,
                    have=lambda m=members, r=r: (
                        m if (self._stopped or self._round_snapshot() != r)
                        else self._arrived_snapshot()),
                    poll_s=poll, deadline_s=self.round_timeout_s)
                if not self._stopped and failed \
                        and self._round_snapshot() == r:
                    self._post_tick(r, failed)
            time.sleep(poll)

    def _post_tick(self, round_idx: int, failed) -> None:
        """Self-addressed deadline tick: eviction executes on the receive
        thread, serialized with every other handler."""
        msg = Message(MSG_TYPE_SRV_TICK, 0, 0)
        msg.add("round", int(round_idx))
        msg.add("failed", [int(w) for w in failed])
        msg.add("epoch", self.epoch)
        try:
            self.send_message(msg)
        except (ConnectionError, OSError):
            pass  # next watchdog pass re-ticks

    def _handle_tick(self, msg: Message) -> None:
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            return  # tick from a pre-crash instance left in the inbox
        failed = set(msg.get("failed") or [])
        terminal = self.round_idx >= self.cfg.comm_round
        with self._lock:
            if terminal:
                evict = [w for w in failed
                         if w in self._members and w not in self._done_set]
            else:
                if int(msg.get("round", -1)) != self.round_idx:
                    return  # stale: the round advanced while it was queued
                evict = [w for w in failed
                         if w in self._members and w not in self._arrived]
        if evict:
            log.warning("round %d deadline: evicting silent ranks %s",
                        self.round_idx, evict)
            self._evict(evict)
            if self.secagg is not None and not terminal:
                # Setup-phase eviction can unblock the handshake: if the
                # missing pk belonged to the corpse, the roster can
                # broadcast to the survivors now.
                self._secagg_nudge()
        if terminal:
            self._maybe_finish()
            return
        with self._lock:
            empty = not self._members
            ready = bool(self._arrived) and (
                len(self._arrived) >= self._k_effective())
        if empty:
            if self.heartbeat.alive():
                # Everyone missed the deadline but someone still beats
                # (e.g. the whole fleet is capturing its first round):
                # hold the round open — the next beats re-admit them and
                # their uploads complete it.
                return
            # Every worker is gone; nothing can ever arrive again.
            log.error("all workers evicted at round %d: abandoning the run",
                      self.round_idx)
            self.aborted = True
            self.flight.record("abort", round=self.round_idx)
            self.flight.dump()
            self.finish()
            return
        if ready:
            self._complete_round()

    def _handle_heartbeat(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        self.heartbeat.beat(sender)
        self.flight.record("beat", sender=sender)
        if self.round_idx >= self.cfg.comm_round:
            # Any beat at the terminal round gets a done (idempotent: the
            # worker finishes on first receipt), an evicted-but-alive
            # rank included.
            self._send_done(sender)
            return
        with self._lock:
            member = sender in self._members
        if member:
            if self.secagg is not None:
                self._secagg_redrive(sender)
            return
        if self.secagg is not None and not self._secagg_readmit_ok(sender):
            return  # released or waitroomed by the secagg policy
        # Evicted-but-alive: its upload or our assignment was lost, or it
        # was slow past the deadline. Re-admit with the current round's
        # work, resend-flagged.
        with self._lock:
            self._members.add(sender)
            self.readmissions += 1
        log.info("re-admitting rank %d on heartbeat", sender)
        self.flight.record("readmission", sender=sender,
                           round=self.round_idx, via="beat")
        self._send_assignment(sender, resend=True)

    # -- secure aggregation (comm/secagg.py) --------------------------------
    def _secagg_init(self) -> None:
        """(Re)key the secagg coordinator to the current membership —
        the sharded coordinator re-bases its worker ranks AFTER the base
        constructor ran and calls this again with the corrected set."""
        self.secagg = secagg_mod.SecAggServer(
            self._members_snapshot(),
            t=int(getattr(self.cfg, "secagg_t", 0) or 0))
        self._c_reveals = self.registry.counter("secagg_reveals")
        self._c_mask_overflow = self.registry.counter(
            "secagg_mask_overflow")
        self._h_reveal = self.registry.histogram("secagg_reveal_ms")

    def _secagg_readmit_ok(self, sender: int) -> bool:
        """Re-admission policy for a non-member beat under secagg. True
        → the normal resend-flagged re-admission proceeds; False → this
        call already disposed of the sender (released for the epoch, or
        parked in the waitroom until the next round's roster can take
        it)."""
        sa = self.secagg
        if sa.compromised(sender):
            # Its seeds are revealed (or mid-reveal): every future mask
            # is server-derivable, so re-admission would silently void
            # its privacy. Release it for the epoch.
            self.flight.record("secagg_released", sender=sender,
                               round=self.round_idx)
            self._send_done(sender)
            return False
        if not sa.setup_complete(self._members_snapshot()):
            return True  # the handshake absorbs it like any member
        if sa.setup_roster is not None and sender not in sa.setup_roster:
            # Missed the handshake window: the pair-key mesh froze
            # without it, so no peer can ever cancel against it —
            # release rather than admit a clear upload to a masked
            # round.
            self.flight.record("secagg_locked_out", sender=sender,
                               round=self.round_idx)
            self.flight.dump()
            self._send_done(sender)
            return False
        roster = sa.roster_for(self.round_idx)
        if roster and sender not in roster:
            # The round's roster sealed without it — every member
            # already masked against a peer set that excludes this
            # rank, so a mid-round upload could never cancel. Park it;
            # the commit tail admits it into the next round.
            with self._lock:
                self._secagg_waitroom.add(sender)
            self.flight.record("secagg_waitroom", sender=sender,
                               round=self.round_idx)
            return False
        return True

    def _secagg_redrive(self, sender: int) -> None:
        """Beat-driven secagg repair for a MEMBER: chaos can eat any
        handshake or reveal frame; the member's own liveness beats are
        the retry clock (no extra timers)."""
        sa = self.secagg
        members = self._members_snapshot()
        missing_pks = sa.pks_missing(members)
        if missing_pks:
            if sender in missing_pks:
                # Re-solicit the pk: the resent assignment makes the
                # client defer and re-open the handshake.
                self._send_assignment(sender, resend=True)
            return
        if sender in sa.rows_missing(members):
            self._send_secagg_roster([sender])
            return
        # A reveal round in flight: re-ask this survivor for every share
        # it still owes. Gated on the asked-set — a merely-slow rank
        # must never be revealed before the control plane evicts it.
        for d in sorted(self._secagg_reveal_asked):
            if d != sender and d not in sa.revealed \
                    and not sa.has_share(d, sender):
                self._send_reveal_request(d, sender)

    def _secagg_nudge(self) -> None:
        """Post-eviction handshake re-check: with the corpse's pk no
        longer awaited, the roster may be broadcastable now."""
        members = self._members_snapshot()
        if not members or self.secagg.pks_missing(members):
            return
        need = self.secagg.rows_missing(members)
        if need:
            self._send_secagg_roster(need)

    def _handle_secagg_pk(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            self.epoch_drops += 1
            return
        self.heartbeat.beat(sender)
        if self.secagg is None:
            return
        self.secagg.add_pk(sender, int(msg.get("pk")))
        members = self._members_snapshot()
        if self.secagg.pks_missing(members):
            return  # beats redrive the stragglers
        need = set(self.secagg.rows_missing(members))
        if sender not in self.secagg.rows:
            need.add(sender)
        if need:
            self._send_secagg_roster(sorted(need))

    def _send_secagg_roster(self, workers) -> None:
        body = self.secagg.roster_payload(self._members_snapshot())
        ranks = sorted(body["pks"])
        for w in workers:
            out = Message(MSG_TYPE_S2C_SECAGG_ROSTER, 0, w)
            out.add("epoch", self.epoch)
            out.add("pk_ranks", [int(r) for r in ranks])
            out.add("pk_vals", [int(body["pks"][r]) for r in ranks])
            out.add("t", int(body["t"]))
            out.add("universe", [int(u) for u in body["universe"]])
            self._safe_send(out, w)

    def _handle_secagg_shares(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            self.epoch_drops += 1
            return
        self.heartbeat.beat(sender)
        if self.secagg is None:
            return
        new = sender not in self.secagg.rows
        holders = [int(h) for h in msg.get("row_holders")]
        ciphers = [int(c) for c in msg.get("row_ciphers")]
        self.secagg.add_row(sender, dict(zip(holders, ciphers)))
        members = self._members_snapshot()
        if not (new and self.secagg.setup_complete(members)):
            return
        # The share matrix just completed: release the deferred round —
        # every member that has not already uploaded gets its (now
        # roster-stamped) assignment.
        self.flight.record("secagg_setup", members=len(members),
                           t=int(self.secagg.t))
        if self.round_idx >= self.cfg.comm_round:
            return
        arrived = set(self._arrived_snapshot())
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        for w in members:
            if w not in arrived:
                self._send_assignment(w, client_indexes)

    def _send_reveal_request(self, target: int, holder: int) -> None:
        cipher = self.secagg.reveal_request(target, holder)
        if cipher is None:
            return  # the target never shipped a row entry for holder
        out = Message(MSG_TYPE_S2C_SEED_REVEAL, 0, holder)
        out.add("epoch", self.epoch)
        out.add("round", self.round_idx)
        out.add("target", int(target))
        out.add("cipher", int(cipher))
        self._safe_send(out, holder)

    def _secagg_request_reveals(self, targets) -> None:
        """Open (or re-drive) the seed-reveal round for ``targets`` —
        evicted roster ranks whose masks sit orphaned in the folded
        uploads. Survivor shares flow back as SEED_SHARE messages; the
        reveal latency histogram runs from the FIRST ask."""
        now = self._clock()
        survivors = [w for w in self._members_snapshot()
                     if w not in targets]
        for d in targets:
            first = d not in self._secagg_reveal_asked
            self._secagg_reveal_asked.add(d)
            self._secagg_reveal_t0.setdefault(d, now)
            if first:
                self.flight.record("seed_reveal_request", target=int(d),
                                   round=self.round_idx,
                                   survivors=len(survivors))
            for h in survivors:
                if not self.secagg.has_share(d, h):
                    self._send_reveal_request(d, h)
        if targets:
            self.flight.dump()

    def _handle_seed_share(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            # A share from a previous incarnation must never unlock a
            # live seed.
            self.epoch_drops += 1
            self.flight.record("seed_reveal_stale", sender=sender,
                               epoch=int(ep))
            return
        self.heartbeat.beat(sender)
        if self.secagg is None:
            return
        target = int(msg.get("target"))
        tr = obs_trace.active()
        ck = obs_trace.corr(epoch=self.epoch, round=self.round_idx,
                            sender=sender)
        with tr.span("secagg.reveal", cat="secagg", corr=ck,
                     target=target):
            done = self.secagg.add_reveal_share(target, sender,
                                                int(msg.get("share")))
        if not done:
            return
        self.seed_reveals += 1
        self._c_reveals.inc()
        t0 = self._secagg_reveal_t0.pop(target, None)
        if t0 is not None:
            self._h_reveal.record((self._clock() - t0) * 1e3)
        self.flight.record("seed_reveal", target=target,
                           round=self.round_idx,
                           shares=self.secagg.shares_held(target))
        self.flight.dump()
        self._secagg_recheck()

    def _secagg_recheck(self) -> None:
        """A reveal just completed: if the round was blocked on it (the
        precommit gate returned False), re-drive the commit."""
        if self.round_idx >= self.cfg.comm_round:
            return
        with self._lock:
            ready = bool(self._arrived) and (
                len(self._arrived) >= self._k_effective())
        if ready:
            self._complete_round()

    def _secagg_reveals_ready(self) -> bool:
        pending = self.secagg.unreconstructed(self.round_idx,
                                              self._arrived_snapshot())
        if pending:
            self._secagg_request_reveals(pending)
            return False
        return True

    def _secagg_precommit(self) -> bool:
        """The mask-completeness gate between the pool barrier and the
        merge: every roster rank either arrived (its masks cancel in
        the fold) or is an orphan whose reconstructed seeds yield an
        exact int64 correction, folded here as a weight-0 count-0
        contribution. Returns False while reveals are in flight —
        :meth:`_secagg_recheck` re-enters on reconstruction."""
        if not self._secagg_reveals_ready():
            return False
        r = self.round_idx
        arrived = self._arrived_snapshot()
        orphans = self.secagg.orphans(r, arrived)
        if not orphans:
            return True
        shapes = [tuple(l.shape)
                  for l in sorted_leaves(self.aggregator.net)]
        for d in orphans:
            corr = self.secagg.correction(d, r, self.epoch, arrived,
                                          shapes)
            self._pool.submit(
                lambda c=corr: FixedContribution(c, 0, 0),
                epoch=self.epoch, round=r, sender=int(d),
                kind="secagg_correction")
        for meta, err in self._pool.drain():
            log.error("secagg correction task failed: %s (%s)", meta, err)
        self.flight.record("secagg_correction", round=r,
                           targets=[int(d) for d in orphans])
        return True

    def _secagg_envelope_check(self, total) -> None:
        """Post-cancellation headroom audit: a merged masked total whose
        leaves exceed count·2^50 means the masks did NOT fully cancel
        (roster drift, a wrong correction) or the true sum genuinely
        wrapped — count it loudly, never clamp (comm/ingest.py
        envelope_overflow)."""
        over = int(total.envelope_overflow())
        if over:
            self._c_mask_overflow.inc()
            log.error("secagg: %d leaves outside the fixed-point "
                      "envelope after mask cancellation (round %d)",
                      over, self.round_idx)
            self.flight.record("mask_envelope_overflow", leaves=over,
                               round=self.round_idx)
            self.flight.dump()

    def _secagg_commit_tail(self, arrived) -> List[int]:
        """Post-commit membership repair: admit waitroomed ranks into
        the NEXT round's roster, purge compromised members, clear the
        per-round reveal bookkeeping. Returns the admitted ranks that
        still need an assignment fan-out."""
        sa = self.secagg
        with self._lock:
            admit = sorted(w for w in self._secagg_waitroom
                           if sa.can_participate(w))
            self._secagg_waitroom.clear()
            for w in admit:
                if w not in self._members:
                    self._members.add(w)
                    self.readmissions += 1
            for w in [m for m in self._members if sa.compromised(m)]:
                self._members.discard(w)
        self._secagg_reveal_asked.clear()
        self._secagg_reveal_t0.clear()
        for w in admit:
            self.flight.record("readmission", sender=w,
                               round=self.round_idx,
                               via="secagg_waitroom")
        return [w for w in admit if w not in arrived]

    # -- the round ----------------------------------------------------------
    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            # Pre-crash upload: the restarted server already re-broadcast
            # assignments under the new epoch, so this worker has live
            # work — reject deterministically, never reply.
            self.epoch_drops += 1
            self.flight.record("epoch_drop", sender=sender, epoch=int(ep))
            return
        self.heartbeat.beat(sender)
        tag = msg.get("round")
        t = int(tag) if tag is not None else self.round_idx
        with self._lock:
            if t <= self._last_upload_round.get(sender, -1):
                # Duplicate delivery: the first copy was answered —
                # replying again would hand the worker two assignments.
                self.duplicate_drops += 1
                self.flight.record("duplicate_drop", sender=sender, round=t)
                return
            self._last_upload_round[sender] = t
            if sender not in self._members:
                if self.secagg is not None \
                        and self.secagg.compromised(sender):
                    # A rank whose seeds are revealed (or mid-reveal):
                    # its current-round upload still FOLDS below if it
                    # holds a roster slot — arrival and correction are
                    # mutually exclusive, so the sum stays exact — but
                    # membership is gone for the epoch.
                    pass
                else:
                    self._members.add(sender)
                    self.readmissions += 1
                    self.flight.record("readmission", sender=sender,
                                       round=t, via="upload")
        if self.round_idx >= self.cfg.comm_round:
            # Terminal: a straggler's in-flight upload after the final
            # aggregation — release it.
            self._send_done(sender)
            return
        if t != self.round_idx:
            # Stale upload from an older round: discard the model, catch
            # the worker up on the current round — unless its seeds were
            # revealed while the upload was in flight, in which case it
            # is released for the epoch instead of reassigned.
            self.straggler_drops += 1
            self.flight.record("straggler_drop", sender=sender, round=t)
            if self.secagg is not None and self.secagg.compromised(sender):
                self._send_done(sender)
            else:
                self._send_assignment(sender)
            return
        payload = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        masked = bool(msg.get(wire_codec.SECAGG_MASKED_KEY))
        if masked and self.secagg is None:
            # A masked int64 frame against an unarmed server could only
            # ever fold as mask noise — the codec-refusal policy (evict
            # AND release) applies verbatim.
            self._refuse_upload(sender, t, "secagg_refusal",
                                "masked upload but secagg is not armed")
            return
        if masked and sender not in self.secagg.roster_for(t):
            # A masked frame from outside the round's sealed roster can
            # never cancel — protocol violation or a deep chaos
            # reordering. Drop the payload; the sender's beat routes it
            # through the waitroom.
            self.flight.record("secagg_nonroster_drop", sender=sender,
                               round=t)
            self.flight.dump()
            return
        codec = msg.get("compression")
        wcodec = msg.get(wire_codec.CODEC_KEY)
        # A stamped upload self-describes whether its payload is a delta
        # against this round's broadcast anchor. Legacy/unstamped frames
        # keep the historical contract (codec frames are deltas, raw
        # frames full models).
        is_delta = bool(msg.get(wire_codec.DELTA_KEY))
        tr = obs_trace.active()
        ck = obs_trace.corr(epoch=self.epoch, round=t, sender=sender)
        self._h_bytes.record(payload_nbytes(payload))
        depth = getattr(self.com_manager, "inbox_depth", None)
        if depth is not None:
            depth = depth()
            if depth is not None:
                self._g_queue.set(depth)
        if self._pool is not None:
            # Pooled ingest: the dispatch thread only does the accept
            # bookkeeping; decode + delta reconstruction + the exact
            # partial fold run on the pool, and the round flush barriers
            # on it.
            self._g_pool_queue.set(self._pool.queue_depth())
            self._submit_ingest(sender, t, payload, codec, wcodec,
                                float(msg.get(MSG_ARG_KEY_NUM_SAMPLES)), ck,
                                is_delta=is_delta, masked=masked,
                                clipped=int(msg.get("secagg_clipped") or 0))
            with self._lock:
                self._arrived.add(sender)
                ready = len(self._arrived) >= self._k_effective()
            if ready:
                self._complete_round()
            return
        if codec:
            # Dispatch on the frame's self-described codec, not a server
            # flag: per-rank launches may configure compression on the
            # clients only.
            t0 = time.perf_counter()
            with tr.span("ingest.decode", cat="ingest", corr=ck,
                         codec=codec):
                delta = self._legacy_decode(codec, payload)
                payload = self._anchor_add(delta)
            self._h_decode.record((time.perf_counter() - t0) * 1e3)
        elif wcodec:
            # Wire-codec frame: pickle-free numpy decode, and a REFUSAL
            # (not a crash, not a silent zero) on a corrupt/truncated
            # frame.
            t0 = time.perf_counter()
            try:
                with tr.span("ingest.decode", cat="ingest", corr=ck,
                             codec=wcodec):
                    delta = self._wire_decoders.decode(wcodec, payload,
                                                       self._spec)
                    payload = self._anchor_add(delta)
            except (wire_codec.CodecError, ValueError) as err:
                # A refusal means a mismatched/corrupt ENCODER — every
                # upload from that rank would refuse forever (resends
                # are bit-identical by frame_seed). Evict AND RELEASE the
                # worker, then complete the round over the survivors — or
                # abort when nobody remains.
                self._refuse_upload(sender, t, "codec_refusal", str(err),
                                    codec=str(wcodec))
                return
            self._h_decode.record((time.perf_counter() - t0) * 1e3)
        elif is_delta:
            # Raw tensor-framed delta: reconstruct against the round's
            # broadcast anchor.
            t0 = time.perf_counter()
            with tr.span("ingest.decode", cat="ingest", corr=ck,
                         codec="delta"):
                payload = self._anchor_add(payload)
            self._h_decode.record((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        with tr.span("ingest.fold", cat="ingest", corr=ck):
            self.aggregator.add_local_trained_result(
                sender - 1, payload, msg.get(MSG_ARG_KEY_NUM_SAMPLES)
            )
        self._h_fold.record((time.perf_counter() - t0) * 1e3)
        with self._lock:
            self._arrived.add(sender)
            ready = len(self._arrived) >= self._k_effective()
        if ready:
            self._complete_round()

    def _refuse_upload(self, sender: int, round_idx: int, kind: str,
                       error: str, **fields) -> None:
        """Evict AND RELEASE a rank whose upload can never fold (a corrupt
        encoder, a masked frame), then complete the round over the
        survivors — or abort when nobody remains."""
        self.codec_refusals += 1
        log.error("rank %d: upload refused (%s: %s) — evicting and "
                  "releasing the worker", sender, kind, error)
        self.flight.record(kind, sender=sender, round=round_idx,
                           error=error[:200], **fields)
        self._evict([sender])
        self.flight.dump()
        with self._lock:
            empty = not self._members
            ready = bool(self._arrived) and (
                len(self._arrived) >= self._k_effective())
        if empty:
            log.error("all workers refused/evicted at round %d: "
                      "abandoning the run", self.round_idx)
            self.aborted = True
        self._send_done(sender)  # release; finishes when empty
        if not empty and ready:
            self._complete_round()

    def _anchor_add(self, delta):
        """``broadcast anchor + delta`` on the card."""
        with capture_lock:
            return _tree_add(self._broadcast_net,
                             pytree.to_device(delta, self.aggregator.device))

    def _legacy_decode(self, codec: str, payload):
        """A legacy compressor frame (``core/compression.py``) → the delta
        in the net's form (CPU tensors)."""
        return _like(self.aggregator.net, self._decoder_for(codec).decode(
            payload, self._legacy_spec))

    def _decoder_for(self, codec: str):
        """Get-or-create the per-codec decoder under the lock. With the
        ingest pool armed, two workers can miss the cache for the same
        codec at once and construct twin compressors."""
        with self._lock:
            dec = self._decoders.get(codec)
            if dec is None:
                dec = self._decoders[codec] = compression.make_compressor(
                    codec)
        return dec

    def _submit_ingest(self, sender: int, round_idx: int, payload, codec,
                       wcodec, weight: float, ck, *,
                       is_delta: bool = False, masked: bool = False,
                       clipped: int = 0) -> None:
        """Build one upload's decode+fold task and hand it to the pool.
        The closure snapshots this round's broadcast anchor (its host
        copy: compressed uploads — and raw frames stamped delta — are
        deltas against it) so a late-running task cannot reconstruct
        against the NEXT round's net."""
        spec = self._spec
        task = upload_fold_task(
            payload, weight, self._host_of(self._broadcast_net),
            codec=codec, legacy_decode=self._legacy_decode, wcodec=wcodec,
            wire_decode=lambda w, p: self._wire_decoders.decode(w, p, spec),
            is_delta=is_delta, masked=masked,
            secagg_on=self.secagg is not None, clipped=clipped)

        # ck (the correlation key) already carries epoch/round/sender —
        # the span args double as the failure metadata _settle_pool reads.
        self._pool.submit(task, **ck)

    def _settle_pool(self) -> bool:
        """Round-flush barrier on the ingest pool. Failed tasks (corrupt
        codec frames) get the refusal policy HERE — evict AND RELEASE,
        same as the inline path, just deferred to the barrier — and the
        round's readiness is re-checked over the survivors. Returns True
        when the round can complete now."""
        failures = self._pool.drain()
        for meta, err in failures:
            sender = int(meta.get("sender", -1))
            self.codec_refusals += 1
            log.error("rank %d: pooled ingest refused (%s) — evicting and "
                      "releasing the worker (a mismatched encoder can "
                      "never upload a usable model)", sender, err)
            self.flight.record("codec_refusal", sender=sender,
                               round=meta.get("round"),
                               error=str(err)[:200])
            with self._lock:
                self._arrived.discard(sender)
            self._evict([sender])
            self.flight.dump()
        with self._lock:
            empty = not self._members
            ready = bool(self._arrived) and (
                len(self._arrived) >= self._k_effective())
        if failures and empty:
            # Mark the abort BEFORE the releases below: sending the last
            # done finishes the server, and the flag must already be
            # truthful when run() returns.
            log.error("all workers refused/evicted at round %d: "
                      "abandoning the run", self.round_idx)
            self.aborted = True
        for meta, _ in failures:
            self._send_done(int(meta.get("sender", -1)))  # release
        return ready and not empty

    def _complete_round(self) -> None:
        if self._pool is not None and not self._settle_pool():
            return  # refusals thinned the round below readiness
        if self.secagg is not None and not self._secagg_precommit():
            return  # seed reveals in flight; _secagg_recheck re-enters
        with self._lock:
            arrived = sorted(self._arrived)
            self._arrived = set()
        with obs_trace.active().span(
                "round.commit", cat="round",
                corr=obs_trace.corr(epoch=self.epoch, round=self.round_idx),
                arrived=len(arrived)):
            if self._pool is not None:
                global_net = self.aggregator.aggregate_pooled(
                    [self._worker_slot(w) for w in arrived], self._pool,
                    envelope_check=(self._secagg_envelope_check
                                    if self.secagg is not None else None))
            else:
                global_net = self.aggregator.aggregate_from(
                    [self._worker_slot(w) for w in arrived])
        self.flight.record("round_commit", round=self.round_idx,
                           arrived=len(arrived))
        self._broadcast_net = global_net
        if (
            self.round_idx % self.cfg.frequency_of_the_test == 0
            or self.round_idx == self.cfg.comm_round - 1
        ):
            self.aggregator.test_on_server(self.round_idx)
        completed = self.round_idx
        # Commit the round under the lock: the watchdog keys deadlines
        # and ticks off _round_snapshot() and must never see a torn
        # increment.
        with self._lock:
            self.round_idx += 1
        extra: List[int] = []
        if self.secagg is not None:
            extra = self._secagg_commit_tail(arrived)
        self._log_round_health(completed, arrived)
        # Safe actuation boundary: knob mutations here shape the NEXT
        # round's window and deadlines, never a fold in flight.
        self._ctrl_boundary()
        if self._ckpt is not None and self.cfg.checkpoint_every and (
            self.round_idx % self.cfg.checkpoint_every == 0
        ):
            self._save_checkpoint(wait=False)
        if self.round_idx >= self.cfg.comm_round:
            for worker in arrived + extra:
                self._send_done(worker)
            return
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        for worker in arrived + extra:
            if self.secagg is not None and self.secagg.compromised(worker):
                # Arrived under a mid-reveal race: its round slot held
                # (the fold stayed exact) but the epoch releases it.
                self._send_done(worker)
                continue
            self._send_assignment(worker, client_indexes)

    def _log_round_health(self, round_idx: int, arrived) -> None:
        if self.metrics is None:
            return
        # Counters + the ingest registry snapshot (decode_ms_p50/p95,
        # fold_ms_*, bytes_per_upload_*, ingest_queue_depth) in one ctrl/
        # row per round.
        self.metrics.log({"arrived": len(arrived), **self.health(),
                          **self.registry.snapshot()},
                         step=round_idx, prefix="ctrl")


class FedAVGClientManager(ClientManager):
    """Worker process: local training of the assigned client's shard on
    the card (FedAvgClientManager.py:34-79). Control-plane duties: adopt
    the server's epoch (resetting the round dedupe on a restart), drop
    duplicated assignments by round tag, beat every ``beat_interval_s``
    while training keeps the upload path silent, and self-terminate after
    ``idle_timeout_s`` without server contact.

    ``local_train(net, x, y, mask, rng) -> (net', loss)`` runs on the
    device of ``train_fed`` (a ``CapturedStep`` from
    :func:`build_federation_setup`); the call, the delta and the host
    copies of what leaves the silo run under ``capture_lock``."""

    def __init__(self, args, rank: int, size: int, train_fed: FederatedArrays,
                 local_train, cfg: FedConfig, backend: str = "LOOPBACK",
                 compress: str = "none", wire_codec_spec: str = "none", *,
                 beat_interval_s: Optional[float] = None,
                 idle_timeout_s: float = 0.0):
        super().__init__(args, rank=rank, size=size, backend=backend)
        self.train_fed = train_fed
        self.local_train = local_train
        self.cfg = cfg
        self.round_idx = 0
        self.epoch = 0
        self.duplicate_drops = 0
        self.upload_resends = 0
        self._last_handled = -1
        self.device = train_fed.device if train_fed is not None else None
        self._counts = (train_fed.counts.cpu().numpy()
                        if train_fed is not None else None)
        # Wire codec (comm/codec.py): the REQUESTED spec, resolved against
        # the server's handshake offer on the first assignment. Validated
        # eagerly — a typo must fail at construction, not at the first
        # upload.
        if wire_codec_spec not in ("", "none") and compress not in ("",
                                                                    "none"):
            raise ValueError(
                "compress and wire_codec are mutually exclusive (both "
                "would compress the same upload)")
        wire_codec.make_wire_codec(wire_codec_spec)
        self._codec_requested = wire_codec_spec or "none"
        self._codec = None  # set by negotiation on the first assignment
        self._delta_ok = False  # ditto (the delta capability)
        # Secure aggregation (comm/secagg.py, cfg.secagg): the DH state
        # is built lazily per epoch on the first assignment. Masked
        # uploads ship the QUANTIZED fixed-point contribution, so the
        # legacy float compressors cannot compose — the wire codec family
        # can (the silo self-decodes its own frame onto the fixed grid
        # before masking).
        if getattr(cfg, "secagg", False) and compress not in ("", "none"):
            raise ValueError(
                "cfg.secagg masks the quantized fixed-point upload; the "
                "legacy on-device compressor produces float frames "
                f"(compress={compress!r}) — use wire_codec instead")
        self._secagg: Optional[secagg_mod.SecAggClient] = None
        self._secagg_roster: Optional[List[int]] = None
        self._mask_decoders = wire_codec.CodecCache()
        # The last upload message, kept until the NEXT round's assignment
        # arrives: a RESEND-flagged re-assignment of the round we already
        # trained means our upload was lost in transit — resend it
        # instead of dropping the assignment. One message of memory; the
        # server's per-worker round high-water mark makes resends
        # idempotent.
        self._last_upload: Optional[Message] = None
        # Upload destination: rank 0 unless the assignment stamps a shard
        # rank (the sharded aggregation plane, comm/shardplane.py).
        # Control traffic — heartbeats — always goes to rank 0.
        self._upload_to = 0
        self._compressor = compression.make_compressor(compress)
        self._beats = HeartbeatSender(
            self._send_beat,
            interval_s=(cfg.heartbeat_interval_s if beat_interval_s is None
                        else beat_interval_s),
            idle_timeout_s=idle_timeout_s,
            on_idle=self._idle_quit)
        # Latest top-k error-feedback residual: (round, client, residual),
        # applied only when this rank trains the SAME client in the
        # IMMEDIATELY next round (a stale carry would spike against a
        # much-evolved model, and one client's carry must never leak into
        # another's update).
        self._ef_state: Optional[tuple] = None
        # Dropped-carry visibility: each increment is one round whose
        # compression error correction was discarded.
        self.ef_carry_drops = 0

    def run(self) -> None:
        self._beats.start()
        super().run()

    def finish(self) -> None:
        self._beats.stop()
        super().finish()

    def _send_beat(self) -> None:
        msg = Message(MSG_TYPE_C2S_HEARTBEAT, self.rank, 0)
        msg.add("epoch", self.epoch)
        self.send_message(msg)

    def _idle_quit(self) -> None:
        log.warning("rank %d: no server contact for %.1fs — exiting",
                    self.rank, self._beats.idle_timeout_s)
        self.finish()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init
        )
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            self.handle_message_receive_model_from_server,
        )
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SECAGG_ROSTER, self._handle_secagg_roster)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SEED_REVEAL, self._handle_seed_reveal)

    def handle_message_init(self, msg: Message) -> None:
        self._handle_assignment(msg)

    def handle_message_receive_model_from_server(self, msg: Message) -> None:
        self._handle_assignment(msg)

    def _handle_assignment(self, msg: Message) -> None:
        self._beats.touch()
        ep = msg.get("epoch")
        if ep is not None:
            ep = int(ep)
            if ep < self.epoch:
                return  # straggler message from a dead server epoch
            if ep > self.epoch:
                # Server restarted: adopt its epoch and reset the round
                # dedupe — the restored run legitimately replays rounds.
                # The cached upload died with the old epoch.
                self.epoch = ep
                self._last_handled = -1
                self._last_upload = None
                # New incarnation, new pair-key mesh: the old DH state
                # (and its round rosters) died with the old epoch.
                self._secagg = None
                self._secagg_roster = None
        if msg.get("done"):
            self.finish()
            return
        sr = msg.get(MSG_ARG_KEY_SHARD_RANK)
        if sr is not None and int(sr) != self._upload_to:
            # Sharded plane routing (first stamp, or a re-route after a
            # shard eviction). The cached upload re-targets too: a
            # resend-flagged re-assignment after its shard died must
            # re-ship to the SURVIVING shard, not the corpse.
            self._upload_to = int(sr)
            if self._last_upload is not None:
                self._last_upload.receiver_id = self._upload_to
                self._last_upload.add(Message.MSG_ARG_KEY_RECEIVER,
                                      self._upload_to)
        if getattr(self.cfg, "secagg", False):
            # Capability stage: a masked upload against a secagg-
            # ignorant server would fold mask noise into the mean —
            # refuse loudly (comm/codec.py).
            wire_codec.require_secagg_peer(
                msg.get(wire_codec.SECAGG_OK_KEY), peer="server")
            if self._secagg is None:
                self._secagg = secagg_mod.SecAggClient(self.rank,
                                                       self.epoch)
            roster = msg.get("secagg_roster")
            if self._secagg.pair_keys is None or roster is None:
                # Setup incomplete on one side or the other: publish the
                # pk and DEFER the round — no _last_handled bump, so the
                # roster-stamped re-send of this same round still
                # processes; chaos duplicates of the pk are idempotent.
                self._send_secagg_pk()
                return
            roster = [int(x) for x in roster]
            if self.rank not in roster:
                # Defensive: a roster that excludes us means our slot is
                # sealed elsewhere — masking against it could never
                # cancel. Sit the round out; the server's waitroom
                # re-admits us at the next commit.
                log.warning("rank %d: round %s roster %s excludes us — "
                            "sitting out until re-rostered", self.rank,
                            msg.get("round"), roster)
                return
            self._secagg_roster = roster
        # The server's round tag, not a local counter: under first-k
        # aggregation a straggler can be reassigned past skipped rounds.
        tag = msg.get("round")
        if tag is not None:
            t = int(tag)
            if t <= self._last_handled:
                if (t == self._last_handled and msg.get("resend")
                        and self._last_upload is not None):
                    # Resend-flagged re-assignment of the round we
                    # already trained: our upload was lost in transit.
                    self.upload_resends += 1
                    self.send_message(self._last_upload)
                    return
                # Transport duplicate of a handled assignment.
                self.duplicate_drops += 1
                return
            self._last_handled = t
            self.round_idx = t
        else:
            self.round_idx += 1
        if self._codec is None:
            # Negotiate once per connection, on the first live assignment
            # (loud fallback to the uncompressed wire, comm/codec.py).
            self._codec = wire_codec.negotiated_codec(
                self._codec_requested, msg.get(wire_codec.OFFER_KEY),
                peer="server")
            # Delta capability: compressed/codec uploads ship DELTAS
            # against the broadcast anchor — a server that never
            # advertised delta acceptance would mis-fold them as full
            # models, so REFUSE loudly instead of corrupting the global.
            self._delta_ok = bool(msg.get(wire_codec.DELTA_OK_KEY))
            if (self._compressor.name != "none"
                    or self._codec.name != "none"):
                wire_codec.require_delta_peer(self._delta_ok, peer="server")
        self._train(msg.get(MSG_ARG_KEY_MODEL_PARAMS), msg.get(MSG_ARG_KEY_CLIENT_INDEX))

    # -- secure aggregation (comm/secagg.py) --------------------------------
    def _send_secagg_pk(self) -> None:
        out = Message(MSG_TYPE_C2S_SECAGG_PK, self.rank, 0)
        out.add("epoch", self.epoch)
        out.add("pk", int(self._secagg.pk))
        self.send_message(out)

    def _handle_secagg_roster(self, msg: Message) -> None:
        self._beats.touch()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            # Either a dead incarnation's roster, or one that OUTRAN the
            # assignment that adopts its epoch — drop; the server's
            # beat-driven redrive re-sends it once we catch up.
            return
        if self._secagg is None:
            return
        pks = dict(zip([int(r) for r in msg.get("pk_ranks")],
                       [int(v) for v in msg.get("pk_vals")]))
        row = self._secagg.build_shares(
            pks, int(msg.get("t")),
            [int(u) for u in msg.get("universe")])
        out = Message(MSG_TYPE_C2S_SECAGG_SHARES, self.rank, 0)
        out.add("epoch", self.epoch)
        out.add("row_holders", sorted(row))
        out.add("row_ciphers", [int(row[h]) for h in sorted(row)])
        self.send_message(out)

    def _handle_seed_reveal(self, msg: Message) -> None:
        self._beats.touch()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            return  # stale-epoch ask; the live epoch re-asks with its own cipher
        target = int(msg.get("target"))
        if self._secagg is None or self._secagg.pair_keys is None \
                or target not in self._secagg.pair_keys:
            return
        share = self._secagg.reveal_share(target, int(msg.get("cipher")))
        out = Message(MSG_TYPE_C2S_SEED_SHARE, self.rank, 0)
        out.add("epoch", self.epoch)
        out.add("round", msg.get("round"))
        out.add("target", target)
        out.add("share", int(share))
        self.send_message(out)

    def _masked_contribution(self, host, global_net, c: int, codec):
        """The masked upload body: quantize this round's contribution
        onto the server pool's EXACT fixed-point grid — by running the
        identical decode+fold arithmetic the unmasked server path runs,
        so masked ≡ unmasked is bit-equality by construction, not by
        reimplementation — then add the pairwise masks. ``host`` is the
        host copy of the trained net, or of its delta when a codec
        runs; ``global_net`` the assignment's host tree."""
        w = float(self._counts[c])
        acc = PartialAccumulator()
        if codec is not None:
            payload, residual = codec.encode(
                host, self._carry(c),
                wire_codec.frame_seed(self.cfg.seed, self.epoch,
                                      self.round_idx, c))
            self._ef_state = (self.round_idx, c, residual)
            # Self-decode the frame we WOULD have shipped in the clear:
            # the server's unmasked fold is decode → w·(anchor + deltâ)
            # on the fixed grid, so fold the DECODED tree, not the raw
            # delta.
            dhat = self._mask_decoders.decode(codec.name, payload,
                                              wire_codec.tree_spec(global_net))
            acc.add([pytree.np_leaf(l) for l in sorted_leaves(dhat)], w,
                    base=[pytree.np_leaf(a)
                          for a in sorted_leaves(global_net)])
        else:
            acc.add([pytree.np_leaf(l) for l in sorted_leaves(host)], w)
        leaves = self._secagg.mask(acc.leaves, self.round_idx,
                                   self._secagg_roster)
        return leaves, acc.saturated

    def _carry(self, c: int):
        """The error-feedback carry for client ``c`` this round (or
        None), counting a dropped one."""
        prev = self._ef_state
        carry = (prev[2] if prev and prev[0] == self.round_idx - 1
                 and prev[1] == c else None)
        if prev is not None and carry is None and prev[2] is not None:
            self.ef_carry_drops += 1
        return carry

    def _train(self, global_net, client_index: int) -> None:
        c = int(client_index)
        tr = obs_trace.active()
        ck = obs_trace.corr(epoch=self.epoch, round=self.round_idx,
                            sender=self.rank)
        codec = (self._codec if self._codec is not None
                 and self._codec.name != "none" else None)
        legacy = self._compressor.name != "none"
        masked = self._secagg is not None and bool(self._secagg_roster)
        out = Message(MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank,
                      self._upload_to)
        with tr.span("client.train", cat="client", corr=ck, client=c):
            with capture_lock:
                rng = keys.fold_in(keys.fold_in(
                    keys.key(self.cfg.seed, self.device), self.round_idx), c)
                start = pytree.to_device(global_net, self.device)
                net, loss = self.local_train(
                    start, self.train_fed.x[c], self.train_fed.y[c],
                    self.train_fed.mask[c], rng)
                # The host copies and the device delta are taken before
                # the lock is released: the next replay overwrites the
                # captured step's outputs.
                t_ser = tr.now()
                if masked:
                    host = pytree.host_tree(_tree_sub(net, start)
                                            if codec is not None else net)
                elif legacy:
                    payload, residual = self._compressor.encode(
                        _as_dict(_tree_sub(net, start)), self._carry(c),
                        keys.fold_in(rng, 0xC0))
                    out.add("compression", self._compressor.name)
                elif codec is not None:
                    delta = pytree.host_tree(_tree_sub(net, start))
                else:
                    payload = pytree.host_tree(net)
                loss = float(loss)
        if masked:
            with tr.span("secagg.mask", cat="secagg", corr=ck, client=c):
                leaves, clipped = self._masked_contribution(
                    host, global_net, c, codec)
            out.add(MSG_ARG_KEY_MODEL_PARAMS, leaves)
            out.add(wire_codec.SECAGG_MASKED_KEY, True)
            out.add(wire_codec.DELTA_KEY, False)
            out.add("secagg_clipped", int(clipped))
        else:
            if codec is not None:
                # Frame seed keyed on (run seed, epoch, round, client):
                # deterministic — a cached RESEND re-ships identical bytes
                # — and fresh per round for the stochastic rounding /
                # mask expansion.
                payload, residual = codec.encode(
                    delta, self._carry(c),
                    wire_codec.frame_seed(self.cfg.seed, self.epoch,
                                          self.round_idx, c))
                out.add(wire_codec.CODEC_KEY, codec.name)
            if legacy or codec is not None:
                self._ef_state = (self.round_idx, c, residual)
            out.add(MSG_ARG_KEY_MODEL_PARAMS, payload)
            out.add(wire_codec.DELTA_KEY, legacy or codec is not None)
        if tr.enabled:
            # delta + encode (or the plain host copy) — the client half
            # of the upload lifecycle, correlated with the server's
            # ingest.decode/ingest.fold spans by (epoch, round, sender).
            tr.complete("client.serialize", t_ser, cat="client", corr=ck,
                        client=c)
        out.add(MSG_ARG_KEY_NUM_SAMPLES, int(self._counts[c]))
        out.add("round", self.round_idx)
        out.add("epoch", self.epoch)
        if masked:
            # The masked run's contract is "the server learns only the
            # sum" — a clear per-client train loss alongside would leak
            # exactly the per-client signal the masks hide (same rule as
            # DP below).
            pass
        elif not (self.cfg.dp_clip and self.cfg.dp_clip > 0):
            # Under DP-SGD the exact train loss is an un-noised function of
            # the private examples; releasing it would void the accounted
            # (eps, delta). Only the noised model leaves the silo.
            out.add("train_loss", loss)
        self._last_upload = out
        self.send_message(out)


def build_federation_setup(model, train_fed: FederatedArrays, test_global,
                           cfg: FedConfig, backend: str, loss_fn,
                           chaos: Optional[ChaosSpec] = None,
                           loopback_wire: str = "none",
                           pretrained_params=None,
                           extra_ranks: int = 0):
    """Shared worker-process scaffolding for the message-passing
    federation: model fns + initial net, the silos' captured local step
    and the server's eval, and the backend ``args`` shim (``chaos``
    installs a fleet-wide ChaosTransport wrapper; ``loopback_wire`` makes
    the LOOPBACK backend round-trip every message through that real wire
    format — bytes in the inboxes, ByteLedger counters live).

    Everything lives on ``train_fed.device``, where ``model`` must lie.
    The initial net is ``model``'s own parameters; ``pretrained_params``
    (a ``{name: tensor or array}`` dict of the same keys and shapes)
    replaces them (the dense warm start). With ``cfg.adapter_rank > 0``
    the net is the adapter tree alone, fresh from a generator seeded with
    ``cfg.seed`` (A ~ N(0, 0.02), B = 0: the exact base), over the frozen
    base that ``model`` is; ``pretrained_params`` is then the base's state
    dict (structure-checked), and ``args.adapter_holder`` is
    ``{"base": model}``.

    The local step is one :class:`core.graph.CapturedStep` (JAX:
    ``jax.jit``): captured on its first call on a CUDA device, replayed
    after, eager on the CPU.

    ``extra_ranks`` widens the rank space for non-worker processes — the
    sharded aggregation plane's M aggregator shards at ranks ``1..M``
    (comm/shardplane.py), with workers shifted to ``M+1..size-1``.
    Returns ``(size, net0, local_train, eval_fn, args)``."""
    size = cfg.client_num_per_round + 1 + int(extra_ranks)
    if getattr(cfg, "compute_layout", "none") not in ("none", ""):
        # The message-passing tiers build their local trainer here,
        # outside FedAvgAPI._build_local_train where the layouts are
        # wired — refuse loudly rather than leave the flag inert.
        raise NotImplementedError(
            f"cfg.compute_layout={cfg.compute_layout!r} is a simulator-"
            "tier capability (FedAvgAPI family); the distributed "
            "message-passing tiers do not wire it yet")
    if getattr(cfg, "client_step_dtype", "fp32") not in ("fp32", ""):
        raise NotImplementedError(
            f"cfg.client_step_dtype={cfg.client_step_dtype!r} is a "
            "simulator-tier capability (FedAvgAPI family); the "
            "distributed message-passing tiers train fp32")
    if getattr(cfg, "group_reduce", False):
        raise NotImplementedError(
            "cfg.group_reduce shrinks the client-MESH collective "
            "(parallel/shard.py); the message-passing tiers aggregate "
            "on the server host — drop the flag")
    device = train_fed.device
    adapter_holder = None
    if int(getattr(cfg, "adapter_rank", 0) or 0):
        # Frozen-base adapter finetuning (models/adapter.py): the
        # federation's net — on the wire, in the server's accumulator, in
        # the codecs' tree_spec — is the ADAPTER tree alone, its leaves in
        # the JAX package's order (core/tree.sorted_flatten). The base is
        # the model itself, built once a process (from its generator, or
        # from ``pretrained_params``, structure-checked); the captured
        # step reads it in place as constants, so every silo of the
        # process shares its one device copy. It never crosses the wire.
        # adapter_model_fns refuses a dense model loudly.
        from fedml_tpu_torch.models.adapter import adapter_model_fns

        fns = adapter_model_fns(model, base_params=pretrained_params)
        adapter_holder = fns.holder
        net0 = fns.init(torch.Generator().manual_seed(int(cfg.seed)))
    else:
        fns = model_fns(model)
        net0 = fns.init()
    if pretrained_params is not None and adapter_holder is None:
        # Dense warm start: same keys and shapes or refuse — a silently
        # reshaped warm start would train the wrong geometry.
        want = {k: tuple(v.shape) for k, v in net0.params.items()}
        got = {k: tuple(np.shape(v)) for k, v in pretrained_params.items()}
        if want != got:
            raise ValueError(
                f"pretrained_params structure {got} does not match the "
                f"model's param tree {want}")
        net0 = NetState(pytree.to_device(
            {k: pretrained_params[k] for k in net0.params}, device),
            net0.model_state)
    optimizer = make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd)
    local_train = CapturedStep(
        make_local_train_fn_from_cfg(fns.apply, optimizer, cfg,
                                     loss_fn=loss_fn), device, lambda: [])
    eval_fn = make_eval_fn(fns.apply, loss_fn=loss_fn) if test_global else None

    class Args:
        pass

    args = Args()
    args.chaos = chaos
    # None for dense federations; adapter mode's {"base": the frozen
    # module} — drills pin the base's bitwise invariance through it, and
    # the runners stamp it onto the returned server/aggregator.
    args.adapter_holder = adapter_holder
    if backend == "LOOPBACK":
        args.network = LoopbackNetwork(size, wire=loopback_wire)
    elif backend == "SIM":
        # Virtual-clock fleet simulation: the FleetSimulator installs
        # args.network (a sim.transport.SimNetwork) and args.chaos_after
        # (the event-queue scheduler for ChaosTransport's timers) itself
        # before constructing the managers.
        pass
    elif backend == "TCP":
        # Single-host table on ephemeral ports: bind rank servers first
        # (port 0), then share the resolved table. Multi-host deployments
        # pass an explicit host_table instead.
        args.host_table = {r: ("127.0.0.1", 0) for r in range(size)}
    return size, net0, local_train, eval_fn, args


def FedML_FedAvg_distributed(
    model,
    train_fed: FederatedArrays,
    test_global,
    cfg: FedConfig,
    backend: str = "LOOPBACK",
    loss_fn=softmax_ce,
    compress: str = "none",
    aggregate_k: int = 0,
    *,
    wire_codec: str = "none",
    loopback_wire: str = "none",
    aggregator: str = "mean",
    chaos: Optional[ChaosSpec] = None,
    checkpoint_dir: Optional[str] = None,
    metrics=None,
    idle_timeout_s: float = 0.0,
    trace_dir: Optional[str] = None,
    pretrained_params=None,
    agg_shards: int = 0,
    directory=None,
    controller=None,
    device=None,
):
    """Build server + ``client_num_per_round`` workers on the chosen backend
    and run the full federation (FedAvgAPI.py:20 analogue) as threads of
    this process. Returns the aggregator (global model + test history),
    stamped with the server's final ``health()`` and ``ingest_profile()``
    and the silos' captured step (``local_train``).

    ``device`` (``None`` → cuda; ``"cpu"`` as the tests ask) is where the
    silos train and the server folds and evaluates; ``train_fed``,
    ``test_global`` and ``model`` must lie there.

    ``compress``: legacy update compression for the client→server uploads
    — ``none`` | ``topk<ratio>`` (error feedback) | ``q<bits>``
    (stochastic quantization); see ``core/compression.py``.

    ``wire_codec``: the NEGOTIATED wire codec (comm/codec.py) — ``none``
    | ``bf16`` | ``fp16`` | ``int8`` | ``topk<ratio>`` |
    ``randmask<ratio>``, composable as ``sparsifier+value`` (e.g.
    ``topk0.01+int8``); sparsifiers carry per-client error feedback.
    Mutually exclusive with ``compress``. ``loopback_wire`` round-trips
    loopback messages through a real wire format (bytes + ByteLedger).

    ``aggregator``: server reduction (core/robust_agg spec). ``mean``
    keeps the O(model) accumulate-on-arrival streaming ingest; non-mean
    robust aggregators retain the stack-then-reduce cohort buffer.

    ``aggregate_k``: straggler-tolerant first-k rounds (0 = wait for all
    workers; see FedAVGServerManager).

    Control plane: ``cfg.round_timeout_s`` arms the eviction watchdog,
    ``cfg.heartbeat_interval_s`` the worker beats, ``cfg.checkpoint_every``
    + ``checkpoint_dir`` crash-resume, ``chaos`` a fleet-wide
    fault-injecting transport wrapper, ``metrics`` a MetricsLogger for
    per-round health counters, ``idle_timeout_s`` the workers'
    no-server-contact self-termination bound, ``trace_dir`` the span
    tracer and flight recorder's dumps. ``cfg.secagg`` (with
    ``ingest_workers`` or ``agg_shards`` > 0) masks every upload
    (comm/secagg.py).

    ``agg_shards`` = M > 0 stands up the SHARDED aggregation plane
    (comm/shardplane.py): M aggregator-shard managers at ranks ``1..M``
    ingest the uploads (workers shifted to ``M+1..``), and the rank-0
    coordinator wire-merges their int64 fixed-point partials bit-equal to
    the single-process IngestPool path. ``directory`` (an optional
    data.directory.ClientDirectory) folds data-shard locality into the
    client→shard routing. ``controller`` (a ``ctrl.FederationController``)
    steps at the server's between-rounds boundary."""
    M = int(agg_shards or (getattr(cfg, "agg_shards", 0) or 0))
    device = check_device(train_fed, device)
    size, net0, local_train, eval_fn, args = build_federation_setup(
        model, train_fed, test_global, cfg, backend, loss_fn, chaos=chaos,
        loopback_wire=loopback_wire, pretrained_params=pretrained_params,
        extra_ranks=M)
    agg = FedAVGAggregator(net0, size - 1 - M, cfg, eval_fn, test_global,
                           aggregator=aggregator, device=device)
    shards = []
    if M > 0:
        from fedml_tpu_torch.comm.shardplane import (
            AggregatorShardManager, ShardedFedAVGServerManager)

        server = ShardedFedAVGServerManager(
            args, agg, cfg, size, M, backend=backend,
            aggregate_k=aggregate_k, checkpoint_dir=checkpoint_dir,
            metrics=metrics, flight_dir=trace_dir, directory=directory)
        shards = [
            AggregatorShardManager(args, rank, size, cfg, net0,
                                   backend=backend)
            for rank in range(1, M + 1)
        ]
    else:
        server = FedAVGServerManager(args, agg, cfg, size, backend=backend,
                                     compress=compress,
                                     aggregate_k=aggregate_k,
                                     checkpoint_dir=checkpoint_dir,
                                     metrics=metrics, flight_dir=trace_dir)
    if controller is not None:
        # Adaptive control (ctrl/policy.py): steps from the server's
        # between-rounds boundary; the same object may have been tuned
        # in the fleet simulator first.
        server.attach_controller(controller)
    clients = [
        FedAVGClientManager(args, rank, size, train_fed, local_train, cfg,
                            backend=backend, compress=compress,
                            wire_codec_spec=wire_codec,
                            idle_timeout_s=idle_timeout_s)
        for rank in range(M + 1, size)
    ]
    with obs_trace.tracing_to(trace_dir):
        run_workers([server.run] + [sh.run for sh in shards]
                    + [c.run for c in clients])
    # Post-run observability: the managers are finished but callers still
    # need the control-plane counters, ByteLedger totals and the ingest
    # latency profile — stamp the final snapshots onto the aggregator.
    agg.final_health = server.health()
    agg.ingest_profile = server.ingest_profile()
    agg.adapter_holder = args.adapter_holder
    agg.local_train = local_train
    return agg
