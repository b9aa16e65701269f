"""Asynchronous federated learning (FedAsync-style) over the comm layer
(port of ``fedml_tpu/algos/fedasync.py``).

The reference's server blocks until EVERY sampled worker has uploaded
before it aggregates (check_whether_all_receive,
fedml_api/distributed/fedavg/FedAVGAggregator.py:50-57), so one straggler
stalls the round for the whole fleet. Here the server updates the global
model on EVERY arrival (Xie et al. 2019, "Asynchronous Federated
Optimization"):

    alpha_eff = alpha / (1 + staleness)^a
    global <- (1 - alpha_eff) * global + alpha_eff * client_net

where staleness = server_version - version_the_client_trained_on. Each
worker gets the fresh global back immediately and keeps training — no
barrier, no idle time. With one worker (or zero staleness and alpha = 1)
this degenerates to sequential SGD on shuffled client shards.

Message flow per worker is strictly request/response (upload -> new model
or done), which makes shutdown deterministic: the server answers every
in-flight upload, so no rank can block on a model that never comes — as
long as every worker LIVES to upload once more. With ``done_timeout_s >
0`` the server runs the same heartbeat-driven bounded termination as the
synchronous control plane (``algos/fedavg_distributed.py``): workers beat,
silent ranks are evicted from the done-wait, and the run always ends.

Where the work runs, as on the synchronous tier: a worker's local training
is the process's ONE captured step from
:func:`~fedml_tpu_torch.algos.fedavg_distributed.build_federation_setup`,
replayed under ``core.graph.capture_lock`` with the host copy of what
leaves the worker; the server mixes each arrival into the global on the
card (JAX ``jit``\\ s ``_mix``) and evaluates there, under the same lock;
the wire, the codecs and the ingest pool are numpy on the host.

An adaptive controller (``controller=``, ``ctrl/policy.py``) steps from
the server's safe boundary after each model version. Secure aggregation
and the sharded plane are refused in the JAX package's words: they are
synchronous-FedAvg capabilities.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Set

import numpy as np

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos import fedavg_distributed
from fedml_tpu_torch.algos.fedavg_distributed import (
    MSG_ARG_KEY_CLIENT_INDEX,
    MSG_ARG_KEY_MODEL_PARAMS,
    MSG_ARG_KEY_NUM_SAMPLES,
    MSG_TYPE_C2S_HEARTBEAT,
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
    MSG_TYPE_S2C_INIT_CONFIG,
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
    MSG_TYPE_SRV_TICK,
    check_device,
)
from fedml_tpu_torch.comm import codec as wire_codec
from fedml_tpu_torch.comm import pytree
from fedml_tpu_torch.comm.loopback import run_workers
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.resilience import ChaosSpec, HeartbeatSender
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.faults import HeartbeatMonitor
from fedml_tpu_torch.core.graph import capture_lock
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.core.tree import sorted_tree_map
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.obs.registry import MetricsRegistry, payload_nbytes
from fedml_tpu_torch.trainer.local import softmax_ce

MSG_ARG_KEY_MODEL_VERSION = "model_version"
# Strictly increasing per-worker assignment id, echoed in uploads: the
# dedupe key on BOTH ends (the model version cannot serve — the buffered
# tier re-assigns at an unchanged version until the buffer flushes).
MSG_ARG_KEY_TASK_SEQ = "task_seq"

log = logging.getLogger(__name__)


def staleness_weight(alpha: float, staleness: int, a: float = 0.5) -> float:
    """Polynomial staleness discount: alpha / (1 + s)^a."""
    return alpha / float((1 + max(staleness, 0)) ** a)


class FedAsyncServerManager(ServerManager):
    """Mixes every arriving model into the global immediately; the model
    version counts server updates (the async analogue of the round index).

    ``net`` (a ``NetState`` or a dict of arrays or tensors) is held as
    tensors on ``device`` (``None`` → cuda); messages carry its host copy,
    made once per version."""

    #: Negotiated delta capability (comm/codec.py DELTA_OK_KEY): whether
    #: this server's ``_ingest`` folds uploads as DELTAS against the
    #: model the client pulled. The pure-async mix consumes FULL models;
    #: the buffered subclass (fedbuff.py) consumes deltas. A stamped
    #: upload whose framing mismatches is REFUSED (evict-and-release)
    #: instead of mis-folded.
    _accepts_delta_frames = False

    def __init__(self, args, net, cfg: FedConfig, size: int,
                 backend: str = "LOOPBACK", alpha: float = 0.6,
                 staleness_exp: float = 0.5, eval_fn=None, test_data=None,
                 *, done_timeout_s: Optional[float] = None,
                 metrics=None, flight_dir: Optional[str] = None,
                 clock=time.monotonic, directory=None, device=None):
        super().__init__(args, rank=0, size=size, backend=backend)
        # Optional data.directory.ClientDirectory: client assignment draws
        # from its count metadata instead of the flat sample_clients law.
        self._directory = directory
        self._cohort_cache = None  # (version, sampled ids) memo
        self.device = resolve_device(device)
        self.net = pytree.to_device(net, self.device)
        self.cfg = cfg
        self.alpha = alpha
        self.staleness_exp = staleness_exp
        self.eval_fn = eval_fn
        self.test_data = test_data
        self.version = 0
        self.codec_refusals = 0
        self._spec = wire_codec.tree_spec(self.net)
        self._wire_decoders = wire_codec.CodecCache()  # spec → WireCodec
        self._host_cache = None
        self.staleness_history: List[int] = []
        # Recent OFFERED staleness (admitted or not), bounded: the
        # windowed guard-band signal for an adaptive controller.
        self._stale_recent: Deque[int] = collections.deque(maxlen=64)
        # Accepted-upload order, (worker, base_version) per arrival.
        self.arrival_log: List[tuple] = []
        self.test_history: List[dict] = []
        self.evictions = 0
        self.duplicate_drops = 0
        self.reassignments = 0
        self.admission_drops = 0
        # Admission cap: an upload staler than this many versions is
        # refused at the door (still replied). 0 = unlimited, the default.
        self.max_staleness = 0
        # Stamped by the runners after the run: the final health().
        self.final_health: Dict[str, int] = {}
        self._members: Set[int] = set(range(1, size))
        self._done_set: Set[int] = set()
        # Per-worker high-water mark of the ASSIGNMENT SEQUENCE its uploads
        # answer: a repeat upload is dropped WITHOUT reply. Uploads without
        # the task key fall back to the version.
        self._last_upload_task: Dict[int, int] = {}
        self._task_seq: Dict[int, int] = {}
        # Wall-clock of each worker's last request/response progress: a
        # LOST reply leaves an alive-but-idle worker; beats from a worker
        # stalled past done_timeout_s get a fresh assignment.
        self._last_progress: Dict[int, float] = {}
        self._clock = clock
        self._lock = threading.Lock()
        self._stopped = False
        # Ingest observability: one ctrl/ row per model-version bump, the
        # flight recorder dumped on eviction/refusal, and the occupancy
        # clock of comm.managers.ServerManager.
        self.metrics = metrics
        self.registry = MetricsRegistry()
        self._h_decode = self.registry.histogram("decode_ms")
        self._h_fold = self.registry.histogram("fold_ms")
        self._h_bytes = self.registry.histogram("bytes_per_upload", lo=1.0)
        self._h_stale = self.registry.histogram("staleness", lo=1.0)
        self._g_queue = self.registry.gauge("ingest_queue_depth")
        shards = int(getattr(cfg, "agg_shards", 0) or 0)
        if shards > 0:
            # The sharded aggregation plane is a sync-FedAvg capability:
            # the sequential mix / global-arrival buffer has no associative
            # partition for M shards to merge.
            raise ValueError(
                f"agg_shards={shards} is a synchronous-FedAvg capability "
                "(comm/shardplane.py): the async tiers' sequential mix / "
                "global-arrival buffer cannot be partitioned across "
                "aggregator shards — run with agg_shards=0")
        if getattr(cfg, "secagg", False):
            # Pairwise masks only cancel inside ONE summed cohort whose
            # roster is pinned before anyone uploads; the async tiers have
            # none.
            raise ValueError(
                "secagg is a synchronous-FedAvg capability "
                "(comm/secagg.py): the async tiers have no "
                "roster-complete cohort sum for pairwise masks to cancel "
                "in — run with secagg disabled or the sync tier")
        # Parallel ingest pool (comm/ingest.py, cfg.ingest_workers > 0):
        # here it hosts only the numpy frame decode (the mix is
        # sequential, so any worker count is bit-equal to inline); the
        # buffered subclass defers decode AND fold into it.
        workers = int(getattr(cfg, "ingest_workers", 0) or 0)
        if workers > 0:
            from fedml_tpu_torch.comm.ingest import IngestPool

            self._pool = IngestPool(workers, registry=self.registry)
            self._g_pool_queue = self.registry.gauge(
                "ingest_pool_queue_depth")
        else:
            self._pool = None
        self.flight = obs_trace.FlightRecorder(
            clock=clock,
            path=(os.path.join(flight_dir, "flight_recorder.jsonl")
                  if flight_dir else None))
        self.done_timeout_s = (cfg.round_timeout_s if done_timeout_s is None
                               else done_timeout_s)
        self.heartbeat = HeartbeatMonitor(
            range(1, size), timeout_s=self.done_timeout_s or 30.0,
            clock=clock)
        # Actuation seam (fedml_tpu_torch.ctrl): the validated,
        # boundary-gated knob surface. Building it is inert — knobs move
        # only when something calls apply(). The mix weight is an argument
        # of every mix, so retuning alpha/staleness_exp costs nothing.
        from fedml_tpu_torch.ctrl.actuator import ActuationSeam, Knob

        knobs = [
            Knob("alpha", lambda: self.alpha,
                 lambda v: setattr(self, "alpha", v), 1e-6, 1.0),
            Knob("staleness_exp", lambda: self.staleness_exp,
                 lambda v: setattr(self, "staleness_exp", v), 0.0, 8.0),
            Knob("max_staleness", lambda: self.max_staleness,
                 lambda v: setattr(self, "max_staleness", v),
                 0, 1_000_000, cast=int),
        ]
        if self.done_timeout_s and self.done_timeout_s > 0:
            knobs.append(Knob(
                "done_timeout_s", lambda: self.done_timeout_s,
                self._set_done_timeout, 1e-3, 86400.0))
        if self._pool is not None:
            knobs.append(Knob(
                "ingest_workers", lambda: self._pool.workers,
                lambda v: self._pool.resize(v), 1, 64, cast=int,
                constraint=lambda v: ("pool_shrink_unsupported"
                                      if v < self._pool.workers else None)))
        self.ctrl = ActuationSeam(
            type(self).__name__, knobs, registry=self.registry,
            flight=self.flight, busy=self._ctrl_busy,
            progress=lambda: self.version)

    def _set_done_timeout(self, v: float) -> None:
        # The watchdog reads done_timeout_s live each pass; the heartbeat
        # monitor's silence threshold must track it.
        self.done_timeout_s = v
        self.heartbeat.timeout_s = v

    def _ctrl_busy(self) -> Optional[str]:
        """Seam busy probe: the pure-async tier is quiescent between
        handler invocations. The buffered subclass reports
        ``mid_flush``."""
        return None

    def _host_of(self, net):
        """The host copy of the global net that messages carry (the JAX
        package's implicit ``device_get`` on send), made once per net."""
        cached = self._host_cache
        if cached is not None and cached[0] is net:
            return cached[1]
        with capture_lock:
            host = pytree.host_tree(net)
        self._host_cache = (net, host)
        return host

    @property
    def done_workers(self) -> int:
        return len(self._done_set)

    def health(self) -> Dict[str, int]:
        """Control-plane counters + byte ledger — the async twin of the
        sync server's ``health()`` (``version`` is the async round index,
        ``reassignments`` the async analogue of re-admissions)."""
        ledger = getattr(self.com_manager, "bytes_ledger", None)
        with self._lock:
            return {
                "members": len(self._members),
                "evictions": self.evictions,
                "reassignments": self.reassignments,
                "duplicate_drops": self.duplicate_drops,
                "admission_drops": self.admission_drops,
                "codec_refusals": self.codec_refusals,
                "version": self.version,
                "done_workers": len(self._done_set),
                "send_retries": getattr(self.com_manager, "retry_count", 0),
                "bytes_tx": ledger.total_tx if ledger is not None else 0,
                "bytes_rx": ledger.total_rx if ledger is not None else 0,
            }

    def _log_round_health(self, staleness: int) -> None:
        """One ctrl/ row per model-version bump — the async "round", in
        the sync tier's schema."""
        if self.metrics is None:
            return
        self.metrics.log({**self.health(), **self.registry.snapshot(),
                          "staleness": staleness},
                         step=self.version, prefix="ctrl")

    def run(self) -> None:
        self.register_message_receive_handlers()
        with self._lock:
            members = sorted(self._members)
        for r in members:  # liveness clocks start when the run starts
            self.heartbeat.beat(r)
        self.send_init_msg()
        if self.done_timeout_s and self.done_timeout_s > 0:
            threading.Thread(target=self._watchdog_loop, daemon=True).start()
        self.com_manager.handle_receive_message()

    def finish(self) -> None:
        self._stopped = True
        if self._pool is not None:
            self._pool.close()
        super().finish()

    def _defer_decode(self) -> bool:
        """True when the pooled path defers the frame decode into its
        ingest task (the buffered tier) instead of decoding before
        ``_ingest``."""
        return False

    def _decode_upload(self, wcodec: str, payload, **meta):
        """Frame decode, routed through the ingest pool when one is
        configured; raises :class:`~fedml_tpu_torch.comm.codec.CodecError`
        either way."""
        if self._pool is None:
            return self._wire_decoders.decode(wcodec, payload, self._spec)
        return self._pool.run(
            lambda: self._wire_decoders.decode(wcodec, payload, self._spec),
            **meta)

    # -- bounded termination -------------------------------------------------
    def _watchdog_loop(self) -> None:
        poll = max(0.005, min(0.05, self.done_timeout_s / 10))
        while not self._stopped:
            with self._lock:
                members = sorted(self._members)
            if not members or self._version_snapshot() >= self.cfg.comm_round:
                failed = self.heartbeat.wait_all_or_failed(
                    members,
                    have=lambda: (members if self._stopped
                                  else self._done_snapshot()),
                    poll_s=poll, deadline_s=self.done_timeout_s)
                if not self._stopped and (failed or not members):
                    self._post_tick(failed)
            else:
                # Mid-run: ALL members dead means the version can never
                # reach comm_round — bound that too.
                failed = set(self.heartbeat.failed())
                if failed >= set(members):
                    self._post_tick(sorted(failed))
            time.sleep(poll)

    def _done_snapshot(self) -> List[int]:
        with self._lock:
            return sorted(self._done_set)

    def _version_snapshot(self) -> int:
        with self._lock:
            return self.version

    def _post_tick(self, failed) -> None:
        msg = Message(MSG_TYPE_SRV_TICK, 0, 0)
        msg.add("failed", [int(w) for w in failed])
        try:
            self.send_message(msg)
        except (ConnectionError, OSError):
            pass  # next watchdog pass re-ticks

    def _handle_tick(self, msg: Message) -> None:
        failed = set(msg.get("failed") or [])
        with self._lock:
            evict = [w for w in failed
                     if w in self._members and w not in self._done_set]
            for w in evict:
                self._members.discard(w)
                self.evictions += 1
        if evict:
            log.warning("async server: evicting silent ranks %s", evict)
            self.flight.record("eviction", ranks=evict,
                               version=self.version)
            self.flight.dump()
        self._maybe_finish()

    def _handle_heartbeat(self, msg: Message) -> None:
        worker = msg.get_sender_id()
        self.heartbeat.beat(worker)
        self.flight.record("beat", sender=worker)
        if not (self.done_timeout_s and self.done_timeout_s > 0):
            return
        if self.version >= self.cfg.comm_round:
            # The worker never got its done: re-send it.
            self._send_done(worker)
            return
        stalled = (self._clock() - self._last_progress.get(worker, 0.0)
                   > self.done_timeout_s)
        if stalled:
            # Alive but with no live assignment (a lost reply, or evicted
            # and back): fresh work at the CURRENT version.
            log.warning("async server: worker %d alive but idle past "
                        "done_timeout_s — re-assigning at version %d",
                        worker, self.version)
            self.reassignments += 1
            self.flight.record("reassignment", sender=worker,
                               version=self.version)
            self._send_assignment(worker, recovery=True)

    def _refuse_upload(self, worker: int, err, *, codec=None,
                       task_seq=None) -> None:
        """The async tiers' ONE evict-and-release refusal policy: a
        refusal is a deterministic encoder mismatch, so evict the worker
        and send done=True; the run finishes when no members remain."""
        self.codec_refusals += 1
        log.error("rank %d: codec %r frame refused (%s) — evicting and "
                  "releasing the worker (a mismatched encoder can never "
                  "upload a usable model)", worker, codec, err)
        fields = {"sender": worker, "error": str(err)[:200]}
        if task_seq is not None:
            fields["task_seq"] = task_seq
        if codec is not None:
            fields["codec"] = str(codec)
        self.flight.record("codec_refusal", **fields)
        with self._lock:
            if worker in self._members:
                self._members.discard(worker)
                self.evictions += 1
        self.flight.dump()
        self._send_done(worker)  # release; finishes when empty

    def _evict_dead(self, worker: int, err: BaseException, what: str) -> None:
        """A send failed past the retry policy: evict, guarded so repeated
        failures to an evicted rank don't inflate the counter."""
        log.warning("%s to worker %d failed (%s): evicting", what, worker, err)
        evicted = False
        with self._lock:
            if worker in self._members:
                self._members.discard(worker)
                self.evictions += 1
                evicted = True
        if evicted:
            self.flight.record("eviction", ranks=[worker],
                               version=self.version, what=what)
            self.flight.dump()

    def _send_done(self, worker: int) -> None:
        out = Message(MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, worker)
        out.add("done", True)
        try:
            self.send_message(out)
            with self._lock:
                self._done_set.add(worker)
        except (ConnectionError, OSError) as err:
            self._evict_dead(worker, err, "done")
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        with self._lock:
            done = self._done_set >= self._members
        if done and not self._stopped:
            self.finish()

    def _next_task(self, worker: int) -> int:
        with self._lock:
            seq = self._task_seq.get(worker, 0)
            self._task_seq[worker] = seq + 1
        return seq

    def _assign_client(self, worker: int) -> int:
        """Deterministic per-(version, worker) client assignment, from a
        ClientDirectory when one is attached; the cohort is memoized per
        version."""
        n = min(self.size - 1, self.cfg.client_num_in_total)
        cache = self._cohort_cache
        if cache is None or cache[0] != self.version:
            if self._directory is not None:
                idx = self._directory.sample_cohort(self.version, n)
            else:
                idx = sample_clients(self.version,
                                     self.cfg.client_num_in_total, n)
            cache = self._cohort_cache = (self.version, idx)
        return int(cache[1][(worker - 1) % len(cache[1])])

    def send_init_msg(self) -> None:
        for worker in range(1, self.size):
            msg = Message(MSG_TYPE_S2C_INIT_CONFIG, 0, worker)
            msg.add(MSG_ARG_KEY_MODEL_PARAMS, self._host_of(self.net))
            msg.add(MSG_ARG_KEY_CLIENT_INDEX, self._assign_client(worker))
            msg.add(MSG_ARG_KEY_MODEL_VERSION, 0)
            msg.add(MSG_ARG_KEY_TASK_SEQ, self._next_task(worker))
            msg.add(wire_codec.OFFER_KEY, wire_codec.codec_offer())
            msg.add(wire_codec.DELTA_OK_KEY, self._accepts_delta_frames)
            self._last_progress[worker] = self._clock()
            try:
                self.send_message(msg)
            except (ConnectionError, OSError) as err:
                # A silo dead at startup must not crash the server: the
                # survivors run the federation.
                self._evict_dead(worker, err, "init")
        self._maybe_finish()

    def _send_assignment(self, worker: int, *, recovery: bool = False) -> None:
        out = Message(MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, worker)
        out.add("done", False)
        out.add(MSG_ARG_KEY_MODEL_PARAMS, self._host_of(self.net))
        out.add(MSG_ARG_KEY_CLIENT_INDEX, self._assign_client(worker))
        out.add(MSG_ARG_KEY_MODEL_VERSION, self.version)
        out.add(MSG_ARG_KEY_TASK_SEQ, self._next_task(worker))
        out.add(wire_codec.OFFER_KEY, wire_codec.codec_offer())
        out.add(wire_codec.DELTA_OK_KEY, self._accepts_delta_frames)
        if recovery:
            # Stalled-worker recovery: tell the client which TASK we last
            # ACCEPTED from it, so a merely SLOW worker resends its cached
            # upload instead of training this extra assignment.
            out.add("recovery", True)
            with self._lock:
                out.add("expected", self._last_upload_task.get(worker, -1))
        self._last_progress[worker] = self._clock()
        try:
            self.send_message(out)
        except (ConnectionError, OSError) as err:
            self._evict_dead(worker, err, "assignment")
            self._maybe_finish()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.handle_upload)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_HEARTBEAT, self._handle_heartbeat)
        self.register_message_receive_handler(
            MSG_TYPE_SRV_TICK, self._handle_tick)

    def handle_upload(self, msg: Message) -> None:
        worker = msg.get_sender_id()
        self.heartbeat.beat(worker)
        with self._lock:
            if worker not in self._members:
                self._members.add(worker)  # returned after eviction
        if self.version >= self.cfg.comm_round:
            # Target reached while this upload was in flight: discard it
            # and release the worker.
            self._send_done(worker)
            return
        base_ver = int(msg.get(MSG_ARG_KEY_MODEL_VERSION))
        task = msg.get(MSG_ARG_KEY_TASK_SEQ)
        task = base_ver if task is None else int(task)
        with self._lock:
            if task <= self._last_upload_task.get(worker, -1):
                self.duplicate_drops += 1
                self.flight.record("duplicate_drop", sender=worker,
                                   task_seq=task)
                # Deliberate reply-less drop: the FIRST copy was answered.
                return
            self._last_upload_task[worker] = task
        # Negotiated delta capability: a STAMPED upload whose framing
        # mismatches what _ingest consumes is refused, never mis-folded.
        stamped_delta = msg.get(wire_codec.DELTA_KEY)
        if (stamped_delta is not None
                and bool(stamped_delta) != self._accepts_delta_frames):
            self._refuse_upload(worker, ValueError(
                f"upload framed {'delta' if stamped_delta else 'full-model'}"
                f" but this server ingests "
                f"{'deltas' if self._accepts_delta_frames else 'full models'}"
                " — negotiate the delta capability (DELTA_OK_KEY) or run "
                "the matching tier"), task_seq=task)
            return
        tr = obs_trace.active()
        ck = obs_trace.corr(round=self.version, sender=worker,
                            task_seq=task)
        self._h_bytes.record(
            payload_nbytes(msg.get(MSG_ARG_KEY_MODEL_PARAMS)))
        depth = getattr(self.com_manager, "inbox_depth", None)
        if depth is not None:
            depth = depth()
            if depth is not None:
                self._g_queue.set(depth)
        if self._pool is not None:
            self._g_pool_queue.set(self._pool.queue_depth())
        wcodec = msg.get(wire_codec.CODEC_KEY)
        if wcodec and not self._defer_decode():
            # Wire-codec frame: decoded pickle-free against the server's
            # spec. A corrupt frame is REFUSED (evict and release).
            try:
                t0 = time.perf_counter()
                with tr.span("ingest.decode", cat="ingest", corr=ck,
                             codec=wcodec):
                    msg.add(MSG_ARG_KEY_MODEL_PARAMS,
                            self._decode_upload(
                                wcodec, msg.get(MSG_ARG_KEY_MODEL_PARAMS),
                                sender=worker, task_seq=task))
                self._h_decode.record((time.perf_counter() - t0) * 1e3)
            except (wire_codec.CodecError, ValueError) as err:
                self._refuse_upload(worker, err, codec=wcodec,
                                    task_seq=task)
                return
        staleness = self.version - base_ver
        # Offered staleness is recorded for EVERY arrival, admitted or not.
        self._h_stale.record(staleness)
        self._stale_recent.append(staleness)
        cap = self.max_staleness
        if cap and staleness > cap:
            # Admission control: refused at the door, still replied with a
            # fresh assignment at the current version.
            self.admission_drops += 1
            self.registry.counter("admission_drops").inc()
            self.flight.record("admission_drop", sender=worker,
                               staleness=staleness, cap=cap,
                               version=self.version)
            self.flight.dump()
            self._send_assignment(worker)
            return
        self.staleness_history.append(staleness)
        self.arrival_log.append((worker, base_ver))
        v0 = self.version
        t0 = time.perf_counter()
        with tr.span("ingest.fold", cat="ingest", corr=ck,
                     staleness=staleness):
            self._ingest(msg, staleness)
        self._h_fold.record((time.perf_counter() - t0) * 1e3)
        if self.version != v0:
            self.flight.record("version_commit", version=self.version,
                               sender=worker)
            self._log_round_health(staleness)
        if (self.version != v0 and self.eval_fn is not None
                and self.test_data is not None and
                (self.version % self.cfg.frequency_of_the_test == 0
                 or self.version >= self.cfg.comm_round)):
            with capture_lock:
                m = self.eval_fn(self.net, *self.test_data)
                row = {"version": self.version, "staleness": staleness,
                       **{k: float(v) for k, v in m.items()}}
            self.test_history.append(row)
        if self.version != v0:
            # Safe actuation boundary: the version just committed.
            self._ctrl_boundary()
        if self.version >= self.cfg.comm_round:
            self._send_done(worker)
            return
        with self._lock:
            if worker not in self._members:
                # Evicted during _ingest (the buffered tier's pooled flush
                # refuses corrupt frames at its barrier and releases the
                # sender) — don't hand a released worker fresh work.
                return
        self._send_assignment(worker)

    def _ingest(self, msg: Message, staleness: int) -> None:
        """Fold one accepted upload into the server state: the async
        server mixes immediately in f32 on the card, weight and its
        complement rounded to f32 as JAX's jitted ``_mix`` takes them."""
        w = np.float32(staleness_weight(self.alpha, staleness,
                                        self.staleness_exp))
        keep, take = float(np.float32(1.0) - w), float(w)
        with capture_lock:
            upload = pytree.to_device(msg.get(MSG_ARG_KEY_MODEL_PARAMS),
                                      self.device)
            self.net = sorted_tree_map(
                lambda g, c: (keep * g.float() + take * c.float()).to(
                    g.dtype), self.net, upload)
        # Commit the version under the lock: the watchdog's termination
        # test (_version_snapshot) races this increment otherwise.
        with self._lock:
            self.version += 1


class FedAsyncClientManager(ClientManager):
    """Train on the latest received model, upload tagged with the model
    version it was based on, wait for the next model (or done). Beats
    every ``cfg.heartbeat_interval_s`` (or ``beat_interval_s``) and
    self-terminates after ``idle_timeout_s`` without server contact.

    ``local_train(net, x, y, mask, rng) -> (net', loss)`` runs on the
    device of ``train_fed`` (the captured step of
    :func:`build_federation_setup`); the call and the host copy of the
    upload run under ``capture_lock``."""

    #: Whether ``_upload_payload`` ships a DELTA against the pulled model
    #: (fedbuff) or the full trained model (async). Sparsifying codecs are
    #: only sound on deltas, so the constructor gates on this.
    _payload_is_delta = False

    def __init__(self, args, rank: int, size: int, train_fed: FederatedArrays,
                 local_train, cfg: FedConfig, backend: str = "LOOPBACK",
                 wire_codec_spec: str = "none", *,
                 beat_interval_s: Optional[float] = None,
                 idle_timeout_s: float = 0.0):
        super().__init__(args, rank=rank, size=size, backend=backend)
        self.train_fed = train_fed
        self.local_train = local_train
        self.cfg = cfg
        self.steps = 0
        self.duplicate_drops = 0
        self.upload_resends = 0
        self.device = train_fed.device
        self._counts = train_fed.counts.cpu().numpy()
        # Wire codec, negotiated against the server's handshake offer on
        # the first assignment. Validated eagerly.
        probe = wire_codec.make_wire_codec(wire_codec_spec)
        if probe.error_feedback and not self._payload_is_delta:
            raise ValueError(
                f"wire codec {wire_codec_spec!r}: sparsifying codecs need "
                "delta uploads — the async tier ships full models (use "
                "bf16/fp16/int8 here, or the FedBuff tier for top-k/"
                "randmask with error feedback)")
        self._codec_requested = wire_codec_spec or "none"
        self._codec = None  # set by negotiation on the first assignment
        # Per-worker error-feedback residual: the worker's own upload
        # sequence (one delta per assignment).
        self._ef_residual = None
        # Assigned TASK ids strictly increase: an assignment at or below
        # the high-water mark is a transport duplicate.
        self._last_task = -1
        # Cached last upload + the task it answers, for the recovery
        # re-send.
        self._last_upload: Optional[Message] = None
        self._last_upload_task = -1
        self._beats = HeartbeatSender(
            self._send_beat,
            interval_s=(cfg.heartbeat_interval_s if beat_interval_s is None
                        else beat_interval_s),
            idle_timeout_s=idle_timeout_s,
            on_idle=self.finish)

    def run(self) -> None:
        self._beats.start()
        super().run()

    def finish(self) -> None:
        self._beats.stop()
        super().finish()

    def _send_beat(self) -> None:
        self.send_message(Message(MSG_TYPE_C2S_HEARTBEAT, self.rank, 0))

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INIT_CONFIG, self.handle_model)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_model)

    def handle_model(self, msg: Message) -> None:
        self._beats.touch()
        if msg.get("done"):
            self.finish()
            return
        c = int(msg.get(MSG_ARG_KEY_CLIENT_INDEX))
        version = int(msg.get(MSG_ARG_KEY_MODEL_VERSION))
        task = msg.get(MSG_ARG_KEY_TASK_SEQ)
        task = version if task is None else int(task)
        if msg.get("recovery"):
            exp = msg.get("expected")
            exp = int(exp) if exp is not None else -1
            if self._last_upload is not None and self._last_upload_task > exp:
                # Our latest upload postdates what the server accepted: it
                # is in flight or lost. Resend the cache instead of
                # training the recovery assignment.
                self.upload_resends += 1
                self.send_message(self._last_upload)
                return
        if task <= self._last_task:
            # Transport duplicate of an assignment: not retrained.
            self.duplicate_drops += 1
            return
        self._last_task = task
        if self._codec is None:
            self._codec = wire_codec.negotiated_codec(
                self._codec_requested, msg.get(wire_codec.OFFER_KEY),
                peer="server")
            if self._payload_is_delta:
                # A server that never advertised delta acceptance would
                # mix deltas as full models: refuse loudly.
                wire_codec.require_delta_peer(
                    msg.get(wire_codec.DELTA_OK_KEY), peer="server")
        fed = self.train_fed
        with capture_lock:
            rng = keys.fold_in(keys.fold_in(
                keys.key(self.cfg.seed, self.device), self.steps), self.rank)
            self.steps += 1
            start = pytree.to_device(msg.get(MSG_ARG_KEY_MODEL_PARAMS),
                                     self.device)
            net, _ = self.local_train(start, fed.x[c], fed.y[c], fed.mask[c],
                                      rng)
            # The host copy is taken before the lock is released: the
            # next replay overwrites the captured step's outputs.
            payload = self._upload_payload(net, start)
        out = Message(MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        if self._codec is not None and self._codec.name != "none":
            # Frame seed keyed on (run seed, rank, task): a cached resend
            # re-ships identical bytes; every new task draws fresh.
            payload, self._ef_residual = self._codec.encode(
                payload, self._ef_residual,
                wire_codec.frame_seed(self.cfg.seed, self.rank, task))
            out.add(wire_codec.CODEC_KEY, self._codec.name)
        out.add(MSG_ARG_KEY_MODEL_PARAMS, payload)
        # Self-describing framing: the server refuses a mismatched stamp.
        out.add(wire_codec.DELTA_KEY, self._payload_is_delta)
        out.add(MSG_ARG_KEY_NUM_SAMPLES, int(self._counts[c]))
        out.add(MSG_ARG_KEY_MODEL_VERSION, version)
        out.add(MSG_ARG_KEY_TASK_SEQ, task)
        self._last_upload = out
        self._last_upload_task = task
        self.send_message(out)

    def _upload_payload(self, net, global_net):
        """What goes on the wire, as a host tree: the full trained model;
        the buffered subclass ships the DELTA against the model it trained
        from."""
        return pytree.host_tree(net)


def FedML_FedAsync_distributed(
    model,
    train_fed: FederatedArrays,
    test_global,
    cfg: FedConfig,
    backend: str = "LOOPBACK",
    loss_fn=softmax_ce,
    alpha: float = 0.6,
    staleness_exp: float = 0.5,
    *,
    wire_codec: str = "none",
    loopback_wire: str = "none",
    chaos: Optional[ChaosSpec] = None,
    done_timeout_s: Optional[float] = None,
    idle_timeout_s: float = 0.0,
    metrics=None,
    trace_dir: Optional[str] = None,
    pretrained_params=None,
    controller=None,
    device=None,
):
    """Run the async federation: ``cfg.comm_round`` server model updates
    (arrivals, not barrier rounds) across ``cfg.client_num_per_round``
    workers, as threads of this process. Returns the server manager (net,
    staleness/test history, ``final_health``, ``adapter_holder``).

    ``device`` (``None`` → cuda; ``"cpu"`` as the tests ask) is where the
    workers train and the server mixes and evaluates; ``train_fed``,
    ``test_global`` and ``model`` must lie there. ``done_timeout_s``
    (default ``cfg.round_timeout_s``) bounds the terminal handshake
    against crash-stop workers; ``chaos`` installs the fleet-wide
    fault-injecting transport; ``wire_codec`` compresses the uploads (full
    models here, so casts/quantization only) and ``loopback_wire`` makes
    loopback serialize for real. ``metrics`` (a MetricsLogger) gets one
    ctrl/ health row per model version; ``trace_dir`` arms the flight
    recorder + span tracer. ``controller`` (a ``ctrl.FederationController``)
    steps from the server's safe boundary after each model version."""
    device = check_device(train_fed, device)
    size, net0, local_train, eval_fn, args = (
        fedavg_distributed.build_federation_setup(
            model, train_fed, test_global, cfg, backend, loss_fn, chaos=chaos,
            loopback_wire=loopback_wire, pretrained_params=pretrained_params))
    server = FedAsyncServerManager(args, net0, cfg, size, backend=backend,
                                   alpha=alpha, staleness_exp=staleness_exp,
                                   eval_fn=eval_fn, test_data=test_global,
                                   done_timeout_s=done_timeout_s,
                                   metrics=metrics, flight_dir=trace_dir,
                                   device=device)
    if controller is not None:
        # Adaptive control (ctrl/policy.py): the same controller object
        # that drove the fleet simulator drives this live run — it steps
        # from the server's safe-boundary hook, owning no thread itself.
        server.attach_controller(controller)
    clients = [
        FedAsyncClientManager(args, rank, size, train_fed, local_train, cfg,
                              backend=backend, wire_codec_spec=wire_codec,
                              idle_timeout_s=idle_timeout_s)
        for rank in range(1, size)
    ]
    with obs_trace.tracing_to(trace_dir):
        run_workers([server.run] + [c.run for c in clients])
    server.final_health = server.health()
    server.adapter_holder = args.adapter_holder
    server.local_train = local_train
    return server
