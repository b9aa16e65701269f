"""FleetSimulator: replay a fleet trace against the REAL control plane
(port of ``fedml_tpu/sim/fleet.py``).

The simulator constructs the actual server/client managers —
``FedAVGServerManager``/``FedAVGClientManager`` (sync, first-k via
``aggregate_k``), ``FedAsyncServerManager``/``FedAsyncClientManager``
(pure async), ``FedBuffServerManager``/``FedBuffClientManager``
(buffered semi-sync) — over the ``backend="SIM"`` fabric and replaces
ONLY the two things wall-clock execution owns:

- **Thread scheduling** → the deterministic event queue. Message
  deliveries, worker beats, and the server watchdog's deadline polls are
  virtual-time events; handler code is the managers' own (deliveries
  dispatch through the registered handler dict, evictions go through the
  server's real ``_post_tick``/``_handle_tick`` self-addressed path, the
  liveness decisions through its real ``HeartbeatMonitor`` running on
  the virtual clock).
- **Wall time** → the trace. A client's local training runs at real
  speed on the card (the process's one captured step, through the
  hand-written kernels) but is CHARGED the trace's per-device virtual
  compute time
  (power-law speed multiplier x per-task jitter); its upload arrives
  that much later on the virtual clock. Availability windows gate every
  hop: a send from an offline device is lost, a delivery to one too, and
  a window edge inside a training interval kills the upload mid-flight —
  mid-round churn, which the real re-admission/recovery paths then heal.

Training math is therefore exact (time-to-accuracy is real), timing is
simulated (an hour-scale diurnal trace replays in seconds), and a seed
pins the whole interleaving (the determinism tests diff two runs' full
arrival logs). ChaosTransport composes via ``chaos=`` exactly as in
production, its timers rerouted through the event queue.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos import fedavg_distributed
from fedml_tpu_torch.algos.fedavg_distributed import (
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
    FedAVGAggregator,
    FedAVGClientManager,
    FedAVGServerManager,
    check_device,
)
from fedml_tpu_torch.algos.fedasync import (
    MSG_ARG_KEY_TASK_SEQ,
    FedAsyncClientManager,
    FedAsyncServerManager,
)
from fedml_tpu_torch.algos.fedbuff import (FedBuffClientManager,
                                           FedBuffServerManager)
from fedml_tpu_torch.comm.resilience import ChaosSpec
from fedml_tpu_torch.sim.clock import EventQueue, VirtualClock
from fedml_tpu_torch.sim.trace import FleetTrace
from fedml_tpu_torch.sim.transport import SimNetwork
from fedml_tpu_torch.trainer.local import softmax_ce

MODES = ("sync", "fedasync", "fedbuff")


def _pct(vals, q):
    return round(float(np.percentile(np.asarray(vals, np.float64), q)), 3)


@dataclasses.dataclass
class FleetResult:
    """One simulated federation run, in virtual time."""

    mode: str
    completed: bool
    virtual_s: float
    updates: int                       # server model versions / rounds
    completion_times: List[float]      # virtual time of each server update
    staleness: List[int]               # per accepted arrival (async/fedbuff)
    arrival_log: List[Tuple[int, int]]  # (worker, base_version) per arrival
    test_history: List[dict]
    health: Dict[str, int]
    net_counts: Dict[str, int]
    churn_killed: int                  # uploads lost to mid-round churn

    @property
    def final_accuracy(self) -> Optional[float]:
        for m in reversed(self.test_history):
            if "accuracy" in m:
                return float(m["accuracy"])
        return None

    @property
    def updates_per_vmin(self) -> float:
        """Server updates per virtual MINUTE — the round-throughput
        figure the serving story is judged on."""
        return 60.0 * self.updates / max(self.virtual_s, 1e-9)

    def summary(self) -> dict:
        from fedml_tpu_torch.utils import rss_mb

        out = {
            "mode": self.mode,
            "completed": self.completed,
            "virtual_s": round(self.virtual_s, 1),
            "updates": self.updates,
            "updates_per_vmin": round(self.updates_per_vmin, 3),
            "final_accuracy": self.final_accuracy,
            "churn_killed_uploads": self.churn_killed,
            # The memory axis of the serving story (ROADMAP item 1) —
            # CURRENT host RSS at summary time, the same single-sourced
            # sample bench.py records per section, so sim drills report
            # it without the bench harness.
            "host_rss_mb": round(rss_mb(), 1),
            "evictions": self.health.get("evictions", 0),
            # Churn recovery: the sync tier counts re-admissions of
            # evicted ranks, the async/buffered tiers count recovery
            # re-assignments to stalled-but-alive workers — report
            # whichever this mode's server tracks.
            "readmissions": self.health.get(
                "readmissions", self.health.get("reassignments", 0)),
        }
        if self.staleness:
            out["staleness_p50"] = _pct(self.staleness, 50)
            out["staleness_p95"] = _pct(self.staleness, 95)
            out["staleness_max"] = int(max(self.staleness))
        if len(self.completion_times) >= 2:
            gaps = np.diff(np.asarray(self.completion_times, np.float64))
            out["update_interval_p50_s"] = _pct(gaps, 50)
            out["update_interval_p95_s"] = _pct(gaps, 95)
            out["update_interval_max_s"] = round(float(gaps.max()), 3)
        return out


class StoreFleetData:
    """A ``FederatedArrays``-shaped LAZY view over a ``FederatedStore``
    (flat or sharded) for the message-passing client managers: ``x[c]``/
    ``y[c]``/``mask[c]`` gather client ``c``'s rows on demand (memmap
    page-ins touch only assigned clients — the composition that lets a
    2^20-client ``ShardedFederatedStore`` + ``ClientDirectory`` back a
    fleet drill whose resident set is O(active devices)), and ``counts``
    is the store's O(clients) count vector (a tensor, as a
    ``FederatedArrays``'s is). Every client is gathered at ONE forced
    step bucket (the store-wide max) so the captured local step sees a
    single shape, on the store's device. A one-client cache keeps the
    three field reads of one training call to a single gather; the sim
    event loop is single-threaded, so no locking."""

    class _Field:
        def __init__(self, parent: "StoreFleetData", name: str):
            self._parent = parent
            self._name = name

        def __getitem__(self, c: int):
            return getattr(self._parent._gather(int(c)), self._name)[0]

        @property
        def dtype(self):
            return getattr(self._parent._probe, self._name).dtype

        @property
        def shape(self):
            # [C, S, B, ...]: only the feature dims (shape[3:]) and the
            # client count are meaningful to callers (the trainer builds
            # its sample from shape[3:]).
            probe = getattr(self._parent._probe, self._name)
            return (self._parent.store.num_clients,) + tuple(probe.shape[1:])

    def __init__(self, store):
        self.store = store
        self.counts = torch.from_numpy(np.asarray(store.counts))
        # One fixed bucket for every client → one trainer shape.
        self._steps = store._resolve_steps(self.counts, None)
        self._cache_c: Optional[int] = None
        self._cache = None
        self._probe = self._gather(0)
        self.x = self._Field(self, "x")
        self.y = self._Field(self, "y")
        self.mask = self._Field(self, "mask")

    @property
    def batch_size(self) -> int:
        return self.store.batch_size

    @property
    def device(self) -> torch.device:
        return self.store.device

    def _gather(self, c: int):
        if self._cache_c != c:
            self._cache = self.store.gather_cohort(np.asarray([c]),
                                                   steps=self._steps)
            self._cache_c = c
        return self._cache


class FleetSimulator:
    """Build one federation (server + trace.n_devices clients) in
    ``mode`` ∈ {"sync", "fedasync", "fedbuff"} and replay the trace.

    ``aggregate_k`` is the sync first-k threshold (0 = all); ``alpha`` /
    ``staleness_exp`` the async/buffered staleness weighting (alpha
    defaults to the tier's own default); ``buffer_k`` / ``aggregator``
    the buffered tier's knobs; ``corrupt_ranks`` + ``corruptor`` flag
    Byzantine devices (fedbuff mode). ``chaos`` installs the fleet-wide
    ChaosTransport with virtual-time fault timers.

    Serving-drill composition knobs (the 1M-device drill, ROADMAP item
    1): ``wire_codec`` puts the negotiated codec on every device's
    uploads (top-k/randmask + error feedback need delta payloads —
    fedbuff mode; casts/int8 work everywhere); ``sim_wire`` makes the
    SIM fabric round-trip every message through a real wire format
    (bytes counted per rank — ``health()``'s bytes_tx/rx go live);
    ``directory`` routes the async tiers' client assignment through a
    ``data.directory.ClientDirectory`` (the production cohort sampler —
    cohorts drawn from 2^20-client count metadata, re-sharding
    invariant); ``cfg.ingest_workers`` arms the server's parallel
    ingest pool (comm/ingest.py — decode+fold off the dispatch thread,
    bit-equal for any worker count, so the SAME seeded drill measures
    the ingest-saturation curve); ``agg_shards`` stands up the sharded
    aggregation plane (comm/shardplane.py — M virtual aggregator-shard
    ranks between coordinator and devices, sync mode only; shard beats
    and the shard watchdog run on the virtual clock, so shard-eviction
    drills are as deterministic as device churn).

    ``device`` (``None`` → cuda; ``"cpu"`` as the tests ask) is where the
    devices train and the server folds and evaluates; ``train_fed``,
    ``test_global`` and ``model`` must lie there."""

    def __init__(self, model, train_fed, test_global, cfg: FedConfig,
                 trace: FleetTrace, mode: str = "fedbuff", *,
                 loss_fn=softmax_ce, chaos: Optional[ChaosSpec] = None,
                 aggregate_k: int = 0, alpha: Optional[float] = None,
                 staleness_exp: float = 0.5, buffer_k: int = 2,
                 aggregator="mean", corrupt_ranks=(), corruptor=None,
                 wire_codec: str = "none", sim_wire: str = "none",
                 directory=None, agg_shards: int = 0, controller=None,
                 device=None):
        if mode not in MODES:
            raise ValueError(f"unknown sim mode {mode!r}; known {MODES}")
        if agg_shards and mode != "sync":
            raise ValueError(
                f"agg_shards={agg_shards} is a synchronous-FedAvg "
                "capability (comm/shardplane.py); the async tiers refuse "
                "it in their server constructors for the same reason — "
                f"mode {mode!r} has no barrier round to partition")
        if getattr(cfg, "secagg", False) and mode != "sync":
            raise ValueError(
                f"secagg is a synchronous-FedAvg capability "
                "(comm/secagg.py); pairwise masks only cancel inside a "
                f"roster-complete cohort sum — mode {mode!r} has none")
        device = check_device(train_fed, device)
        self.mode = mode
        self.agg_shards = int(agg_shards or 0)
        self.trace = trace
        spec = trace.spec
        # The fleet IS the worker set: one rank per traced device. Sim
        # deadlines default from the trace scale when the config leaves
        # them off (the control plane needs them to survive churn).
        cfg = dataclasses.replace(
            cfg, client_num_per_round=spec.n_devices,
            round_timeout_s=(cfg.round_timeout_s if cfg.round_timeout_s > 0
                             else 6.0 * spec.base_round_s),
            heartbeat_interval_s=(cfg.heartbeat_interval_s
                                  if cfg.heartbeat_interval_s > 0
                                  else max(spec.slot_s / 4.0, 1.0)))
        self.cfg = cfg
        self.clock = VirtualClock()
        self.events = EventQueue(self.clock)
        self.network = SimNetwork(spec.n_devices + self.agg_shards + 1,
                                  self.events,
                                  latency_fn=self._latency,
                                  deliver_guard=self._deliver_guard,
                                  wire=sim_wire)
        size, net0, local_train, eval_fn, args = (
            fedavg_distributed.build_federation_setup(
                model, train_fed, test_global, cfg, "SIM", loss_fn,
                chaos=chaos, extra_ranks=self.agg_shards))
        args.network = self.network
        args.chaos_after = self.events.after
        # The captured local step every client shares — exposed so a
        # harness can capture it OUTSIDE its timed window (a first-call
        # capture inside one arm would skew a wall-clock curve) and read
        # its launch counts.
        self.local_train = local_train
        self.net0 = net0
        self._ready_at: Dict[Tuple[int, int], float] = {}
        self._ready_rank: Dict[int, float] = {}
        self._task_idx: Dict[int, int] = {
            r: -1 for r in range(self.agg_shards + 1, size)}
        self.churn_killed = 0

        def timed_local_train(rank, fn=local_train):
            def run(*a):
                self._task_idx[rank] += 1
                dt = self.trace.compute_time(self._dev(rank),
                                             self._task_idx[rank])
                # Load spike (FleetSpec.spike_*): rounds starting inside
                # the spike window run spike_factor x slower. The
                # default factor is exactly 1.0, a bit-exact float
                # multiply — spike-free traces are unchanged.
                dt *= self.trace.load_factor(self.clock.now)
                cm = self._client_by_rank.get(rank)
                task = getattr(cm, "_last_task", -1) if cm is not None else -1
                # Charge the compute at TRAINING time as a completion
                # timestamp — keyed by the task the upload answers
                # (async/buffered tiers) or by the rank's latest round
                # (sync, whose strict request/response flow has at most
                # one upload generation in flight). Every wire copy of
                # the upload (ChaosTransport duplicate, cached resend
                # after a drop) then derives its latency from the one
                # recorded completion; a pop-once side channel let a
                # chaos duplicate ship "for free" and outrun the real
                # upload, erasing the device's compute time from the
                # drill.
                if task >= 0:
                    self._ready_at[(rank, task)] = self.clock.now + dt
                else:
                    self._ready_rank[rank] = self.clock.now + dt
                return fn(*a)
            return run

        self.shards = []
        if mode == "sync":
            M = self.agg_shards
            self.aggregator = FedAVGAggregator(net0, size - 1 - M, cfg,
                                               eval_fn, test_global,
                                               device=device)
            if M > 0:
                from fedml_tpu_torch.comm.shardplane import (
                    AggregatorShardManager, ShardedFedAVGServerManager)

                self.server = ShardedFedAVGServerManager(
                    args, self.aggregator, cfg, size, M, backend="SIM",
                    aggregate_k=aggregate_k, clock=self.clock,
                    directory=directory)
                # beat_interval_s=0 silences the shard's wall-clock
                # HeartbeatSender thread; _schedule_beats replays shard
                # beats as virtual-time events instead.
                self.shards = [
                    AggregatorShardManager(args, r, size, cfg, net0,
                                           backend="SIM",
                                           beat_interval_s=0.0,
                                           clock=self.clock)
                    for r in range(1, M + 1)]
            else:
                self.server = FedAVGServerManager(
                    args, self.aggregator, cfg, size, backend="SIM",
                    aggregate_k=aggregate_k, clock=self.clock)
            self.clients = [
                FedAVGClientManager(args, r, size, train_fed,
                                    timed_local_train(r), cfg, backend="SIM",
                                    wire_codec_spec=wire_codec)
                for r in range(M + 1, size)]
        elif mode == "fedasync":
            self.server = FedAsyncServerManager(
                args, net0, cfg, size, backend="SIM",
                alpha=(0.6 if alpha is None else alpha),
                staleness_exp=staleness_exp, eval_fn=eval_fn,
                test_data=test_global, clock=self.clock,
                directory=directory, device=device)
            self.clients = [
                FedAsyncClientManager(args, r, size, train_fed,
                                      timed_local_train(r), cfg,
                                      backend="SIM",
                                      wire_codec_spec=wire_codec)
                for r in range(1, size)]
        else:  # fedbuff
            self.server = FedBuffServerManager(
                args, net0, cfg, size, backend="SIM",
                alpha=(1.0 if alpha is None else alpha),
                staleness_exp=staleness_exp, buffer_k=buffer_k,
                aggregator=aggregator, eval_fn=eval_fn,
                test_data=test_global, clock=self.clock,
                directory=directory, device=device)
            corrupt = set(corrupt_ranks)
            self.clients = [
                FedBuffClientManager(args, r, size, train_fed,
                                     timed_local_train(r), cfg,
                                     backend="SIM",
                                     wire_codec_spec=wire_codec,
                                     corruptor=(corruptor if r in corrupt
                                                else None))
                for r in range(1, size)]
        if controller is not None:
            # Adaptive control (ctrl/policy.py): the server is a REAL
            # manager over the SIM backend, so the identical controller
            # object steps from the identical safe-boundary hook it uses
            # in a live run — offline policy development is the point.
            self.server.attach_controller(controller)
        self._client_by_rank = {c.rank: c for c in self.clients}
        self._watch_round = -1
        self._watch_t0 = 0.0
        self._term_t0: Optional[float] = None

    # -- trace-driven policy hooks ------------------------------------------
    def _dev(self, rank: int) -> int:
        """Comm rank → trace device index. Identical when the rank
        layout has no aggregator shards; with M shards the device ranks
        start after them (rank M+d is device d)."""
        return rank - self.agg_shards

    def _latency(self, msg) -> Optional[float]:
        sender = int(msg.get_sender_id())
        receiver = int(msg.get_receiver_id())
        now = self.clock.now
        wire = self.trace.spec.wire_latency_s
        if sender == receiver:
            return 0.0  # the watchdog's self-addressed tick: no network
        if sender <= self.agg_shards:
            # Server or aggregator-shard hop (rank 0, or 1..M when the
            # sharded plane is up): infrastructure is always online and
            # has no trace entry — wire latency only. Receiver liveness
            # is checked at delivery.
            return wire
        # Device-originated. An upload is deliverable once its training
        # completes: ``_ready_at`` for task-tagged async/buffered
        # uploads, ``_ready_rank`` for the sync tier's round-keyed ones
        # — so a duplicate ships no earlier than the original and a
        # cached resend after the completion is wire-only.
        dt = 0.0
        if msg.get_type() == MSG_TYPE_C2S_SEND_MODEL_TO_SERVER:
            task = msg.get(MSG_ARG_KEY_TASK_SEQ)
            ready = (self._ready_at.get((sender, int(task)))
                     if task is not None
                     else self._ready_rank.get(sender))
            if ready is not None:
                dt = max(ready - now, 0.0)
        if not self.trace.online_through(self._dev(sender), now, now + dt):
            # The availability window closed inside the training
            # interval: mid-round churn — the upload (or beat) is lost.
            if dt > 0.0:
                self.churn_killed += 1
            return None
        return dt + wire

    def _deliver_guard(self, msg) -> bool:
        receiver = int(msg.get_receiver_id())
        if receiver <= self.agg_shards:
            return True  # coordinator / aggregator shards: always online
        return self.trace.online_at(self._dev(receiver), self.clock.now)

    # -- scheduled control events -------------------------------------------
    def _schedule_beats(self) -> None:
        hb = self.cfg.heartbeat_interval_s
        horizon = self.trace.spec.horizon_s

        def beat(client):
            if self.server._stopped or self.network.stopped(client.rank):
                return
            if self.trace.online_at(self._dev(client.rank), self.clock.now):
                client._send_beat()
            if self.clock.now + hb <= horizon:
                self.events.after(hb, lambda: beat(client))

        for c in self.clients:
            first = self.trace.next_online(self._dev(c.rank), 0.0)
            if first is not None:
                self.events.at(first + hb, lambda c=c: beat(c))

        # Aggregator shards beat too (their wall-clock HeartbeatSender is
        # disarmed at construction): always online, so a plain cadence —
        # unless a drill killed the shard's rank on the SIM fabric, which
        # is exactly how shard-eviction tests silence one.
        def shard_beat(sh):
            if self.server._stopped or sh._stopped:
                return
            if not self.network.stopped(sh.rank):
                sh._send_beat()
            if self.clock.now + hb <= horizon:
                self.events.after(hb, lambda: shard_beat(sh))

        for sh in self.shards:
            self.events.after(hb, lambda sh=sh: shard_beat(sh))

    def _schedule_watchdog(self) -> None:
        """The event-driven twin of the servers' watchdog threads: same
        deadline decisions (through the real HeartbeatMonitor on the
        virtual clock), same self-addressed ``_post_tick`` delivery —
        only the polling loop is replaced by recurring events.

        CAUTION: the decision logic below mirrors
        ``FedAVGServerManager._watchdog_loop`` and
        ``FedAsyncServerManager._watchdog_loop`` rather than sharing
        code with them (the thread loops interleave sleeping, locking,
        and ``wait_all_or_failed`` blocking in ways an event twin cannot
        reuse directly). A policy change in either server's watchdog —
        eviction predicates, the all-evicted-but-beating hold-open rule,
        terminal handling — must be reflected here, or churn drills will
        validate behavior production no longer has."""
        poll = max(self.cfg.round_timeout_s / 4.0, 1.0)
        horizon = self.trace.spec.horizon_s
        tick = (self._sync_watch if self.mode == "sync"
                else self._async_watch)

        def watch():
            if self.server._stopped:
                return
            tick()
            if not self.server._stopped and self.clock.now + poll <= horizon:
                self.events.after(poll, watch)

        self.events.after(poll, watch)

    def _sync_watch(self) -> None:
        srv = self.server
        now = self.clock.now
        if self.shards:
            # The sharded coordinator's shard watchdog, event-twinned the
            # same way: silent live shards get a self-addressed tick and
            # the eviction executes on the dispatch path
            # (ShardedFedAVGServerManager._shard_watch_loop).
            dead = (set(srv.shard_heartbeat.failed())
                    & set(srv._live_shards_snapshot()))
            if dead:
                srv._post_shard_tick(sorted(dead))
        members = set(srv._members_snapshot())
        r = srv.round_idx
        if r != self._watch_round:
            self._watch_round, self._watch_t0 = r, now
        if not members:
            srv._post_tick(r, [])
            return
        terminal = r >= self.cfg.comm_round
        have = set(srv._done_snapshot() if terminal
                   else srv._arrived_snapshot())
        deadline = srv.done_timeout_s if terminal else srv.round_timeout_s
        if not deadline or deadline <= 0:
            return
        failed = set(srv.heartbeat.failed())
        missing = members - have
        if missing and missing <= failed:
            srv._post_tick(r, sorted(failed & members))
        elif missing and now - self._watch_t0 > deadline:
            srv._post_tick(r, sorted((failed | missing) & members))

    def _async_watch(self) -> None:
        srv = self.server
        now = self.clock.now
        with srv._lock:
            members = set(srv._members)
        terminal = (not members) or srv.version >= self.cfg.comm_round
        if not terminal:
            self._term_t0 = None
            failed = set(srv.heartbeat.failed())
            if members and failed >= members:
                srv._post_tick(sorted(failed & members))
            return
        if self._term_t0 is None:
            self._term_t0 = now
        if not members:
            srv._post_tick([])
            return
        done = set(srv._done_snapshot())
        missing = members - done
        failed = set(srv.heartbeat.failed())
        if missing and missing <= failed:
            srv._post_tick(sorted(failed & members))
        elif missing and now - self._term_t0 > (srv.done_timeout_s or 0):
            srv._post_tick(sorted((failed | missing) & members))

    # -- the run -------------------------------------------------------------
    def _progress(self) -> int:
        return (self.server.round_idx if self.mode == "sync"
                else self.server.version)

    def run(self, max_virtual_s: Optional[float] = None) -> FleetResult:
        horizon = (self.trace.spec.horizon_s if max_virtual_s is None
                   else max_virtual_s)
        for mgr in [self.server] + self.shards + self.clients:
            mgr.register_message_receive_handlers()
        # The server's run() preamble, minus its blocking receive loop.
        M = self.agg_shards
        for r in range(M + 1, M + self.trace.spec.n_devices + 1):
            self.server.heartbeat.beat(r)
        for sh in self.shards:
            self.server.shard_heartbeat.beat(sh.rank)
        self.server.send_init_msg()
        self._schedule_beats()
        self._schedule_watchdog()
        completions: List[float] = []
        last = self._progress()
        while (not self.server._stopped and len(self.events)
               and self.events.next_time() <= horizon):
            self.events.step()
            p = self._progress()
            if p > last:
                completions.extend([self.clock.now] * (p - last))
                last = p
        # "Completed" means the federation actually reached its target
        # (rounds for sync, server versions for async/buffered) — the
        # async managers have no `aborted` flag, and an all-dead fleet
        # finishes their run() with the version short of comm_round, so
        # the progress check is what distinguishes collapse from
        # completion there.
        completed = (self.server._stopped
                     and not getattr(self.server, "aborted", False)
                     and last >= self.cfg.comm_round)
        # Every tier exposes the same health() surface.
        health = self.server.health()
        if self.mode == "sync":
            test_history = self.aggregator.test_history
            staleness: List[int] = []
            arrivals: List[Tuple[int, int]] = []
        else:
            test_history = self.server.test_history
            staleness = list(self.server.staleness_history)
            arrivals = list(self.server.arrival_log)
        return FleetResult(
            mode=self.mode, completed=completed,
            virtual_s=(completions[-1] if completions else self.clock.now),
            updates=last, completion_times=completions,
            staleness=staleness, arrival_log=arrivals,
            test_history=list(test_history), health=health,
            net_counts=dict(self.network.counts),
            churn_killed=self.churn_killed)
