"""Sharded aggregation plane: M-way server scale-out with wire-merged
fixed-point partials (port of ``fedml_tpu/comm/shardplane.py``).

PAPERS.md 2307.06561 names server ingest as *the* FL bottleneck; its
SmartNIC offload is a hardware answer. The software answer stacks the
repo's own primitives one level up:

- The ``IngestPool`` (comm/ingest.py) proves the associativity story INSIDE one
  process: per-worker int64 fixed-point :class:`PartialAccumulator`
  partials merge bit-equal to any serial fold, for any worker count and
  arrival interleaving.
- This module lifts that proof OVER THE WIRE. M ``AggregatorShardManager``
  processes (loopback-threaded twins in tests/bench) each own a client
  partition, run the full codec negotiation + ``IngestPool`` fold over
  their own uploads, and at flush ship ONE serialized int64 partial
  (+ participation mass + ``saturated`` gauge + ByteLedger totals). The
  rank-0 :class:`ShardedFedAVGServerManager` coordinator merges the M
  partials with the same exact ``merge_into`` adds and finalizes through
  the SAME division site (``finalize_partial_mean``) the single-process
  pool uses — bit-equality for any shard count by construction, not by
  test luck.

Rank layout: rank 0 coordinator, ranks ``1..M`` aggregator shards, ranks
``M+1..size-1`` workers. Worker→shard routing rides the existing
init/assignment handshake: each assignment stamps
``MSG_ARG_KEY_SHARD_RANK`` (directory-aware — ``ClientDirectory.
agg_shard_of`` folds data-shard locality onto the M aggregator shards),
and the client uploads to that rank while control traffic (heartbeats)
stays on rank 0.

The partial-merge wire format (see docs/ARCHITECTURE.md) rides the
existing tensor frame: a PARTIAL message whose payload dict holds the
accumulator's int64 leaves (``np.int64`` arrays — the tensor frame
round-trips them exactly) plus ``wsum``/``count``/``saturated`` as JSON
integers (arbitrary precision, so a 2^23-client round cannot overflow a
wire int). No floats cross the wire until the coordinator's single
finalize division.

Failure model — shard death is an eviction the heartbeat control
plane already understands:

- The coordinator runs a second :class:`HeartbeatMonitor` over the shard
  ranks; a silent shard is evicted via a self-addressed tick (state
  changes execute on the dispatch thread, like worker evictions).
- Eviction pulls the dead shard's un-shipped arrivals back out of the
  round and re-routes its workers with resend-flagged assignments — the
  clients' cached uploads re-target the surviving shard — so the round
  completes over surviving shards' partials.
- Mid-flush, the dead shard is simply dropped from the pending set (its
  already-collected partial, if any, is kept: those folds are safe at
  the coordinator).
- A re-admitted shard (its beats resume) catches up via a resync ANCHOR:
  it discards any uncollected partial and rejoins at the current round;
  per-channel FIFO ordering guarantees stale in-flight uploads drain
  before the resync and are deduped by the shard's round high-water
  marks.

Everything here is sync-FedAvg + mean-aggregation only: FedAsync's
sequential server mix and FedBuff's global-arrival-order buffer have no
associative partition to exploit — their managers refuse
``cfg.agg_shards`` loudly (algos/fedasync.py).

Everything here is numpy on the host, as in the JAX package: a shard
folds the host copies of its uploads into int64, and only the
coordinator's finalize puts the mean back on the card. Trees are walked
in the JAX package's leaf order (``core/tree.sorted_leaves``), so a
partial's leaves are JAX's leaf for leaf.

Deliberately NOT imported from ``comm/__init__``: this module imports
``algos.fedavg_distributed`` (the model stack), and the comm package
stays importable without it.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from fedml_tpu_torch.algos.fedavg_distributed import (
    MSG_ARG_KEY_MODEL_PARAMS,
    MSG_ARG_KEY_NUM_SAMPLES,
    MSG_ARG_KEY_SHARD_RANK,
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
    FedAVGServerManager,
    _as_dict,
    _like,
)
from fedml_tpu_torch.comm import codec as wire_codec
from fedml_tpu_torch.comm.ingest import (
    FixedContribution,
    IngestPool,
    PartialAccumulator,
    finalize_partial_mean,
    upload_fold_task,
)
from fedml_tpu_torch.comm.managers import ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.resilience import HeartbeatSender
from fedml_tpu_torch.core import compression
from fedml_tpu_torch.core.faults import HeartbeatMonitor
from fedml_tpu_torch.core.graph import capture_lock
from fedml_tpu_torch.core.tree import sorted_leaves
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.obs.registry import MetricsRegistry, payload_nbytes

log = logging.getLogger(__name__)

# Shard-plane message types, disjoint from the worker protocol (1..5 in
# fedavg_distributed, async additions in fedasync/fedbuff).
MSG_TYPE_COORD2SHARD_ANCHOR = 20  # round/epoch/broadcast net (+done/resync)
MSG_TYPE_COORD2SHARD_FLUSH = 21   # ship your partial for round r
MSG_TYPE_SHARD2COORD_PARTIAL = 22  # the int64 partial frame
MSG_TYPE_SHARD2COORD_NOTICE = 23  # per-upload accept/stale/dup/refused
MSG_TYPE_SHARD2COORD_BEAT = 24    # shard liveness
MSG_TYPE_COORD_SHARD_TICK = 25    # coordinator self-addressed deadline

PARTIAL_KEY = "shard_partial"


def encode_partial(total: PartialAccumulator) -> dict:
    """The partial frame: int64 leaves + exact scalar tallies, riding the
    tensor wire (comm/wire.py serializes int64 arrays bit-exactly and
    JSON integers with arbitrary precision). ``leaves`` is ``None`` for a
    shard that folded nothing this round — the merge treats it as the
    additive identity, exactly like a fresh in-process accumulator."""
    return {
        "leaves": (None if total.leaves is None
                   else [np.ascontiguousarray(l, dtype=np.int64)
                         for l in total.leaves]),
        "wsum": int(total.wsum),
        "count": int(total.count),
        "saturated": int(total.saturated),
    }


def decode_partial(payload: dict) -> PartialAccumulator:
    out = PartialAccumulator()
    leaves = payload.get("leaves")
    if leaves is not None:
        out.leaves = [np.asarray(l, dtype=np.int64) for l in leaves]
    out.wsum = int(payload["wsum"])
    out.count = int(payload["count"])
    out.saturated = int(payload["saturated"])
    return out


class AggregatorShardManager(ServerManager):
    """One aggregator shard (rank ``1..M``): ingests its partition's
    uploads — codec decode, delta reconstruction against the coordinator-
    anchored broadcast net, exact fixed-point fold on its own
    :class:`IngestPool` — and ships the merged int64 partial to the
    coordinator on FLUSH. Per-upload outcomes travel as small NOTICE
    messages so all round bookkeeping (arrival counts, straggler /
    duplicate / refusal policy) stays on the coordinator's dispatch
    thread, exactly where the single-server path keeps it.

    Per-channel FIFO is the correctness backbone: the coordinator sends
    ANCHOR(r) before any round-r assignment, so the anchor is always
    installed before the first round-r upload arrives; ACCEPT notices
    are sent before the PARTIAL that contains their folds, so the
    coordinator can never finalize a flush missing an accepted fold."""

    def __init__(self, args, rank: int, size: int, cfg, net_ref,
                 backend: str = "LOOPBACK", *,
                 ingest_workers: Optional[int] = None,
                 beat_interval_s: Optional[float] = None,
                 clock=time.monotonic):
        super().__init__(args, rank=rank, size=size, backend=backend)
        self.cfg = cfg
        self.round_idx = 0
        self.epoch = 0
        # High-water of the round whose partial already shipped: later
        # same-round uploads would be orphaned folds — refused as "late".
        self.flushed_round = -1
        self._anchor = None  # this round's broadcast net (delta base)
        self._net_ref = net_ref
        self._spec = wire_codec.tree_spec(net_ref)
        self._legacy_spec = compression.tree_spec(_as_dict(net_ref))
        self._decoders = {}  # legacy compressor name → compressor
        # Guards the decoder cache only: pool workers get-or-create
        # concurrently, and twin compressors would split error-feedback
        # state across them.
        self._lock = threading.Lock()
        self._wire_decoders = wire_codec.CodecCache()
        self.registry = MetricsRegistry()
        self._h_bytes = self.registry.histogram("bytes_per_upload", lo=1.0)
        self._g_queue = self.registry.gauge("ingest_queue_depth")
        self._g_pool_queue = self.registry.gauge("ingest_pool_queue_depth")
        workers = (int(getattr(cfg, "ingest_workers", 0) or 0)
                   if ingest_workers is None else int(ingest_workers))
        # A shard ALWAYS pools (min 1 worker): the pool's partial is the
        # unit of exchange, and its fold path is the bit-equality anchor.
        self._pool = IngestPool(max(1, workers), registry=self.registry)
        self._last_upload_round: Dict[int, int] = {}
        self.accepted = 0
        self.refused = 0
        self._stopped = False
        self._beats = HeartbeatSender(
            self._send_beat,
            interval_s=(cfg.heartbeat_interval_s if beat_interval_s is None
                        else beat_interval_s),
            clock=clock)

    # -- lifecycle ----------------------------------------------------------
    def run(self) -> None:
        self._beats.start()
        super().run()

    def finish(self) -> None:
        self._stopped = True
        self._beats.stop()
        self._pool.close()
        super().finish()

    def _send_beat(self) -> None:
        msg = Message(MSG_TYPE_SHARD2COORD_BEAT, self.rank, 0)
        msg.add("epoch", self.epoch)
        self.send_message(msg)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self._handle_upload)
        self.register_message_receive_handler(
            MSG_TYPE_COORD2SHARD_ANCHOR, self._handle_anchor)
        self.register_message_receive_handler(
            MSG_TYPE_COORD2SHARD_FLUSH, self._handle_flush)

    # -- coordinator control ------------------------------------------------
    def _handle_anchor(self, msg: Message) -> None:
        if self._stopped:
            return  # killed mid-dispatch: the pool is closed; eviction owns us
        ep = msg.get("epoch")
        if ep is not None:
            ep = int(ep)
            if ep < self.epoch:
                return  # straggler from a pre-crash coordinator epoch
            if ep > self.epoch:
                # Coordinator restart: adopt the epoch; the dedupe marks
                # die with the old epoch (the restored run replays rounds).
                self.epoch = ep
                self._last_upload_round.clear()
        if msg.get("done"):
            self.finish()
            return
        r = int(msg.get("round", 0))
        if bool(msg.get("resync")) or r != self.round_idx:
            # New round, or re-admission catch-up: any folds still in the
            # pool belong to a flush that will never be asked for (the
            # coordinator completed that round without us) — discard so
            # they cannot leak into the NEXT round's partial.
            self._pool.drain()
            self._pool.reset()
        self.round_idx = r
        self._anchor = msg.get(MSG_ARG_KEY_MODEL_PARAMS)

    def _handle_flush(self, msg: Message) -> None:
        if self._stopped:
            return  # a FLUSH racing finish(): drain would park on dead workers
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            return
        r = int(msg.get("round", self.round_idx))
        if r != self.round_idx or r <= self.flushed_round:
            return  # duplicate FLUSH of an already-shipped round
        # Barrier on the pool; surface per-frame refusals FIRST so FIFO
        # delivers them before the PARTIAL (the coordinator's arrival set
        # must shed refused workers before it checks the fold count).
        for meta, err in self._pool.drain():
            self.refused += 1
            self._notify("refused", int(meta.get("sender", -1)), r,
                         error=err)
        with obs_trace.active().span(
                "shard.flush", cat="shard",
                corr=obs_trace.corr(epoch=self.epoch, round=r,
                                    sender=self.rank)):
            total = self._pool.merge_partials()
        self.flushed_round = r
        out = Message(MSG_TYPE_SHARD2COORD_PARTIAL, self.rank, 0)
        out.add(PARTIAL_KEY, encode_partial(total))
        out.add("round", r)
        out.add("epoch", self.epoch)
        # Satellite rollups ride every partial: the shard's ByteLedger
        # totals and pool occupancy (both monotone/latest-wins gauges).
        ledger = getattr(self.com_manager, "bytes_ledger", None)
        out.add("bytes_rx", int(ledger.total_rx) if ledger is not None else 0)
        out.add("bytes_tx", int(ledger.total_tx) if ledger is not None else 0)
        prof = self.ingest_profile()
        out.add("occupancy", prof.get("ingest_occupancy"))
        out.add("queue_depth", int(self._pool.queue_depth()))
        self.send_message(out)

    # -- the partition's uploads --------------------------------------------
    def _handle_upload(self, msg: Message) -> None:
        if self._stopped:
            # A killed shard: the heartbeat lapse evicts it and the
            # coordinator re-routes the partition — nobody awaits a reply.
            return
        sender = msg.get_sender_id()
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            self._notify("epoch", sender, int(msg.get("round", -1)))
            return
        tag = msg.get("round")
        t = int(tag) if tag is not None else self.round_idx
        if t <= self._last_upload_round.get(sender, -1):
            # Duplicate delivery (chaos duplication / resend race): the
            # first copy was folded or refused — never fold twice.
            self._notify("duplicate", sender, t)
            return
        self._last_upload_round[sender] = t
        if t != self.round_idx or self.round_idx <= self.flushed_round:
            # An older round's straggler, or this round's partial already
            # shipped (a "late" arrival racing the flush): folding would
            # orphan the contribution. The coordinator owns catch-up.
            self._notify("stale", sender, t)
            return
        if not self._submit_upload(sender, t, msg):
            return  # finish() closed the pool under us — see _submit_upload
        self.accepted += 1
        self._notify("accept", sender, t)

    def _submit_upload(self, sender: int, t: int, msg: Message) -> bool:
        """Decode + fold on the shard's pool — the same task shape as the
        single server's ``_submit_ingest`` (closure snapshots the round's
        anchor so a late task cannot reconstruct against the next one).

        Returns False when the shard was killed while this upload was in
        flight: ``finish()`` (another thread — the coordinator's kill or a
        drill's killer) closes the pool between the handler's ``_stopped``
        check and the submit. The upload is dropped, not an error — the
        coordinator's heartbeat eviction re-routes the partition."""
        payload = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        codec = msg.get("compression")
        wcodec = msg.get(wire_codec.CODEC_KEY)
        is_delta = bool(msg.get(wire_codec.DELTA_KEY))
        masked = bool(msg.get(wire_codec.SECAGG_MASKED_KEY))
        clipped = int(msg.get("secagg_clipped") or 0)
        secagg_on = bool(getattr(self.cfg, "secagg", False))
        weight = float(msg.get(MSG_ARG_KEY_NUM_SAMPLES))
        ck = obs_trace.corr(epoch=self.epoch, round=t, sender=sender)
        self._h_bytes.record(payload_nbytes(payload))
        depth = getattr(self.com_manager, "inbox_depth", None)
        if depth is not None:
            depth = depth()
            if depth is not None:
                self._g_queue.set(depth)
        self._g_pool_queue.set(self._pool.queue_depth())
        spec = self._spec
        task = upload_fold_task(
            payload, weight, self._anchor,
            codec=codec, legacy_decode=self._legacy_decode, wcodec=wcodec,
            wire_decode=lambda w, p: self._wire_decoders.decode(w, p, spec),
            is_delta=is_delta, masked=masked, secagg_on=secagg_on,
            clipped=clipped, refusal="masked upload on a shard without "
            "--secagg")

        try:
            self._pool.submit(task, **ck)
        except RuntimeError:
            if self._stopped:
                return False
            raise
        return True

    def _legacy_decode(self, codec: str, payload):
        return _like(self._net_ref, self._decoder_for(codec).decode(
            payload, self._legacy_spec))

    def _decoder_for(self, codec: str):
        """Get-or-create the per-codec decoder under the lock. The
        shard's pool always runs >=1 worker, so two tasks can miss the
        cache for the same codec at once and construct twin compressors
        — harmless for stateless codecs, state-splitting for
        error-feedback ones."""
        with self._lock:
            dec = self._decoders.get(codec)
            if dec is None:
                dec = self._decoders[codec] = compression.make_compressor(
                    codec)
        return dec

    def _notify(self, kind: str, worker: int, round_idx: int,
                error=None) -> None:
        out = Message(MSG_TYPE_SHARD2COORD_NOTICE, self.rank, 0)
        out.add("kind", kind)
        out.add("worker", int(worker))
        out.add("round", int(round_idx))
        out.add("epoch", self.epoch)
        if error is not None:
            out.add("error", str(error)[:200])
        self.send_message(out)


class ShardedFedAVGServerManager(FedAVGServerManager):
    """Rank-0 coordinator of the sharded aggregation plane. Inherits the
    entire heartbeat control plane — membership, heartbeats, straggler-
    tolerant first-k rounds, epoch fencing, checkpoint resume — and
    replaces only the INGEST: uploads land on the M shard ranks, arrival
    bookkeeping rides NOTICE messages, and the round commit wire-merges
    the shards' int64 partials through the same ``finalize_partial_mean``
    division site as the in-process pool (bit-equality by construction).

    The round-commit handshake: the k-th ACCEPT starts a flush (FLUSH to
    every live shard); each PARTIAL is collected; when the pending set
    empties, ``_finish_flush`` merges in sorted-rank order, finalizes,
    anchors round r+1 on the shards, THEN assigns the workers — FIFO
    per channel makes anchor-before-upload exact.

    Secure aggregation composes: masked uploads are int64 frames the
    shards fold verbatim, pairwise masks cancel in the coordinator's
    wire merge exactly as in the single pool (integer adds are
    associative), and ``_finish_flush`` holds the commit until every
    orphaned roster rank's seeds are revealed and its correction folded
    into the merged total."""

    # The coordinator folds on the shards, not a local pool — tells the
    # base constructor's secagg guard that ingest_workers=0 is fine here.
    _secagg_sharded = True

    def __init__(self, args, aggregator, cfg, size: int, agg_shards: int,
                 backend: str = "LOOPBACK", aggregate_k: int = 0, *,
                 directory=None, round_timeout_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 done_timeout_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None, metrics=None,
                 clock=time.monotonic, flight_dir: Optional[str] = None):
        M = int(agg_shards)
        if M < 1:
            raise ValueError(f"agg_shards={agg_shards} needs at least 1 "
                             "aggregator shard")
        num_workers = size - 1 - M
        if num_workers < 1:
            raise ValueError(
                f"size={size} leaves no worker ranks after 1 coordinator "
                f"+ {M} shards")
        if not aggregator.aggregator.is_mean:
            raise ValueError(
                f"agg_shards={M} needs the mean aggregator: "
                f"{aggregator.aggregator.name!r} keeps the serialized "
                "stack-then-reduce cohort buffer — the wire partials are "
                "mean-only fixed-point sums (comm/shardplane.py)")
        if aggregate_k and not 1 <= aggregate_k <= num_workers:
            raise ValueError(
                f"aggregate_k={aggregate_k} outside [1, {num_workers}]")
        # The shards own the ingest pools; the coordinator folds nothing.
        cfg0 = dataclasses.replace(cfg, ingest_workers=0)
        super().__init__(args, aggregator, cfg0, size, backend=backend,
                         aggregate_k=0, round_timeout_s=round_timeout_s,
                         heartbeat_timeout_s=heartbeat_timeout_s,
                         done_timeout_s=done_timeout_s,
                         checkpoint_dir=checkpoint_dir, metrics=metrics,
                         clock=clock, flight_dir=flight_dir)
        self.agg_shards = M
        self.aggregate_k = aggregate_k or num_workers
        # Re-base membership + worker liveness onto ranks M+1..size-1;
        # ranks 1..M get their own monitor (same timeout policy).
        self._members = set(range(M + 1, size))
        self.heartbeat = HeartbeatMonitor(
            range(M + 1, size), timeout_s=self.heartbeat.timeout_s,
            clock=clock)
        self.shard_heartbeat = HeartbeatMonitor(
            range(1, M + 1), timeout_s=self.heartbeat.timeout_s,
            clock=clock)
        self._live_shards: Set[int] = set(range(1, M + 1))
        self.shard_evictions = 0
        self.shard_readmissions = 0
        self._directory = directory
        self._assigned_shard: Dict[int, int] = {}  # worker → routed shard
        self._arrived_via: Dict[int, int] = {}     # worker → accepting shard
        self._shard_partials: Dict[int, PartialAccumulator] = {}
        self._flush_pending: Set[int] = set()
        self._flushing_round: Optional[int] = None
        # Workers to catch up once the in-flight flush commits: "late"
        # stragglers whose current-round re-assignment the client-side
        # dedupe would drop, and workers pulled back by a mid-flush shard
        # eviction.
        self._catchup_after_flush: Set[int] = set()
        # Latest-wins per-shard gauges (satellites: fleet-wide saturation
        # + ByteLedger rollup in health()).
        self._shard_saturated: Dict[int, int] = {}
        self._shard_bytes: Dict[int, Tuple[int, int]] = {}
        if getattr(cfg, "secagg", False):
            if aggregate_k:
                raise ValueError(
                    f"secagg with aggregate_k={aggregate_k}: a first-k "
                    "commit orphans every straggler's masks, so each "
                    "round would reveal the stragglers' seeds and "
                    "permanently release them (comm/secagg.py is "
                    "all-or-reveal)")
            # The base constructor keyed the secagg coordinator to the
            # pre-rebase membership (ranks 1..size-1 — which includes
            # the M shard ranks); re-key it to the true worker ranks.
            self._secagg_init()

    # -- rank plumbing ------------------------------------------------------
    def _worker_slot(self, worker: int) -> int:
        return worker - self.agg_shards - 1

    def _shard_ranks(self) -> List[int]:
        return list(range(1, self.agg_shards + 1))

    def _live_shards_snapshot(self) -> List[int]:
        with self._lock:
            return sorted(self._live_shards)

    def _route_shard(self, client_index: int) -> int:
        """The shard rank this client's upload belongs to: the client
        directory's data-shard locality when available (``agg_shard_of``)
        else a plain modulo partition, remapped onto the live set when
        the preferred shard is evicted."""
        c = int(client_index)
        if self._directory is not None:
            pref = int(self._directory.agg_shard_of(c, self.agg_shards))
        else:
            pref = c % self.agg_shards
        live = self._live_shards_snapshot()
        if not live:
            return pref + 1  # all dead: the abort path is already running
        rank = pref + 1
        return rank if rank in live else live[pref % len(live)]

    def _stamp_routing(self, out: Message, client_index: int) -> None:
        shard = self._route_shard(client_index)
        out.add(MSG_ARG_KEY_SHARD_RANK, shard)
        with self._lock:
            self._assigned_shard[int(out.get_receiver_id())] = shard

    # -- lifecycle ----------------------------------------------------------
    def run(self) -> None:
        for s in self._shard_ranks():
            self.shard_heartbeat.beat(s)
        if ((self.round_timeout_s and self.round_timeout_s > 0)
                or (self.done_timeout_s and self.done_timeout_s > 0)):
            threading.Thread(target=self._shard_watch_loop,
                             daemon=True).start()
        super().run()

    def finish(self) -> None:
        if not self._stopped:
            # Release EVERY shard rank (evicted-but-alive ones included):
            # a shard stranded in its receive loop would hang the
            # run_workers join forever.
            for s in self._shard_ranks():
                self._send_anchor(s, done=True)
        super().finish()

    def send_init_msg(self) -> None:
        # Anchor before assignment: per-channel FIFO guarantees every
        # shard holds round 0's broadcast net (the delta base) before the
        # first upload can reach it.
        if self.round_idx >= self.cfg.comm_round:
            for s in self._shard_ranks():
                self._send_anchor(s, done=True)
        else:
            for s in self._live_shards_snapshot():
                self._send_anchor(s)
        super().send_init_msg()

    def register_message_receive_handlers(self) -> None:
        super().register_message_receive_handlers()
        self.register_message_receive_handler(
            MSG_TYPE_SHARD2COORD_NOTICE, self._handle_shard_notice)
        self.register_message_receive_handler(
            MSG_TYPE_SHARD2COORD_PARTIAL, self._handle_shard_partial)
        self.register_message_receive_handler(
            MSG_TYPE_SHARD2COORD_BEAT, self._handle_shard_beat)
        self.register_message_receive_handler(
            MSG_TYPE_COORD_SHARD_TICK, self._handle_shard_tick)

    # -- shard control plane ------------------------------------------------
    def _send_anchor(self, shard: int, *, resync: bool = False,
                     done: bool = False) -> None:
        out = Message(MSG_TYPE_COORD2SHARD_ANCHOR, 0, shard)
        out.add(MSG_ARG_KEY_MODEL_PARAMS,
                None if done else self._host_of(self._broadcast_net))
        out.add("round", self.round_idx)
        out.add("epoch", self.epoch)
        if resync:
            out.add("resync", True)
        if done:
            out.add("done", True)
            try:
                self.send_message(out)
            except (ConnectionError, OSError):
                pass  # release is best-effort: a dead shard needs none
            return
        try:
            self.send_message(out)
        except (ConnectionError, OSError) as err:
            log.warning("anchor to shard %d failed (%s): evicting",
                        shard, err)
            self._evict_shards([shard])

    def _handle_shard_beat(self, msg: Message) -> None:
        s = msg.get_sender_id()
        self.shard_heartbeat.beat(s)
        if self.round_idx >= self.cfg.comm_round or self._stopped:
            self._send_anchor(s, done=True)
            return
        with self._lock:
            live = s in self._live_shards
        if not live:
            with self._lock:
                self._live_shards.add(s)
                self.shard_readmissions += 1
            log.info("re-admitting aggregator shard %d on beat", s)
            self.flight.record("shard_readmission", shard=s,
                               round=self.round_idx)
            # Resync: the shard discards any uncollected partial and
            # rejoins at the current round with the current anchor. Its
            # in-flight stale uploads drain first (FIFO) and are deduped
            # by its per-worker round high-water marks.
            self._send_anchor(s, resync=True)

    def _shard_watch_loop(self) -> None:
        poll = max(0.005, min(
            0.05, (self.round_timeout_s or self.done_timeout_s) / 10))
        while not self._stopped:
            dead = (set(self.shard_heartbeat.failed())
                    & set(self._live_shards_snapshot()))
            if dead:
                self._post_shard_tick(sorted(dead))
            time.sleep(poll)

    def _post_shard_tick(self, dead) -> None:
        """Self-addressed, like the worker watchdog's TICK: the eviction
        executes on the dispatch thread, serialized with every handler."""
        msg = Message(MSG_TYPE_COORD_SHARD_TICK, 0, 0)
        msg.add("shards", [int(s) for s in dead])
        msg.add("epoch", self.epoch)
        try:
            self.send_message(msg)
        except (ConnectionError, OSError):
            pass  # next watchdog pass re-ticks

    def _handle_shard_tick(self, msg: Message) -> None:
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            return
        dead = set(msg.get("shards") or [])
        # Re-check at dispatch time: a beat may have landed while the
        # tick sat in the inbox.
        dead &= set(self.shard_heartbeat.failed())
        with self._lock:
            dead &= self._live_shards
        if dead:
            log.warning("shard deadline: evicting silent shard(s) %s",
                        sorted(dead))
            self._evict_shards(sorted(dead))

    def _evict_shards(self, ranks) -> None:
        evicted = []
        with self._lock:
            for s in ranks:
                if s in self._live_shards:
                    self._live_shards.discard(s)
                    self.shard_evictions += 1
                    evicted.append(s)
        if not evicted:
            return
        self.flight.record("shard_eviction", shards=evicted,
                           round=self.round_idx)
        self.flight.dump()
        # Folds held by the dead shards are lost UNLESS their partial was
        # already collected this flush. Pull the lost arrivals back out
        # and re-route those workers to surviving shards; their cached
        # uploads resend (re-targeted by the stamped shard rank).
        with self._lock:
            flushing = self._flushing_round is not None
            reroute = set()
            for w, via in list(self._arrived_via.items()):
                if via in evicted and via not in self._shard_partials:
                    self._arrived.discard(w)
                    del self._arrived_via[w]
                    reroute.add(w)
            for w, s in list(self._assigned_shard.items()):
                if s in evicted and w in self._members:
                    reroute.add(w)
            self._flush_pending -= set(evicted)
            flush_done = flushing and not self._flush_pending
            none_live = not self._live_shards
        if none_live:
            log.error("all aggregator shards dead at round %d: "
                      "abandoning the run", self.round_idx)
            self.aborted = True
            self.flight.record("abort", round=self.round_idx)
            self.flight.dump()
            for w in self._members_snapshot():
                self._send_done(w)
            if not self._stopped:
                self.finish()
            return
        if flushing:
            # Mid-flush: the round completes over the surviving shards'
            # partials; the pulled-back workers rejoin at the commit.
            with self._lock:
                self._catchup_after_flush |= reroute
            if flush_done:
                self._finish_flush()
        else:
            for w in sorted(reroute):
                self._send_assignment(w, resend=True)

    # -- per-upload notices -------------------------------------------------
    def _handle_shard_notice(self, msg: Message) -> None:
        shard = msg.get_sender_id()
        self.shard_heartbeat.beat(shard)
        with self._lock:
            live = shard in self._live_shards
        if not live:
            # A presumed-dead shard's stale bookkeeping: its accepted
            # folds were already pulled back and re-routed — only its
            # BEAT (a resync) can bring it back.
            return
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            return
        kind = msg.get("kind")
        worker = int(msg.get("worker"))
        r = int(msg.get("round", -1))
        if kind == "accept":
            self._on_accept(shard, worker, r)
        elif kind == "stale":
            self.straggler_drops += 1
            self.flight.record("straggler_drop", sender=worker, round=r)
            self.heartbeat.beat(worker)
            if self.round_idx >= self.cfg.comm_round:
                self._send_done(worker)
            elif (self.secagg is not None
                    and self.secagg.compromised(worker)):
                # Revealed seeds: released for the epoch, never re-fed.
                self._send_done(worker)
            elif r == self.round_idx:
                # A late same-round upload racing the flush: a fresh
                # assignment for THIS round would be deduped client-side
                # — catch the worker up when the flush commits.
                with self._lock:
                    self._catchup_after_flush.add(worker)
            else:
                self._send_assignment(worker)
        elif kind == "duplicate":
            self.duplicate_drops += 1
            self.flight.record("duplicate_drop", sender=worker, round=r)
        elif kind == "epoch":
            self.epoch_drops += 1
            self.flight.record("epoch_drop", sender=worker)
        elif kind == "refused":
            self._on_refused(worker, r, msg.get("error"))
        else:
            log.warning("shard %d sent unknown notice kind %r", shard, kind)

    def _on_accept(self, shard: int, worker: int, r: int) -> None:
        self.heartbeat.beat(worker)  # an upload is liveness
        # A compromised rank (seeds revealed/mid-reveal) is never
        # re-admitted — but its CURRENT upload already folded on the
        # shard, so the arrival must still count (correction ⟺ not
        # arrived; the commit tail releases it).
        with self._lock:
            readmit = worker not in self._members and not (
                self.secagg is not None
                and self.secagg.compromised(worker))
            if readmit:
                self._members.add(worker)
                self.readmissions += 1
            self.flight.record("readmission", sender=worker, round=r,
                               via="upload")
        if r != self.round_idx:
            # Defensive: FIFO (ACCEPT before the shard's own PARTIAL)
            # makes a post-commit ACCEPT for r unreachable.
            log.warning("shard %d accepted worker %d for round %d but the "
                        "coordinator is at %d — ignoring", shard, worker,
                        r, self.round_idx)
            return
        with self._lock:
            self._arrived.add(worker)
            self._arrived_via[worker] = shard
            ready = len(self._arrived) >= self._k_effective()
            flushing = self._flushing_round is not None
        if ready and not flushing:
            self._complete_round()

    def _on_refused(self, worker: int, r: int, error) -> None:
        """The pooled refusal policy (``_settle_pool``), delivered by
        notice: evict AND release — a mismatched encoder can never upload
        a usable model."""
        self.codec_refusals += 1
        log.error("rank %d: shard ingest refused (%s) — evicting and "
                  "releasing the worker", worker, error)
        self.flight.record("codec_refusal", sender=worker, round=r,
                           error=(str(error)[:200]
                                  if error is not None else None))
        with self._lock:
            self._arrived.discard(worker)
            self._arrived_via.pop(worker, None)
        self._evict([worker])
        self.flight.dump()
        with self._lock:
            empty = not self._members
        if empty:
            log.error("all workers refused/evicted at round %d: "
                      "abandoning the run", self.round_idx)
            self.aborted = True
        self._send_done(worker)

    # -- the flush ----------------------------------------------------------
    def _complete_round(self) -> None:
        """k-th accept: start the flush. The commit happens in
        ``_finish_flush`` once every live shard's partial is in."""
        # Mask-completeness gate BEFORE the flush barrier: an evicted
        # roster rank's masks sit orphaned inside the shards' partials;
        # hold the flush until its seeds are revealed (each reveal
        # re-enters via _secagg_recheck). Orphans appearing mid-flush
        # (a shard eviction pulling arrivals back) are caught by the
        # same gate at the top of _finish_flush.
        if self.secagg is not None and not self._secagg_reveals_ready():
            return
        with self._lock:
            if self._flushing_round is not None:
                return
            live = sorted(self._live_shards)
            self._flushing_round = self.round_idx
            self._flush_pending = set(live)
            self._shard_partials = {}
        for s in live:
            out = Message(MSG_TYPE_COORD2SHARD_FLUSH, 0, s)
            out.add("round", self.round_idx)
            out.add("epoch", self.epoch)
            try:
                self.send_message(out)
            except (ConnectionError, OSError) as err:
                log.warning("flush to shard %d failed (%s): evicting",
                            s, err)
                self._evict_shards([s])

    def _handle_shard_partial(self, msg: Message) -> None:
        shard = msg.get_sender_id()
        self.shard_heartbeat.beat(shard)
        ep = msg.get("epoch")
        if ep is not None and int(ep) != self.epoch:
            return
        with self._lock:
            live = shard in self._live_shards
        if not live:
            return
        # The satellite rollups ride every partial (latest-wins gauges:
        # the shard's saturated count is a lifetime monotone, the ledger
        # totals are cumulative).
        frame = msg.get(PARTIAL_KEY) or {}
        self._shard_saturated[shard] = int(frame.get("saturated", 0))
        self._shard_bytes[shard] = (int(msg.get("bytes_rx", 0)),
                                    int(msg.get("bytes_tx", 0)))
        occ = msg.get("occupancy")
        if occ is not None:
            self.registry.gauge(f"shard{shard}_occupancy").set(float(occ))
        self.registry.gauge(f"shard{shard}_queue_depth").set(
            float(msg.get("queue_depth", 0)))
        r = int(msg.get("round", -1))
        with self._lock:
            if self._flushing_round != r or shard not in self._flush_pending:
                return  # straggling partial from a superseded flush
            self._shard_partials[shard] = decode_partial(
                msg.get(PARTIAL_KEY))
            self._flush_pending.discard(shard)
            done = not self._flush_pending
        if done:
            self._finish_flush()

    def _finish_flush(self) -> None:
        """All live shards' partials are in: merge in sorted-rank order
        (int64 adds — order-insensitive, sorted for determinism of the
        merge span), finalize through the ONE division site the
        in-process pool uses, then run the base round-commit tail."""
        if self.secagg is not None:
            with self._lock:
                r0 = self._flushing_round
                arrived0 = sorted(self._arrived)
            if r0 is None:
                return
            pending = self.secagg.unreconstructed(r0, arrived0)
            if pending:
                # A mid-flush shard eviction pulled arrivals back out of
                # the round: those roster ranks are orphans now, and
                # their un-cancelled masks are already folded into the
                # collected partials. Hold the commit for the reveals
                # (_secagg_recheck re-enters) — and drop them from the
                # catch-up list: a revealed rank is released, not re-fed.
                with self._lock:
                    self._catchup_after_flush -= set(pending)
                self._secagg_request_reveals(pending)
                return
        with self._lock:
            r = self._flushing_round
            if r is None:
                return
            partials = [self._shard_partials[s]
                        for s in sorted(self._shard_partials)]
            arrived = sorted(self._arrived)
            self._arrived = set()
            self._arrived_via = {}
            self._flushing_round = None
            self._flush_pending = set()
            self._shard_partials = {}
            catchup = sorted(self._catchup_after_flush)
            self._catchup_after_flush = set()
        total = PartialAccumulator()
        with obs_trace.active().span(
                "shard.merge", cat="shard",
                corr=obs_trace.corr(epoch=self.epoch, round=r),
                shards=len(partials), arrived=len(arrived)):
            for p in partials:
                p.merge_into(total)
            if self.secagg is not None:
                # Orphaned roster ranks (reveals completed above): fold
                # each reconstructed-seed correction as a weight-0
                # count-0 contribution — the same exact int64 adds the
                # single-pool precommit path uses — then audit the
                # post-cancellation envelope.
                orphans = self.secagg.orphans(r, arrived)
                if orphans:
                    shapes = [tuple(l.shape)
                              for l in sorted_leaves(self.aggregator.net)]
                    for d in orphans:
                        corr = self.secagg.correction(
                            d, r, self.epoch, arrived, shapes)
                        total.add_fixed(FixedContribution(corr, 0, 0))
                    self.flight.record(
                        "secagg_correction", round=r,
                        targets=[int(d) for d in orphans])
                self._secagg_envelope_check(total)
            with capture_lock:
                mean, count = finalize_partial_mean(total,
                                                    self.aggregator.net)
        if count != len(arrived):
            raise ValueError(
                f"sharded flush merged {count} folded uploads but the "
                f"round arrived {len(arrived)}: a lost fold cannot be "
                "subtracted after the fact — this is a shard-plane "
                "protocol bug (comm/shardplane.py)")
        if arrived and mean is not None:
            self.aggregator.net = mean
        self.flight.record("round_commit", round=r, arrived=len(arrived),
                           shards=len(partials))
        self._broadcast_net = self.aggregator.net
        if (r % self.cfg.frequency_of_the_test == 0
                or r == self.cfg.comm_round - 1):
            self.aggregator.test_on_server(r)
        # Commit under the lock: the inherited watchdog thread reads the
        # round counter through the base class's locked snapshot.
        with self._lock:
            self.round_idx = r + 1
        self._log_round_health(r, arrived)
        if self._ckpt is not None and self.cfg.checkpoint_every and (
                self.round_idx % self.cfg.checkpoint_every == 0):
            self._save_checkpoint(wait=False)
        # Secagg membership repair (waitroom admits, compromised purge,
        # reveal bookkeeping reset) — same tail as the single-pool path.
        extra = (self._secagg_commit_tail(arrived)
                 if self.secagg is not None else [])
        if self.round_idx >= self.cfg.comm_round:
            for s in self._shard_ranks():
                self._send_anchor(s, done=True)
            for worker in list(arrived) + extra:
                self._send_done(worker)
            for worker in catchup:
                if worker not in arrived:
                    self._send_done(worker)
            return
        # Anchor BEFORE assigning: FIFO per channel means every shard
        # holds round r+1's delta base before its first r+1 upload.
        for s in self._live_shards_snapshot():
            self._send_anchor(s)
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        compromised = (self.secagg.compromised
                       if self.secagg is not None else (lambda w: False))
        for worker in list(arrived) + extra:
            if compromised(worker):
                # Its fold counted this round, but its seeds are public
                # now — release for the epoch instead of re-assigning.
                self._send_done(worker)
            else:
                self._send_assignment(worker, client_indexes)
        for worker in catchup:
            if worker not in arrived:
                if compromised(worker):
                    self._send_done(worker)
                else:
                    self._send_assignment(worker, client_indexes)

    def _secagg_recheck(self) -> None:
        """A seed reveal just completed. If the flush barrier already
        emptied (we returned early from ``_finish_flush`` to wait for
        this reveal), re-enter the commit; if no flush is in flight the
        base recheck re-drives ``_complete_round`` through its own gate.
        A flush with partials still pending needs nothing — the gate
        re-runs when the last partial lands."""
        if self.round_idx >= self.cfg.comm_round:
            return
        with self._lock:
            flushing = self._flushing_round is not None
            drained = flushing and not self._flush_pending
        if drained:
            self._finish_flush()
        elif not flushing:
            super()._secagg_recheck()

    # -- observability ------------------------------------------------------
    def health(self) -> Dict[str, int]:
        out = super().health()
        with self._lock:
            live = len(self._live_shards)
            saturated = sum(self._shard_saturated.values())
            bytes_rx = sum(rx for rx, _ in self._shard_bytes.values())
            bytes_tx = sum(tx for _, tx in self._shard_bytes.values())
        out["shards"] = live
        out["shard_evictions"] = self.shard_evictions
        out["shard_readmissions"] = self.shard_readmissions
        # Satellite fixes: fleet-wide saturation (each shard reports its
        # pool's lifetime gauge; the sum IS the fleet total because the
        # shards' client partitions are disjoint) and the per-shard
        # ByteLedger totals folded into the coordinator's own.
        out["ingest_saturated"] = out.get("ingest_saturated", 0) + saturated
        out["bytes_rx"] = out.get("bytes_rx", 0) + bytes_rx
        out["bytes_tx"] = out.get("bytes_tx", 0) + bytes_tx
        return out
