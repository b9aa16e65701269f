"""The ``backend="SIM"`` comm fabric: message delivery as virtual-time
events (port of ``fedml_tpu/sim/transport.py``).

``SimNetwork`` replaces LoopbackNetwork's per-rank blocking queues with
the event queue: a send schedules a delivery event at
``now + latency_fn(msg)`` and the delivery dispatches the message to the
receiving manager's registered handlers directly — the same serialized
one-message-at-a-time semantics as the real receive loops (the fake-
clock protocol tests already rely on direct handler invocation being
faithful), but ordered by VIRTUAL time instead of thread scheduling.

The fleet simulator owns the two policy hooks:

- ``latency_fn(msg) -> float | None`` at SEND time — wire latency,
  per-device compute time for uploads, or ``None`` to drop (sender
  offline / churn killed the upload mid-training);
- ``deliver_guard(msg) -> bool`` at DELIVERY time — receiver
  reachability (a message to an offline phone is lost).

A stopped rank (its manager called ``finish()``) drops deliveries like
a dead process. ChaosTransport wraps a ``SimCommManager`` exactly as it
wraps any real backend (``args.chaos``), with its delay/reorder timers
rerouted through the same event queue (``args.chaos_after``), so chaos
drills stay deterministic under simulation.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.sim.clock import EventQueue


def _tracer():
    """The active span tracer (obs.trace), imported lazily so the sim
    fabric stays importable without pulling the obs package until a
    drill actually runs."""
    from fedml_tpu_torch.obs import trace as obs_trace

    return obs_trace.active()


class SimNetwork:
    """Shared virtual-time router: observers per rank, deliveries as
    events. Single-threaded by construction.

    ``wire`` (default ``"none"``): with a real wire format name
    (``tensor`` | ``json`` | ``pickle``) every inter-rank message is
    serialized at post and deserialized at delivery — the LoopbackNetwork
    round-trip mode's virtual-time twin, so a fleet drill exercises the
    exact frame code the socket backends ship AND counts honest
    bytes-on-wire (per-rank :class:`~fedml_tpu_torch.comm.wire.ByteLedger`\\ s,
    surfaced through each manager's ``bytes_ledger`` → ``health()``).
    Self-addressed messages (the watchdog tick) skip the round-trip —
    they never cross a wire."""

    def __init__(self, size: int, events: EventQueue,
                 latency_fn: Optional[Callable[[Message],
                                               Optional[float]]] = None,
                 deliver_guard: Optional[Callable[[Message], bool]] = None,
                 default_latency_s: float = 0.0, wire: str = "none"):
        from fedml_tpu_torch.comm.wire import WIRE_FORMATS, ByteLedger

        if wire not in ("none",) + WIRE_FORMATS:
            raise ValueError(f"unknown sim wire format {wire!r}")
        self.size = size
        self.events = events
        self.latency_fn = latency_fn
        self.deliver_guard = deliver_guard
        self.default_latency_s = default_latency_s
        self.wire = wire
        self.ledgers: Dict[int, "ByteLedger"] = {
            r: ByteLedger() for r in range(size)}
        self._observers: Dict[int, List[Observer]] = {}
        self._stopped: Set[int] = set()
        self.counts: Dict[str, int] = {
            "sent": 0, "delivered": 0, "dropped_send": 0,
            "dropped_offline": 0, "dropped_stopped": 0,
        }

    def attach(self, rank: int, observer: Observer) -> None:
        self._observers.setdefault(rank, []).append(observer)

    def detach(self, rank: int, observer: Observer) -> None:
        self._observers.get(rank, []).remove(observer)

    def stop(self, rank: int) -> None:
        self._stopped.add(rank)

    def stopped(self, rank: int) -> bool:
        return rank in self._stopped

    def post(self, msg: Message) -> None:
        self.counts["sent"] += 1
        latency = self.default_latency_s
        if self.latency_fn is not None:
            latency = self.latency_fn(msg)
        if latency is None:
            self.counts["dropped_send"] += 1
            tr = _tracer()
            if tr:
                tr.instant("wire.drop", cat="wire", reason="send",
                           sender=int(msg.get_sender_id()),
                           receiver=int(msg.get_receiver_id()))
            return
        # Wire round-trip (after the latency decision, which reads the
        # live message): bytes sit in flight, the sender's ledger counts
        # tx NOW and the receiver's counts rx at delivery.
        blob = None
        sender = int(msg.get_sender_id())
        receiver = int(msg.get_receiver_id())
        if self.wire != "none" and sender != receiver:
            from fedml_tpu_torch.comm.wire import serialize_message

            blob = serialize_message(msg, self.wire)
            self.ledgers[sender].count_tx(receiver, len(blob))
        # The in-flight time becomes one "wire.sim" span at delivery:
        # install a SpanTracer over THIS simulation's VirtualClock
        # (obs.trace.tracing_to(dir, clock=sim.clock)) and the trace's
        # time axis is virtual seconds — compute charge + wire latency
        # drawn exactly as the drill scheduled them.
        t_sent = _tracer().now()
        self.events.after(latency, lambda m=msg, b=blob, t0=t_sent:
                          self._deliver(m, t0, b))

    def _deliver(self, msg: Message, t_sent: float = 0.0,
                 blob=None) -> None:
        receiver = int(msg.get_receiver_id())
        tr = _tracer()
        if receiver in self._stopped:
            self.counts["dropped_stopped"] += 1
            if tr:
                tr.instant("wire.drop", cat="wire", reason="stopped",
                           receiver=receiver)
            return
        if self.deliver_guard is not None and not self.deliver_guard(msg):
            self.counts["dropped_offline"] += 1
            if tr:
                tr.instant("wire.drop", cat="wire", reason="offline",
                           receiver=receiver)
            return
        self.counts["delivered"] += 1
        if blob is not None:
            from fedml_tpu_torch.comm.wire import deserialize_message

            self.ledgers[receiver].count_rx(int(msg.get_sender_id()),
                                            len(blob))
            msg = deserialize_message(blob, self.wire)
        if tr:
            tr.complete("wire.sim", t_sent, cat="wire",
                        sender=int(msg.get_sender_id()), receiver=receiver,
                        msg_type=int(msg.get_type()))
        for obs in list(self._observers.get(receiver, ())):
            obs.receive_message(msg.get_type(), msg)


class SimCommManager(BaseCommunicationManager):
    """Per-rank handle on the SimNetwork, implementing the backend
    surface the managers expect. ``handle_receive_message`` is a no-op:
    under simulation the EVENT LOOP dispatches (the fleet simulator
    never calls the managers' blocking ``run()``)."""

    def __init__(self, network: SimNetwork, rank: int):
        self.network = network
        self.rank = rank

    @property
    def bytes_ledger(self):
        """This rank's tx/rx byte totals (live only when the network
        runs a wire round-trip mode) — the surface ``health()`` reads on
        every backend."""
        return self.network.ledgers[self.rank]

    def send_message(self, msg: Message) -> None:
        if self.network.stopped(self.rank):
            raise ConnectionError(f"sim rank {self.rank} is stopped")
        self.network.post(msg)

    def add_observer(self, observer: Observer) -> None:
        self.network.attach(self.rank, observer)

    def remove_observer(self, observer: Observer) -> None:
        self.network.detach(self.rank, observer)

    def handle_receive_message(self) -> None:
        """No blocking loop: deliveries are event-queue callbacks."""

    def stop_receive_message(self) -> None:
        self.network.stop(self.rank)
