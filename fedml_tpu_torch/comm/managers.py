"""Client/Server process managers (port of ``fedml_tpu/comm/managers.py``).

Parity with ``fedml_core/distributed/client/client_manager.py:14-79`` and
``server/server_manager.py:15-74``: a manager owns a comm backend, registers
itself as observer, dispatches incoming messages through a handler dict
keyed by message type, and runs a blocking receive loop until ``finish()``.

Backend selection is a string, as in the reference (client_manager.py:20-36):
``LOOPBACK`` (in-memory; needs a shared ``LoopbackNetwork`` in
``args.network``), ``TCP`` (native C++ socket transport;
``args.host_table`` maps rank → (host, port)) or ``SIM`` (the fleet
simulator's virtual-clock fabric; ``args.network`` is a
``sim.transport.SimNetwork``). The JAX package's ``GRPC``, ``MQTT`` and
``TRPC`` backends are not ported yet (ROADMAP.md A10d): asking for one
raises by name.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.loopback import LoopbackCommManager
from fedml_tpu_torch.comm.message import Message


#: The JAX package's other backends, ported with ROADMAP.md A10d.
UNPORTED_BACKENDS = ("GRPC", "MQTT", "TRPC")


def _build_backend(args, rank: int, size: int, backend: str) -> BaseCommunicationManager:
    if backend == "LOOPBACK":
        mgr: BaseCommunicationManager = LoopbackCommManager(args.network, rank)
    elif backend == "TCP":
        from fedml_tpu_torch.comm.tcp import TcpCommManager

        mgr = TcpCommManager(args.host_table, rank)
    elif backend == "SIM":
        # Virtual-clock fleet simulation (fedml_tpu_torch.sim): the
        # event-queue fabric dispatches deliveries in deterministic
        # virtual-time order; ``args.network`` is a sim.transport.SimNetwork.
        from fedml_tpu_torch.sim.transport import SimCommManager

        mgr = SimCommManager(args.network, rank)
    elif backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"comm backend {backend!r} is not ported yet to the PyTorch "
            "federation plane (ROADMAP.md A10d); use LOOPBACK, TCP or SIM")
    else:
        raise ValueError(f"unknown comm backend {backend!r}")
    # Fault drills: ``args.chaos`` (a resilience.ChaosSpec, shared by the
    # whole fleet) wraps the real backend in a ChaosTransport, so drills
    # exercise the exact transport code paths production uses.
    # ``args.chaos_after`` (set by the fleet simulator) reroutes the
    # wrapper's delay/reorder timers through the virtual-clock event
    # queue so chaos drills stay deterministic under simulation.
    spec = getattr(args, "chaos", None)
    if spec is not None:
        from fedml_tpu_torch.comm.resilience import ChaosTransport

        mgr = ChaosTransport(mgr, spec, rank,
                             after=getattr(args, "chaos_after", None))
    return mgr


class _Manager(Observer):
    def __init__(self, args, rank: int = 0, size: int = 0, backend: str = "LOOPBACK"):
        self.args = args
        self.rank = rank
        self.size = size
        self.backend = backend
        self.com_manager = _build_backend(args, rank, size, backend)
        self.com_manager.add_observer(self)
        self.message_handler_dict: Dict[object, Callable[[Message], None]] = {}

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self) -> None:
        """Subclasses register via :meth:`register_message_receive_handler`."""

    def register_message_receive_handler(self, msg_type, handler) -> None:
        self.message_handler_dict[msg_type] = handler

    def receive_message(self, msg_type, msg: Message) -> None:
        self.message_handler_dict[msg_type](msg)

    def send_message(self, message: Message) -> None:
        self.com_manager.send_message(message)

    def finish(self) -> None:
        """Stop the receive loop. The reference calls MPI Abort here
        (client_manager.py:72-75); loopback/tcp shut down cleanly — tcp also
        releases its native sockets."""
        self.com_manager.stop_receive_message()
        close = getattr(self.com_manager, "close", None)
        if close is not None:
            close()


class ClientManager(_Manager):
    pass


class ServerManager(_Manager):
    """Server managers additionally clock their dispatch thread: every
    upload funnels through this single-threaded handler loop — the
    server-ingest wall (arXiv:2307.06561) — and ``busy seconds ÷
    (first→last message span)`` is the ``ingest_occupancy`` figure that
    ``ingest_profile()`` reports and the ingest pool lowers. Attribute
    defaults via ``getattr`` so subclasses need no
    constructor coordination; the fake-clock protocol tests that invoke
    handlers directly simply record no occupancy."""

    def receive_message(self, msg_type, msg: Message) -> None:
        t0 = time.perf_counter()
        if getattr(self, "_dispatch_t0", None) is None:
            self._dispatch_t0 = t0
        try:
            super().receive_message(msg_type, msg)
        finally:
            t1 = time.perf_counter()
            self._busy_s = getattr(self, "_busy_s", 0.0) + (t1 - t0)
            self._dispatch_t1 = t1

    def ingest_profile(self) -> Dict[str, object]:
        """Where an upload's server-side time goes: dispatch-thread
        occupancy plus the ingest registry's decode/fold/bytes/staleness
        histograms (when the subclass keeps a ``self.registry``).
        ``None`` occupancy means fewer than two dispatched messages."""
        from fedml_tpu_torch.obs.registry import hist_fields

        busy = getattr(self, "_busy_s", 0.0)
        t0: Optional[float] = getattr(self, "_dispatch_t0", None)
        t1: Optional[float] = getattr(self, "_dispatch_t1", None)
        span = max(t1 - t0, 0.0) if (t0 is not None and t1 is not None) else 0.0
        out: Dict[str, object] = {
            "uploads": 0,
            "ingest_occupancy": round(busy / span, 4) if span > 0 else None,
            "dispatch_busy_s": round(busy, 4),
            "dispatch_span_s": round(span, 4),
        }
        reg = getattr(self, "registry", None)
        if reg is not None:
            for name in ("decode_ms", "fold_ms", "bytes_per_upload",
                         "staleness"):
                out.update(hist_fields(reg.histogram(name), name))
            out["uploads"] = reg.histogram("fold_ms").count
        # Parallel ingest pool (comm/ingest.py): per-worker occupancy +
        # task latency ride the same profile so the before/after of the
        # pooled fold is visible in one ruler (docs/OBSERVABILITY.md).
        pool = getattr(self, "_pool", None)
        if pool is not None:
            out["ingest_pool"] = pool.profile()
            if reg is not None:
                out.update(hist_fields(reg.histogram("pool_task_ms"),
                                       "pool_task_ms"))
                out["uploads"] = max(out["uploads"],
                                     reg.histogram("pool_task_ms").count)
        return out

    # -- adaptive control (fedml_tpu.ctrl) -----------------------------------
    def attach_controller(self, controller) -> None:
        """Bind a ``FederationController`` to this manager's actuation
        seam (``self.ctrl``, built by the subclass constructor). The
        manager then invokes the controller from ``_ctrl_boundary()`` at
        its safe boundaries; ``None`` detaches. The same controller
        object may later be attached to a different manager — ``bind()``
        resets policy state and the actuation log."""
        if controller is not None:
            if getattr(self, "ctrl", None) is None:
                raise ValueError(
                    f"{type(self).__name__} exposes no actuation seam; "
                    "cannot attach a controller")
            controller.bind()
        self._controller = controller
        self._ctrl_errors = 0

    def _ctrl_boundary(self) -> None:
        """Safe-boundary hook the subclass calls between rounds / after
        buffer commits (on the dispatch thread, never mid-flush). Drains
        externally queued actuations, then steps the attached controller.

        Failure containment: a policy exception must not take down the
        federation it is supposed to protect. Each exception is counted
        (``actuation_policy_errors``) and flight-recorded; after three
        consecutive failing steps the controller is detached
        (``controller_detached`` flight event) and the managers run on
        with their last-applied knob values — static behavior, not an
        outage."""
        seam = getattr(self, "ctrl", None)
        if seam is not None:
            seam.apply_pending()
        controller = getattr(self, "_controller", None)
        if controller is None:
            return
        try:
            controller.step(self)
        except Exception as e:  # noqa: BLE001 — containment boundary
            self._ctrl_errors = getattr(self, "_ctrl_errors", 0) + 1
            reg = getattr(self, "registry", None)
            if reg is not None:
                reg.counter("actuation_policy_errors").inc()
            flight = getattr(self, "flight", None)
            if flight is not None:
                flight.record("policy_error", error=type(e).__name__,
                              detail=str(e)[:200],
                              consecutive=self._ctrl_errors)
                flight.dump()
            if self._ctrl_errors >= 3:
                self._controller = None
                if flight is not None:
                    flight.record("controller_detached",
                                  after_errors=self._ctrl_errors)
                    flight.dump()
        else:
            self._ctrl_errors = 0
