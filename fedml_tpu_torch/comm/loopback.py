"""In-memory loopback backend (port of ``fedml_tpu/comm/loopback.py``).

The fake/test backend the reference never had (SURVEY.md §4.6 — its nearest
substitute is running real ``mpirun`` on one machine). A
``LoopbackNetwork`` owns one queue per rank; managers send by enqueueing
directly to the receiver's queue and receive by blocking on their own —
event-driven, unlike the reference's MPI manager which polls its receive
queue every 0.3 s (mpi/com_manager.py:78). Messages are delivered by
reference (no serialization) which also makes this the fastest possible
single-host multi-worker transport; use ``Message.to_json`` round-trip in
tests to exercise the wire format.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.wire import (ByteLedger, WIRE_FORMATS,
                                 deserialize_message, serialize_message)

_STOP = object()


class LoopbackNetwork:
    """Shared router: one inbox per rank. Thread-safe.

    ``wire`` (default ``"none"``): with a real wire format name
    (``tensor`` | ``json`` | ``pickle``) every message is serialized by
    the sender and deserialized by the receiver — BYTES sit in the
    inboxes, each manager's :class:`ByteLedger` counts them, and the
    single-host drill exercises the exact frame code the socket backends
    ship. The default keeps delivery by reference (the fastest possible
    transport, zero serialization)."""

    def __init__(self, size: int, wire: str = "none"):
        if wire not in ("none",) + WIRE_FORMATS:
            raise ValueError(f"unknown loopback wire format {wire!r}")
        self.size = size
        self.wire = wire
        self._inboxes: List[queue.Queue] = [queue.Queue() for _ in range(size)]

    def post(self, receiver_id: int, msg) -> None:
        self._inboxes[receiver_id].put(msg)

    def inbox(self, rank: int) -> queue.Queue:
        return self._inboxes[rank]


class LoopbackCommManager(BaseCommunicationManager):
    def __init__(self, network: LoopbackNetwork, rank: int):
        self.network = network
        self.rank = rank
        self.size = network.size
        self.bytes_ledger = ByteLedger()
        self._observers: List[Observer] = []
        self._running = False
        self._stop_requested = False

    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        if self.network.wire != "none":
            blob = serialize_message(msg, self.network.wire)
            self.bytes_ledger.count_tx(receiver, len(blob))
            self.network.post(receiver, blob)
            return
        self.network.post(receiver, msg)

    def inbox_depth(self) -> int:
        """Messages waiting in this rank's inbox — the ingest-queue-depth
        gauge the server's metrics registry samples per upload
        (docs/OBSERVABILITY.md). Approximate by nature (qsize races the
        receive loop), which is fine for a gauge."""
        return self.network.inbox(self.rank).qsize()

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        # Stop-before-start: the _STOP sentinel is already queued, but the
        # latch also covers it without draining whatever preceded it.
        self._running = not self._stop_requested
        inbox = self.network.inbox(self.rank)
        while self._running:
            msg = inbox.get()
            if msg is _STOP:
                break
            if isinstance(msg, (bytes, bytearray)):  # wire round-trip mode
                nbytes = len(msg)
                msg = deserialize_message(msg, self.network.wire)
                self.bytes_ledger.count_rx(int(msg.get_sender_id()), nbytes)
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)

    def stop_receive_message(self) -> None:
        self._stop_requested = True  # latched: stop-before-start must hold
        self._running = False
        self.network.post(self.rank, _STOP)


def run_workers(worker_fns) -> None:
    """Run one callable per rank on daemon threads and join them all.
    Single-host analogue of ``mpirun -np N`` (run_fedavg_distributed_pytorch
    .sh:21); an exception in any worker is re-raised in the caller as soon
    as that worker has ended: its peers may wait for it forever (a server
    that awaits a dead silo's upload, a silo that awaits a dead server's
    reply), so they are left on their daemon threads."""
    errors: Dict[int, BaseException] = {}
    failed = threading.Event()

    def wrap(i, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                errors[i] = e
                failed.set()

        return run

    threads = [
        threading.Thread(target=wrap(i, fn), daemon=True)
        for i, fn in enumerate(worker_fns)
    ]
    for t in threads:
        t.start()
    for t in threads:
        while t.is_alive() and not failed.is_set():
            t.join(timeout=0.05)
        if failed.is_set():
            break
    if errors:
        rank, err = sorted(errors.items())[0]
        raise RuntimeError(f"worker rank {rank} failed") from err
