"""Control-plane resilience primitives for the message-passing federation
(port of ``fedml_tpu/comm/resilience.py``).

The reference has no failure story at all: its server blocks on every
sampled worker (``check_whether_all_receive``) and its transports each
grew a slightly different hand-rolled retry loop. This module centralizes
the three concerns every backend was solving ad hoc:

- :class:`RetryPolicy` — ONE retry discipline (exponential backoff with
  seeded jitter, per-attempt and total deadlines, a retriable-error
  predicate, visible counters) shared by the transports'
  ``send_message`` paths (TCP here; gRPC and TRPC come with ROADMAP.md
  A10d). Backends keep their *parameters* (first-contact
  sends tolerate peers that haven't bound yet; established peers fail
  fast) but no longer their own loops.
- :class:`ChaosTransport` / :class:`ChaosSpec` — a fault-injecting
  wrapper implementing the full ``BaseCommunicationManager`` surface over
  any real backend: seeded, DETERMINISTIC message drop, delay,
  duplication, reordering, and one-way partitions. Fault decisions are
  keyed on message identity (type, sender, receiver, round tag,
  occurrence), not on wall-clock or thread interleaving, so a drill
  replays identically under the same seed. Because the wrapper sits
  *above* the real transport, every drill exercises the same serialize/
  send/receive code paths production uses.
- :class:`HeartbeatSender` — the client-side beat loop: a daemon thread
  that sends a lightweight liveness message every ``interval_s`` while
  local training keeps the worker silent, plus an optional idle timeout
  that bounds a worker's lifetime when the server disappears (crash-stop
  servers must not leave workers blocked on a receive loop forever).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, Optional, Set, Tuple

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message


class RetryGiveUp(ConnectionError):
    """Raised when a RetryPolicy exhausts its attempts or deadline; the
    last underlying error is chained as ``__cause__``."""


class RetryPolicy:
    """Unified retry discipline: exponential backoff with deterministic
    seeded jitter, bounded by ``max_attempts`` AND ``total_deadline_s``.

    ``run(fn, retriable=...)`` calls ``fn()`` until it returns; an
    exception for which ``retriable(err)`` is falsy propagates
    immediately, a retriable one sleeps ``backoff_s * multiplier**k``
    (capped at ``max_backoff_s``, jittered by ±``jitter`` fraction) and
    tries again. ``attempt_timeout_s`` is advisory per-attempt budget for
    transports that support one (gRPC call timeout, TRPC connect
    timeout) — the policy carries it so it stops being a magic constant
    buried in each backend.

    Counters (``retries``, ``giveups``) are cumulative over the policy's
    lifetime; the comm managers surface them per federation round.
    """

    def __init__(self, max_attempts: int = 3, backoff_s: float = 0.25,
                 multiplier: float = 2.0, max_backoff_s: float = 2.0,
                 jitter: float = 0.1, total_deadline_s: Optional[float] = None,
                 attempt_timeout_s: Optional[float] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.multiplier = multiplier
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.total_deadline_s = total_deadline_s
        self.attempt_timeout_s = attempt_timeout_s
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        self.retries = 0
        self.giveups = 0

    @classmethod
    def first_contact(cls, **kw) -> "RetryPolicy":
        """Cross-silo processes start in any order, so the first sends to
        a peer may race its bind — retry generously (the reference's MPI
        launcher sidesteps this with mpirun's barrier start)."""
        kw.setdefault("max_attempts", 21)
        kw.setdefault("backoff_s", 0.25)
        kw.setdefault("multiplier", 1.6)
        kw.setdefault("max_backoff_s", 2.0)
        kw.setdefault("total_deadline_s", 30.0)
        return cls(**kw)

    @classmethod
    def established(cls, **kw) -> "RetryPolicy":
        """Once a peer has been reached, a failure is real: one quick
        reconnect attempt, then surface — a crashed silo must be visible
        in ~0 s, not after a multi-second retry window per message."""
        kw.setdefault("max_attempts", 2)
        kw.setdefault("backoff_s", 0.0)
        return cls(**kw)

    def backoff_for(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based), jittered."""
        base = min(self.backoff_s * (self.multiplier ** (attempt - 1)),
                   self.max_backoff_s)
        if base <= 0.0 or self.jitter <= 0.0:
            return max(base, 0.0)
        return base * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))

    def run(self, fn: Callable[[], object],
            retriable: Callable[[BaseException], bool] = lambda e: True,
            describe: str = "operation"):
        start = self._clock()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except BaseException as err:  # noqa: BLE001 — predicate decides
                last = err
                if not retriable(err):
                    raise
                if attempt >= self.max_attempts:
                    break
                pause = self.backoff_for(attempt)
                if (self.total_deadline_s is not None
                        and self._clock() - start + pause > self.total_deadline_s):
                    break
                self.retries += 1
                if pause > 0.0:
                    self._sleep(pause)
        self.giveups += 1
        raise RetryGiveUp(
            f"{describe} failed after {min(attempt, self.max_attempts)} "
            f"attempt(s)") from last


def _mix(*vals: int) -> int:
    """Stable integer hash of a tuple of ints (PYTHONHASHSEED-proof)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = ((h ^ (v & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class ChaosSpec:
    """Shared fault configuration + counters for a ChaosTransport fleet.

    One spec instance is shared by every rank's wrapper, so runtime
    partition flips (``partition`` / ``heal``) are visible federation-wide
    and the counters aggregate the whole drill. Probabilities are
    evaluated per message from a stream keyed on (seed, message identity,
    occurrence index) — deterministic under thread interleaving.
    """

    seed: int = 0
    drop_p: float = 0.0
    dup_p: float = 0.0
    delay_p: float = 0.0
    max_delay_s: float = 0.05
    reorder_p: float = 0.0
    partitions: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {
            "sent": 0, "dropped": 0, "duplicated": 0, "delayed": 0,
            "reordered": 0, "partitioned": 0,
        }

    def partition(self, src: int, dst: int) -> None:
        """Install a ONE-WAY partition: src's messages to dst are dropped
        (dst→src still flows; add the mirror pair for a full cut)."""
        with self._lock:
            self.partitions.add((src, dst))

    def heal(self, src: Optional[int] = None, dst: Optional[int] = None) -> None:
        """Remove matching partitions (None = wildcard)."""
        with self._lock:
            self.partitions = {
                (s, d) for (s, d) in self.partitions
                if not ((src is None or s == src) and (dst is None or d == dst))
            }

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] += n


class ChaosTransport(BaseCommunicationManager):
    """Fault-injecting wrapper over any real comm backend.

    Send-side faults only (a dropped *send* and a dropped *receive* are
    indistinguishable to the protocol): drop, duplicate, delay, reorder,
    one-way partitions, per :class:`ChaosSpec`. Self-addressed messages
    (receiver == own rank — the server manager's watchdog ticks) never
    cross the network and bypass injection, as does everything when the
    spec is all-zeros. Receive side, observers, and shutdown delegate to
    the wrapped manager, so a drill runs the production code paths.
    """

    def __init__(self, inner: BaseCommunicationManager, spec: ChaosSpec,
                 rank: int, after: Optional[Callable] = None):
        self.inner = inner
        self.spec = spec
        self.rank = rank
        # Deferred-delivery scheduler override: ``after(delay_s, fn)``.
        # Default is a real threading.Timer; the virtual-clock fleet
        # simulator (fedml_tpu_torch.sim) injects its event queue here so the
        # delay/reorder faults fire in deterministic virtual-time order
        # instead of racing wall-clock timers.
        self._after_fn = after
        self._occurrence: Dict[Tuple, int] = {}
        # receiver -> (reordered msg, copies): duplication drawn for a
        # held message applies when it is finally shipped, so the
        # 'duplicated' counter never overstates what the wire saw.
        self._held: Dict[int, Tuple[Message, int]] = {}
        # receiver -> hold generation: each safety-flush timer captures
        # the generation it was armed for, so a stale timer (its hold
        # already shipped via the normal swap path) cannot flush a LATER
        # held message early and undo that reorder.
        self._held_gen: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._timers: list = []
        self._closed = False

    # Expose the wrapped backend's resolved port / retry / byte counters.
    @property
    def port(self) -> int:
        return self.inner.port

    @property
    def retry_count(self) -> int:
        return getattr(self.inner, "retry_count", 0)

    @property
    def bytes_ledger(self):
        """The wrapped backend's ByteLedger (None on backends without
        wire serialization): a chaos drill's byte accounting must read
        what actually crossed the wire — dropped sends never serialize,
        duplicates serialize twice."""
        return getattr(self.inner, "bytes_ledger", None)

    def inbox_depth(self):
        """Delegate the ingest-queue-depth gauge to the wrapped backend
        (None where it has no observable inbox)."""
        inner = getattr(self.inner, "inbox_depth", None)
        return inner() if inner is not None else None

    def _key(self, msg: Message) -> Tuple[int, int, int, int]:
        tag = msg.get("round")
        if tag is None:
            tag = msg.get("model_version", -1)
        try:
            t = int(msg.get_type())
        except (TypeError, ValueError):
            t = 0
        return (t, int(msg.get_sender_id()), int(msg.get_receiver_id()),
                int(tag) if tag is not None else -1)

    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        if receiver == self.rank:
            self.inner.send_message(msg)  # local control tick: no network
            return
        spec = self.spec
        if not (spec.drop_p or spec.dup_p or spec.delay_p
                or spec.reorder_p or spec.partitions):
            # All-zeros spec: true pass-through — no occurrence
            # bookkeeping (which grows one entry per round/peer/type for
            # the life of the federation), no lock, no RNG construction.
            # A hold armed before the spec was zeroed must still release
            # behind this send, or it waits out its safety timer.
            self.inner.send_message(msg)
            if self._held:
                with self._lock:
                    held = self._held.pop(receiver, None)
                if held is not None:
                    self._ship(*held)
            return
        key = self._key(msg)
        with self._lock:
            partitioned = (self.rank, receiver) in self.spec.partitions
            if not partitioned:
                occ = self._occurrence.get(key, 0)
                self._occurrence[key] = occ + 1
        if partitioned:
            self.spec.count("partitioned")
            self.spec.count("dropped")
            return
        rng = random.Random(_mix(self.spec.seed, *key, occ))
        self.spec.count("sent")
        if rng.random() < self.spec.drop_p:
            self.spec.count("dropped")
            return
        copies = 1
        if rng.random() < self.spec.dup_p:
            copies = 2
            self.spec.count("duplicated")
        if rng.random() < self.spec.reorder_p:
            # Hold this message; it ships right AFTER the next message to
            # the same receiver (a pairwise swap — the minimal reordering).
            # A duplicate drawn above rides along when it ships.
            self.spec.count("reordered")
            with self._lock:
                prev = self._held.get(receiver)
                self._held[receiver] = (msg, copies)
                gen = self._held_gen.get(receiver, 0) + 1
                self._held_gen[receiver] = gen
            if prev is not None:
                self._ship(*prev)
            # Safety flush: if no later message ever flows to this
            # receiver, deliver after max_delay_s rather than never.
            self._after(self.spec.max_delay_s,
                        lambda r=receiver, g=gen: self._flush_held(r, g))
            return
        held = None
        with self._lock:
            held = self._held.pop(receiver, None)
        for _ in range(copies):
            if rng.random() < self.spec.delay_p:
                self.spec.count("delayed")
                self._after(rng.random() * self.spec.max_delay_s,
                            lambda m=msg: self._late_send(m))
            else:
                self.inner.send_message(msg)
        if held is not None:
            self._ship(*held)

    def _ship(self, msg: Message, copies: int) -> None:
        for _ in range(copies):
            self.inner.send_message(msg)

    def _flush_held(self, receiver: int, gen: Optional[int] = None) -> None:
        with self._lock:
            if gen is not None and self._held_gen.get(receiver) != gen:
                return  # stale safety timer: that hold was already shipped
            held = self._held.pop(receiver, None)
        if held is not None:
            msg, copies = held
            for _ in range(copies):
                self._late_send(msg)

    def _late_send(self, msg: Message) -> None:
        if self._closed:
            return
        try:
            self.inner.send_message(msg)
        except (ConnectionError, OSError):
            pass  # late delivery to a dead peer: genuine loss

    def _after(self, delay_s: float, fn) -> None:
        if self._after_fn is not None:
            self._after_fn(max(delay_s, 1e-4), fn)
            return
        t = threading.Timer(max(delay_s, 1e-4), fn)
        t.daemon = True
        with self._lock:
            self._timers = [x for x in self._timers if x.is_alive()]
            self._timers.append(t)
        t.start()

    # -- delegation ---------------------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        self.inner.add_observer(observer)

    def remove_observer(self, observer: Observer) -> None:
        self.inner.remove_observer(observer)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.inner.stop_receive_message()

    def close(self) -> None:
        self._closed = True
        with self._lock:
            timers, self._timers = self._timers, []
        for t in timers:
            t.cancel()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


class HeartbeatSender:
    """Client-side liveness loop: calls ``send_beat()`` every
    ``interval_s`` on a daemon thread so a worker stays visibly alive to
    the server's HeartbeatMonitor while a long local round keeps it
    silent on the upload path. ``touch()`` records server contact; with
    ``idle_timeout_s > 0``, ``on_idle()`` fires (once) when the server
    has been silent that long — bounding the worker's lifetime when the
    server crashed or the done message was lost."""

    def __init__(self, send_beat: Callable[[], None], interval_s: float,
                 idle_timeout_s: float = 0.0,
                 on_idle: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._send_beat = send_beat
        self.interval_s = interval_s
        self.idle_timeout_s = idle_timeout_s
        self._on_idle = on_idle
        self._clock = clock
        self._last_contact = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def touch(self) -> None:
        self._last_contact = self._clock()

    def start(self) -> None:
        if self._thread is not None or (
                self.interval_s <= 0 and self.idle_timeout_s <= 0):
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        period = self.interval_s if self.interval_s > 0 else max(
            self.idle_timeout_s / 4, 0.05)
        while not self._stop.wait(period):
            if (self.idle_timeout_s > 0
                    and self._clock() - self._last_contact > self.idle_timeout_s):
                self._stop.set()
                if self._on_idle is not None:
                    self._on_idle()
                return
            if self.interval_s > 0:
                try:
                    self._send_beat()
                except (ConnectionError, OSError):
                    pass  # server mid-restart: the beat is best-effort
