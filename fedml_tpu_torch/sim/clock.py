"""Virtual time: a monotone clock plus a deterministic event queue (port
of ``fedml_tpu/sim/clock.py``).

The control-plane managers already take ``clock=`` (HeartbeatMonitor,
FedAVGServerManager, FedAsyncServerManager), so a fleet drill can run on
simulated seconds: the event queue pops callbacks in (time, insertion)
order and advances the clock to each event's timestamp — no sleeping, no
thread races, and the same seed replays the same schedule event for
event. Ties break on insertion order, which is itself deterministic
because the whole simulation is single-threaded.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple


class VirtualClock:
    """Monotone simulated time; pass the instance itself as ``clock=``
    (it is callable, matching ``time.monotonic``'s signature)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now - 1e-9:
            raise ValueError(f"clock cannot run backwards: {t} < {self._now}")
        self._now = max(self._now, float(t))


class EventQueue:
    """Deterministic discrete-event scheduler over a :class:`VirtualClock`.

    ``after(dt, fn)`` / ``at(t, fn)`` enqueue; ``step()`` pops the
    earliest event, advances the clock to it, and runs it (events it
    enqueues land back in the queue). Exceptions propagate — a failing
    handler should fail the drill, not vanish on a daemon thread."""

    def __init__(self, clock: VirtualClock):
        self.clock = clock
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap,
                       (max(float(t), self.clock.now), next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.now + max(float(dt), 0.0), fn)

    def next_time(self) -> float:
        if not self._heap:
            raise IndexError("empty event queue")
        return self._heap[0][0]

    def step(self) -> None:
        t, _, fn = heapq.heappop(self._heap)
        self.clock.advance_to(t)
        fn()
