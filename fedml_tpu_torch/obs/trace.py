"""Span tracing (port of ``fedml_tpu/obs/trace.py``'s tracer half, which
is stdlib-only; copied so the port imports nothing of ``fedml_tpu``).

- :class:`SpanTracer` collects complete ("X") events over an injected
  monotonic clock and dumps Chrome trace-event JSON or JSONL.
- :data:`NULL` / :class:`NullTracer` is the disabled path: ``active()``
  returns it when nothing is installed, and every call is a no-op.

The tracer is installed process-globally (``install``, or ``using`` for a
scoped install), so the serving plane traces without a tracer handle in
every constructor.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The traced-off path: every method a no-op. Falsy, so call sites
    that must avoid even building a kwargs dict can guard with
    ``if tracer:``."""

    enabled = False

    def __bool__(self):
        return False

    def now(self) -> float:
        return 0.0

    def span(self, name, cat="", corr=None, **args):
        return _NULL_SPAN

    def complete(self, name, t0, t1=None, cat="", corr=None, **args):
        pass

    def instant(self, name, cat="", corr=None, **args):
        pass


NULL = NullTracer()
_ACTIVE = NULL
_INSTALL_LOCK = threading.Lock()


def active():
    """The installed tracer, or :data:`NULL` — ALWAYS safe to call."""
    return _ACTIVE


def install(tracer) -> None:
    """Install ``tracer`` process-wide (``None`` disables)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = tracer if tracer is not None else NULL


@contextlib.contextmanager
def using(tracer):
    """Scoped install/restore — the test/drill idiom."""
    prev = _ACTIVE
    install(tracer)
    try:
        yield tracer
    finally:
        install(prev)


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tr, name, cat, args):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = self._tr.now()
        return self

    def __exit__(self, *exc):
        self._tr.complete(self.name, self._t0, cat=self.cat,
                          **(self.args or {}))
        return False


class SpanTracer:
    """Collects trace events in memory; dump at end of run.

    ``clock`` is any zero-arg monotone callable — ``time.perf_counter``
    for wall-clock runs, a ``sim.VirtualClock`` instance for virtual-time
    fleet drills (timestamps are then virtual seconds). Timestamps are
    recorded relative to the tracer's construction instant, in
    microseconds (the Chrome trace-event unit). Bounded: past
    ``max_events`` new events are counted in ``dropped`` instead of
    stored, so a long run cannot OOM the tracer."""

    enabled = True

    def __init__(self, clock=time.perf_counter, max_events: int = 200_000):
        self.clock = clock
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tids: Dict[int, int] = {}
        self.dropped = 0
        self._t0 = float(clock())
        self._pid = os.getpid()

    def now(self) -> float:
        return float(self.clock())

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- recording -----------------------------------------------------------
    def span(self, name, cat="", corr=None, **args):
        """Context manager timing its body as one complete ("X") event."""
        if corr:
            args.update(corr)
        return _Span(self, name, cat, args)

    def complete(self, name, t0, t1=None, cat="", corr=None, **args):
        """One complete event from an explicit start time — the form for
        spans whose start and end live on different callbacks (a sim
        message in flight: posted at t0, delivered now)."""
        if t1 is None:
            t1 = self.now()
        if corr:
            args.update(corr)
        self._emit({"name": name, "cat": cat or "span", "ph": "X",
                    "ts": round((float(t0) - self._t0) * 1e6, 3),
                    "dur": round(max(float(t1) - float(t0), 0.0) * 1e6, 3),
                    "pid": self._pid, "tid": self._tid(), "args": args})

    def instant(self, name, cat="", corr=None, **args):
        if corr:
            args.update(corr)
        self._emit({"name": name, "cat": cat or "event", "ph": "i",
                    "ts": round((self.now() - self._t0) * 1e6, 3),
                    "s": "t", "pid": self._pid, "tid": self._tid(),
                    "args": args})

    # -- reading / dumping ---------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object format (Perfetto /
        ``chrome://tracing`` loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dump_chrome(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def dump_jsonl(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")
        return path
