"""Metrics registry: counters, gauges, log-bucketed histograms (port of
``fedml_tpu/obs/registry.py``, which is stdlib-only; copied so the port
imports nothing of ``fedml_tpu``).

Bucket math: log-spaced buckets with ratio ``growth`` (default 2**0.25 ≈
1.19, ≤ ~9% relative quantile error). Bucket 0 absorbs everything at or
below ``lo``; bucket ``i ≥ 1`` covers ``(lo·g^(i-1), lo·g^i]``.
Percentiles return the geometric midpoint of the selected bucket, clamped
to the observed min/max. The serving plane's ``serve/*`` names are read
from :meth:`MetricsRegistry.snapshot`.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional


class Counter:
    """Monotone event counter. Single-writer by design (the dispatch
    thread); reads from other threads see a consistent int."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value-wins instantaneous reading (queue depth, buffer fill)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed histogram of a positive-valued stream.

    ``record`` is O(1): one ``log`` plus a dict increment. Values at or
    below ``lo`` (including zero/negative — a sub-resolution duration)
    land in bucket 0 and estimate as the observed minimum.
    """

    def __init__(self, lo: float = 1e-3, growth: float = 2.0 ** 0.25):
        if lo <= 0 or growth <= 1:
            raise ValueError(f"need lo > 0 and growth > 1, got {lo}, {growth}")
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.lo:
            i = 0
        else:
            i = 1 + int(math.floor(math.log(v / self.lo) / self._log_g - 1e-12))
        self._buckets[i] = self._buckets.get(i, 0) + 1

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (q in [0, 100]): geometric midpoint
        of the bucket holding the rank, clamped to the observed range."""
        if not self.count:
            return None
        rank = min(max(int(math.ceil(q / 100.0 * self.count)), 1), self.count)
        cum = 0
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            if cum >= rank:
                if i == 0:
                    est = self.min
                else:
                    est = self.lo * self.growth ** (i - 0.5)
                return min(max(est, self.min), self.max)
        return self.max  # unreachable; defensive

    def snapshot(self) -> Dict[str, Optional[float]]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": round(self.mean, 6),
            "p50": round(self.percentile(50), 6),
            "p95": round(self.percentile(95), 6),
            "max": round(self.max, 6),
        }


class MetricsRegistry:
    """Named metric namespace. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, so call sites never coordinate);
    ``snapshot`` flattens everything into one dict of scalars, ready for
    ``MetricsLogger.log(..., prefix="ctrl")``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, lo: float = 1e-3,
                  growth: float = 2.0 ** 0.25) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(lo=lo, growth=growth)
            return h

    def snapshot(self) -> Dict[str, object]:
        """Flat scalars: ``<counter>``, ``<gauge>``, and per histogram
        ``<name>_count/_mean/_p50/_p95/_max``. Empty metrics are omitted
        so a quiet subsystem adds no noise to the ctrl/ stream."""
        out: Dict[str, object] = {}
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        for name, c in counters:
            out[name] = c.value
        for name, g in gauges:
            if g.value is not None:
                out[name] = g.value
        for name, h in hists:
            if h.count:
                for k, v in h.snapshot().items():
                    out[f"{name}_{k}"] = v
        return out
