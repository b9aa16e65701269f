"""Fleet traces: seeded arrival/availability/speed schedules (port of
``fedml_tpu/sim/trace.py``).

A trace answers three questions about every device, entirely ahead of
time (so a drill is replayable and two runs with one seed are
identical):

- **When does it exist?** Each device ARRIVES once (staggered joins over
  ``arrival_spread_s``) and is offline before that.
- **When is it reachable?** Availability is drawn per ``slot_s`` slot
  from a diurnal-modulated Bernoulli — ``mean_online`` scaled by a
  sinusoid of ``diurnal_period_s`` with per-device phase, the canonical
  cross-device pattern (phones charge at night in their own timezones).
  Consecutive online slots merge into windows; a window edge landing
  inside a device's training interval IS the mid-round churn the
  buffered tier is built for.
- **How fast is it?** Per-device TIME multipliers are power-law
  (Pareto(``speed_alpha``), support [1, inf)): most phones are fine, the
  tail is brutally slow — the straggler distribution first-k and
  buffered aggregation react to. Per-task lognormal jitter
  (``compute_jitter``) models thermal/load variance.

Randomness is keyed per (seed, stream, device, draw-index) through a
stable integer mix — no global RNG order dependence, so adding a stream
never reshuffles another's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# The PYTHONHASHSEED-proof integer mix ChaosTransport keys its fault
# streams on — shared, not copied, so the two keying schemes cannot
# drift apart. It is the JAX package's mix bit for bit, so one spec gives
# the JAX package's trace, float for float.
from fedml_tpu_torch.comm.resilience import _mix

# Stream tags (arbitrary distinct constants).
_S_ARRIVAL = 1
_S_SPEED = 2
_S_AVAIL = 3
_S_PHASE = 4
_S_COMPUTE = 5


def _rng(seed: int, *key: int) -> np.random.RandomState:
    return np.random.RandomState(_mix(seed, *key) % (2 ** 31))


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Everything that defines a fleet trace. Frozen: a spec + seed IS
    the trace identity (the determinism tests pin that)."""

    n_devices: int = 8
    seed: int = 0
    horizon_s: float = 3600.0        # virtual length of the trace
    arrival_spread_s: float = 120.0  # device joins uniform in [0, spread)
    slot_s: float = 120.0            # availability decision granularity
    mean_online: float = 0.85        # base per-slot availability
    diurnal_amplitude: float = 0.0   # 0 = flat, 1 = full day/night swing
    diurnal_period_s: float = 86400.0
    base_round_s: float = 30.0       # local round on a speed-1 device
    speed_alpha: float = 2.0         # Pareto shape of the TIME multiplier
    max_speed_mult: float = 20.0     # clamp the Pareto tail
    compute_jitter: float = 0.1      # lognormal sigma per (device, task)
    wire_latency_s: float = 0.5      # one-way control/model hop
    # Load spike: every local round whose training STARTS inside
    # [spike_t0, spike_t1) takes spike_factor x as long — a fleet-wide
    # thermal/contention event, the staleness-cliff stimulus the
    # adaptive controller (fedml_tpu_torch.ctrl) is drilled against. The
    # defaults are exact no-ops (x1.0 is bit-exact in float), so every
    # pre-spike trace digest is unchanged.
    spike_t0: float = -1.0
    spike_t1: float = -1.0
    spike_factor: float = 1.0


class FleetTrace:
    """Materialized trace: per-device online windows + speed multipliers.
    Device ids are the message-passing RANKS 1..n_devices (rank 0 is the
    server, always online)."""

    def __init__(self, spec: FleetSpec):
        self.spec = spec
        self.arrivals: Dict[int, float] = {}
        self.speeds: Dict[int, float] = {}
        self.windows: Dict[int, List[Tuple[float, float]]] = {}
        for r in range(1, spec.n_devices + 1):
            self.arrivals[r] = float(
                _rng(spec.seed, _S_ARRIVAL, r).rand() * spec.arrival_spread_s)
            # Pareto(alpha) on [1, inf): inverse-CDF of a uniform draw.
            u = _rng(spec.seed, _S_SPEED, r).rand()
            self.speeds[r] = float(
                min((1.0 - u) ** (-1.0 / spec.speed_alpha),
                    spec.max_speed_mult))
            self.windows[r] = self._build_windows(r)

    def _build_windows(self, r: int) -> List[Tuple[float, float]]:
        spec = self.spec
        phase = float(_rng(spec.seed, _S_PHASE, r).rand()
                      * spec.diurnal_period_s)
        rng = _rng(spec.seed, _S_AVAIL, r)
        start = self.arrivals[r]
        n_slots = int(np.ceil((spec.horizon_s - start) / spec.slot_s))
        if n_slots <= 0:
            return []
        t = start + np.arange(n_slots) * spec.slot_s
        p = spec.mean_online * (
            1.0 + spec.diurnal_amplitude
            * np.sin(2.0 * np.pi * (t + phase) / spec.diurnal_period_s))
        online = rng.rand(n_slots) < np.clip(p, 0.0, 1.0)
        windows: List[Tuple[float, float]] = []
        for i, flag in enumerate(online):
            s, e = t[i], min(t[i] + spec.slot_s, spec.horizon_s)
            if not flag:
                continue
            if windows and abs(windows[-1][1] - s) < 1e-9:
                windows[-1] = (windows[-1][0], e)
            else:
                windows.append((s, e))
        return windows

    # -- queries -------------------------------------------------------------
    def online_at(self, rank: int, t: float) -> bool:
        if rank == 0:
            return True
        return any(s <= t < e for s, e in self.windows.get(rank, ()))

    def online_through(self, rank: int, t0: float, t1: float) -> bool:
        """True iff the device stays online for the WHOLE interval — a
        window edge inside [t0, t1] is exactly mid-round churn."""
        if rank == 0:
            return True
        return any(s <= t0 and t1 <= e
                   for s, e in self.windows.get(rank, ()))

    def next_online(self, rank: int, t: float) -> Optional[float]:
        if rank == 0:
            return t
        for s, e in self.windows.get(rank, ()):
            if t < e:
                return max(s, t)
        return None

    def compute_time(self, rank: int, task_idx: int) -> float:
        """Virtual seconds of local training for this device's
        ``task_idx``-th assignment: base x power-law device multiplier x
        per-task lognormal jitter. Keyed, so replays are identical."""
        spec = self.spec
        jitter = 1.0
        if spec.compute_jitter > 0:
            jitter = float(np.exp(
                _rng(spec.seed, _S_COMPUTE, rank, task_idx).randn()
                * spec.compute_jitter))
        return spec.base_round_s * self.speeds[rank] * jitter

    def load_factor(self, t: float) -> float:
        """Compute-time multiplier at virtual time ``t`` (the load-spike
        window, 1.0 outside it). Deterministic in (spec, t) — part of
        the trace identity, like every other schedule here."""
        spec = self.spec
        if spec.spike_t0 <= t < spec.spike_t1:
            return spec.spike_factor
        return 1.0

    def online_fraction(self, rank: int) -> float:
        total = sum(e - s for s, e in self.windows.get(rank, ()))
        return total / max(self.spec.horizon_s - self.arrivals[rank], 1e-9)

    def describe(self) -> dict:
        """Summary scalars for bench artifacts."""
        speeds = np.array([self.speeds[r]
                           for r in sorted(self.speeds)], np.float64)
        online = np.array([self.online_fraction(r)
                           for r in sorted(self.windows)], np.float64)
        return {
            "n_devices": self.spec.n_devices,
            "seed": self.spec.seed,
            "horizon_s": self.spec.horizon_s,
            "speed_mult_p50": round(float(np.median(speeds)), 3),
            "speed_mult_max": round(float(speeds.max()), 3),
            "online_fraction_mean": round(float(online.mean()), 3),
            "online_fraction_min": round(float(online.min()), 3),
        }


def make_fleet_trace(spec: FleetSpec) -> FleetTrace:
    return FleetTrace(spec)
