"""Control policies: telemetry in, knob proposals out (port of
``fedml_tpu/ctrl/policy.py``).

A :class:`ControlPolicy` is a pure decision function over a telemetry
snapshot (see :func:`read_telemetry`): it proposes ``{knob: value}``
mutations and never touches a manager directly — the
:class:`FederationController` routes proposals through the manager's
:class:`~fedml_tpu_torch.ctrl.actuator.ActuationSeam`, which owns validation
and boundary discipline. Because policies see only the snapshot dict,
the SAME controller object drives a :class:`~fedml_tpu_torch.sim.FleetSimulator`
run and a real loopback manager run unchanged (the acceptance bar for
this subsystem): telemetry keys are identical in both worlds.

Determinism note: the sim drill pins two-run-identical actuation logs,
so the shipped policies key only on virtually-deterministic signals —
staleness percentiles, eviction counts, progress counters, eval history.
Wall-clock-derived telemetry (dispatch occupancy from ``perf_counter``)
is consumed only by :class:`TimeoutAutoscalePolicy`'s ingest-worker arm,
which real deployments enable and the pinned drills leave cold.

Policy lineage: the guard-band admission controller is the 2307.06561
"steer away from ingest saturation" loop; the window schedule is the
1807.06629 (Parallel Restarted SGD) observation that the averaging
interval should shrink as loss improvement flattens — early in training
a wide window (large ``buffer_k`` / ``aggregate_k``) buys cheap
parallelism, late it only adds averaging error.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, runtime_checkable


def read_telemetry(manager) -> Dict[str, float]:
    """Flatten a server manager's live observability surfaces into the
    flat snapshot dict policies consume.

    Works against any of the three tiers (and their sim twins): missing
    surfaces contribute nothing rather than raising, so one policy runs
    everywhere. Keys:

    - ``progress``: monotone protocol step — async/fedbuff model
      ``version``, sync completed-round count. The controller's cadence
      and cooldowns count in this unit, not wall time.
    - ``staleness_p95`` / ``staleness_p50``: tail of the recent OFFERED
      staleness window (the async tiers' bounded deque — admitted or
      not, so an armed admission cap cannot blind the loop to offered
      load). Falls back to the cumulative registry histogram when the
      manager keeps no window; cumulative percentiles cannot recover
      after a spike ends, so windowed is strongly preferred.
    - ``evictions`` / ``guard_drops`` / ``admission_drops``: ``health()``.
    - ``accuracy`` / ``loss``: latest server-side eval sample.
    - ``occupancy``: dispatch-thread busy fraction (wall-clock; see
      module note).
    """
    t: Dict[str, float] = {}
    version = getattr(manager, "version", None)
    if version is not None:
        t["progress"] = float(version)
    else:
        t["progress"] = float(getattr(manager, "round_idx", 0))
    recent = getattr(manager, "_stale_recent", None)
    if recent:
        vals = sorted(recent)
        n = len(vals)
        t["staleness_p95"] = float(vals[min(n - 1, int(0.95 * (n - 1) + 0.5))])
        t["staleness_p50"] = float(vals[n // 2])
    else:
        reg = getattr(manager, "registry", None)
        if reg is not None:
            try:
                h = reg.histogram("staleness")
                if h.count:
                    t["staleness_p95"] = float(h.percentile(95))
                    t["staleness_p50"] = float(h.percentile(50))
            except Exception:
                pass
    health = getattr(manager, "health", None)
    if callable(health):
        try:
            hd = health()
        except Exception:
            hd = {}
        for key in ("evictions", "guard_drops", "admission_drops",
                    "buffer_depth", "rounds_completed", "live_workers"):
            if key in hd:
                t[key] = float(hd[key])
    profile = getattr(manager, "ingest_profile", None)
    if callable(profile):
        try:
            p = profile()
            if p.get("ingest_occupancy") is not None:
                t["occupancy"] = float(p["ingest_occupancy"])
        except Exception:
            pass
    hist = getattr(manager, "test_history", None)
    if hist is None:
        agg = getattr(manager, "aggregator", None)
        hist = getattr(agg, "test_history", None)
    if hist:
        last = hist[-1]
        if isinstance(last, dict):
            for src, dst in (("test_acc", "accuracy"), ("accuracy", "accuracy"),
                             ("test_loss", "loss"), ("loss", "loss")):
                if src in last and dst not in t:
                    t[dst] = float(last[src])
    return t


@runtime_checkable
class ControlPolicy(Protocol):
    """One feedback loop: ``propose`` maps a telemetry snapshot to knob
    requests. Policies must be deterministic functions of the snapshot
    stream (internal state is fine; entropy is not)."""

    name: str

    def reset(self) -> None:
        """Forget accumulated state (called when the controller binds to
        a new manager — sim-tuned policies then drive a real run from a
        clean slate)."""

    def propose(self, telemetry: Dict[str, float],
                knobs: Dict[str, float]) -> Dict[str, float]:
        """Return ``{knob_name: target_value}`` — empty dict for "no
        change". ``knobs`` holds current values for the bound manager's
        actual knob surface; proposals for knobs absent from it are
        dropped by the controller, so one policy can serve tiers with
        different surfaces."""


class StalenessAdmissionPolicy:
    """Guard-band admission control on the staleness p95 tail.

    While ``staleness_p95`` stays inside ``[band_lo, band_hi]`` nothing
    moves. A breach above ``band_hi`` is the 2307.06561 saturation
    signature — arrivals are aging faster than the server commits — so
    the policy *slows the version clock and sheds the tail*: it raises
    ``buffer_k`` one step toward ``k_max`` (staleness is measured in
    versions; fewer flushes per arrival directly shrinks the tail) and
    arms/tightens the ``max_staleness`` admission cap at
    ``ceil(band_hi) + cap_slack`` so hopeless stragglers are refused at
    the door instead of poisoning the buffer. On recovery below
    ``band_lo`` it relaxes one step back toward the configured baseline
    and disarms the cap last. ``cooldown`` progress units must elapse
    between actuations so the loop cannot thrash faster than telemetry
    responds.
    """

    def __init__(self, band_lo: float = 2.0, band_hi: float = 6.0, *,
                 k_max: int = 8, cap_slack: int = 2, cooldown: int = 4):
        if not 0.0 <= band_lo < band_hi:
            raise ValueError(
                f"guard band must satisfy 0 <= lo < hi, got [{band_lo}, {band_hi}]")
        self.name = "staleness_admission"
        self.band_lo = float(band_lo)
        self.band_hi = float(band_hi)
        self.k_max = int(k_max)
        self.cap_slack = int(cap_slack)
        self.cooldown = int(cooldown)
        self.reset()

    def reset(self) -> None:
        self._baseline_k: Optional[int] = None
        self._last_actuation = float("-inf")

    def propose(self, telemetry, knobs):
        p95 = telemetry.get("staleness_p95")
        if p95 is None:
            return {}
        progress = telemetry.get("progress", 0.0)
        if progress - self._last_actuation < self.cooldown:
            return {}
        out: Dict[str, float] = {}
        k = knobs.get("buffer_k")
        if k is not None and self._baseline_k is None:
            self._baseline_k = int(k)
        cap = knobs.get("max_staleness")
        if p95 > self.band_hi:
            if k is not None and k < self.k_max:
                out["buffer_k"] = int(k) + 1
            if cap is not None:
                want = int(-(-self.band_hi // 1)) + self.cap_slack
                if cap == 0 or cap > want:
                    out["max_staleness"] = want
        elif p95 < self.band_lo:
            if k is not None and self._baseline_k is not None \
                    and k > self._baseline_k:
                out["buffer_k"] = int(k) - 1
            elif cap is not None and cap != 0:
                # cap disarms only once buffer_k is back at baseline —
                # relax in reverse order of tightening
                out["max_staleness"] = 0
        if out:
            self._last_actuation = progress
        return out


class WindowSchedulePolicy:
    """1807.06629-style averaging-window schedule on eval improvement.

    Tracks the improvement rate of the monitored eval metric per unit of
    progress between consecutive eval samples. While the rate stays at or
    above ``rate_thresh`` (training is still earning its parallelism) the
    window knob — ``buffer_k`` on the buffered tier, ``aggregate_k`` on
    sync — is pushed one step toward ``w_max``; once improvement
    flattens it decays one step toward ``w_min`` per eval sample, since
    further delaying averaging only accumulates divergence. Acts only on
    fresh eval samples, so its cadence is the eval frequency, not the
    controller interval."""

    def __init__(self, *, w_min: int = 1, w_max: int = 8,
                 rate_thresh: float = 0.01, metric: str = "accuracy"):
        if not 1 <= w_min <= w_max:
            raise ValueError(f"need 1 <= w_min <= w_max, got [{w_min}, {w_max}]")
        self.name = "window_schedule"
        self.w_min = int(w_min)
        self.w_max = int(w_max)
        self.rate_thresh = float(rate_thresh)
        self.metric = metric
        self.reset()

    def reset(self) -> None:
        self._last_metric: Optional[float] = None
        self._last_progress: Optional[float] = None

    def propose(self, telemetry, knobs):
        m = telemetry.get(self.metric)
        if m is None:
            return {}
        progress = telemetry.get("progress", 0.0)
        if self._last_metric is None:
            self._last_metric, self._last_progress = m, progress
            return {}
        if progress <= self._last_progress:
            return {}  # same eval sample as last step
        rate = (m - self._last_metric) / (progress - self._last_progress)
        if self.metric == "loss":
            rate = -rate
        self._last_metric, self._last_progress = m, progress
        window = "buffer_k" if "buffer_k" in knobs else "aggregate_k"
        w = knobs.get(window)
        if w is None:
            return {}
        if rate >= self.rate_thresh and w < self.w_max:
            return {window: int(w) + 1}
        if rate < self.rate_thresh and w > self.w_min:
            return {window: int(w) - 1}
        return {}


class TimeoutAutoscalePolicy:
    """Round-timeout and ingest-worker autoscaling on eviction rate and
    dispatch occupancy.

    Evictions since the last step mean the watchdog deadline is cutting
    into the live tail: grow ``round_timeout_s`` by ``grow`` (bounded by
    ``timeout_cap`` × the initial value). After ``calm_steps``
    eviction-free steps it shrinks by the same factor back toward the
    initial value — a spike should not permanently inflate the deadline.
    Separately, sustained dispatch ``occupancy`` above ``occ_hi`` adds
    one ingest worker per step up to ``workers_max`` (grow-only; the
    pool refuses shrink). The occupancy arm is wall-clock-driven and
    therefore inert in pinned deterministic drills."""

    def __init__(self, *, grow: float = 1.5, timeout_cap: float = 4.0,
                 calm_steps: int = 3, occ_hi: float = 0.85,
                 workers_max: int = 8):
        if grow <= 1.0:
            raise ValueError(f"grow factor must exceed 1.0, got {grow}")
        self.name = "timeout_autoscale"
        self.grow = float(grow)
        self.timeout_cap = float(timeout_cap)
        self.calm_steps = int(calm_steps)
        self.occ_hi = float(occ_hi)
        self.workers_max = int(workers_max)
        self.reset()

    def reset(self) -> None:
        self._last_evictions: Optional[float] = None
        self._initial_timeout: Optional[float] = None
        self._calm = 0

    def propose(self, telemetry, knobs):
        out: Dict[str, float] = {}
        timeout = knobs.get("round_timeout_s")
        evictions = telemetry.get("evictions")
        if timeout is not None and evictions is not None:
            if self._initial_timeout is None:
                self._initial_timeout = timeout
            delta = evictions - (self._last_evictions
                                 if self._last_evictions is not None else evictions)
            self._last_evictions = evictions
            cap = self._initial_timeout * self.timeout_cap
            if delta > 0:
                self._calm = 0
                if timeout < cap:
                    out["round_timeout_s"] = min(cap, timeout * self.grow)
            else:
                self._calm += 1
                if self._calm >= self.calm_steps \
                        and timeout > self._initial_timeout:
                    self._calm = 0
                    out["round_timeout_s"] = max(self._initial_timeout,
                                                 timeout / self.grow)
        workers = knobs.get("ingest_workers")
        occ = telemetry.get("occupancy")
        if workers is not None and occ is not None and occ > self.occ_hi \
                and workers < self.workers_max:
            out["ingest_workers"] = int(workers) + 1
        return out


class FederationController:
    """Drives a list of policies against one bound manager.

    The manager invokes :meth:`step` from its safe-boundary hook
    (``_ctrl_boundary``), so every proposal is applied at a quiescent
    point on the dispatch thread — the controller itself owns no thread
    and no clock, which is what lets the identical object drive the
    virtual-time simulator and a real wall-clock run. Policies run in
    list order and later proposals win per knob; put safety policies
    (admission control) last so they override optimism. Every applied /
    refused actuation is visible three ways: the seam's flight events,
    the ``ctrl/actuation_*`` counters, and this object's
    ``actuation_log`` (the reproducibility artifact the drills pin)."""

    def __init__(self, policies: List[ControlPolicy], *, interval: int = 1):
        if interval < 1:
            raise ValueError(f"controller interval must be >= 1, got {interval}")
        self.policies = list(policies)
        self.interval = int(interval)
        self.actuation_log: List[Dict] = []
        self._last_step_progress = float("-inf")

    def bind(self) -> None:
        """Reset for a fresh manager (called by ``attach_controller``)."""
        for p in self.policies:
            p.reset()
        self.actuation_log = []
        self._last_step_progress = float("-inf")

    def step(self, manager) -> int:
        """One control step at a safe boundary: read telemetry, collect
        proposals, apply through the seam. Returns applied count."""
        seam = getattr(manager, "ctrl", None)
        if seam is None:
            return 0
        telemetry = read_telemetry(manager)
        progress = telemetry.get("progress", 0.0)
        if progress - self._last_step_progress < self.interval:
            return 0
        self._last_step_progress = progress
        knobs = seam.values()
        merged: Dict[str, tuple] = {}
        for policy in self.policies:
            for knob, value in policy.propose(telemetry, knobs).items():
                if knob in knobs:
                    merged[knob] = (value, policy.name)
        applied = 0
        from .actuator import ActuationRefused
        for knob in sorted(merged):
            value, why = merged[knob]
            entry = {"progress": progress, "knob": knob,
                     "old": knobs[knob], "new": value, "policy": why}
            try:
                seam.apply(knob, value, reason=why)
                entry["outcome"] = "applied"
                applied += 1
            except ActuationRefused as e:
                entry["outcome"] = f"refused:{e.reason}"
            self.actuation_log.append(entry)
        return applied
