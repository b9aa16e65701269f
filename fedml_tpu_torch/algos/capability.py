"""Carry capability records of the algorithm zoo (port of
``fedml_tpu/algos/capability.py``'s ``record_for``, ``refusal``,
``ExcludedScanTiers``, ``zoo_records`` and ``render_matrix``).

One record per algorithm class, derived from its declarations: the carry
protocol (``window_protocol`` and the ``_window_*`` hooks),
``supports_streaming`` and which hooks of ``FedAvgAPI`` the class
overrides; a standalone class with its own loop (``DecentralizedAPI``)
declares its tiers in ``capability_tiers``. A class that opts out says
why in ``window_exclusion``; ``window_carry`` describes the carry for the
matrix. Every round tier keys its guard on the record and refuses with
:func:`refusal`, a message derived from it, never on a list of classes.

The records are the JAX package's. A "round" class with a host-side
``_server_update`` and no pure form has no fused step, but its host loop
(``train_one_round``, ``train_rounds_pipelined``) still runs: the round
function captured as its own step, then the server update on the host
side (``FedAvgAPI``'s host round); only the windowed and on-device tiers,
which fold the pure update between replays, refuse it. The windowed tier
replays the fused step once per round of a window, fed from a
``FederatedStore`` superbatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional


#: (display name, module under fedml_tpu_torch.algos, class name): the
#: zoo of the support matrix, in the JAX package's row order.
ZOO = (
    ("FedAvg", "fedavg", "FedAvgAPI"),
    ("FedProx", "fedprox", "FedProxAPI"),
    ("FedOpt", "fedopt", "FedOptAPI"),
    ("FedAc", "fedac", "FedAcAPI"),
    ("ServerAvg", "fedac", "ServerAvgAPI"),
    ("q-FedAvg", "qfedavg", "QFedAvgAPI"),
    ("FedNova", "fednova", "FedNovaAPI"),
    ("FedAvgRobust", "robust", "FedAvgRobustAPI"),
    ("SCAFFOLD", "scaffold", "ScaffoldAPI"),
    ("FedDyn", "feddyn", "FedDynAPI"),
    ("Ditto", "ditto", "DittoAPI"),
    ("FedAdapter", "fedadapter", "FedAdapterAPI"),
    ("FedBN", "fedbn", "FedBNAPI"),
    ("FedGAN", "fedgan", "FedGanAPI"),
    ("FedNAS", "fednas", "FedNASAPI"),
    ("FedSeg", "fedseg", "FedSegAPI"),
    ("TurboAggregate", "turboaggregate", "TurboAggregateAPI"),
    ("HierarchicalFL", "hierarchical", "HierarchicalFedAvgAPI"),
    ("Decentralized", "decentralized", "DecentralizedAPI"),
    ("FedGKT", "fedgkt", "FedGKTAPI"),
    ("SplitNN", "split_nn", "SplitNNAPI"),
    ("VerticalFL", "vertical_fl", "VflAPI"),
)


@dataclass(frozen=True)
class CarryCapability:
    """One algorithm's declared and derived record. ``fused`` (the fused
    round step), ``pipelined`` (the host loop without a sync: the fused
    step, or the host round where there is none), ``windowed`` and
    ``on_device`` are the tiers the class can ever ride; the layout (a
    store for the windowed tier, resident arrays for the on-device one)
    and oort selection are still checked per call."""

    algorithm: str
    protocol: Optional[str]       # "round" | "custom" | None
    carry: str                    # the matrix's note on the carry
    excluded: Optional[str]       # the class's window_exclusion
    custom_round: bool            # round != run_round + _server_update
    custom_builders: bool         # round_fn not from the shared builder
    custom_step: bool             # provides its own _build_fused_step
    pure_server_update: bool      # a pure server update exists
    round_aux: bool               # per-round host-computed operands
    streaming: bool               # supports FederatedStore cohorts
    fused: bool
    pipelined: bool
    windowed: bool
    on_device: bool


@lru_cache(maxsize=None)
def record_for(cls) -> CarryCapability:
    """The capability record of an algorithm class (cached per class):
    derived from the hooks for a ``FedAvgAPI`` subclass; a standalone
    class with its own loop declares ``capability_tiers`` (``fused``,
    ``pipelined``, ``windowed``, ``on_device``), or rides no tier."""
    from fedml_tpu_torch.algos.fedavg import FedAvgAPI
    from fedml_tpu_torch.algos.loop import FederatedLoop

    if not isinstance(cls, type):
        raise TypeError(f"{cls!r} is not an algorithm class")
    name = getattr(cls, "capability_name", cls.__name__)
    carry = getattr(cls, "window_carry", "—")
    excluded = getattr(cls, "window_exclusion", None)
    if not issubclass(cls, FedAvgAPI):
        tiers = getattr(cls, "capability_tiers", {})
        proto = getattr(cls, "window_protocol", None)
        if proto is None and excluded is None:
            excluded = ("no carry capability record declared "
                        "(window_protocol=None and no window_exclusion)")
        fused = bool(tiers.get("fused", False))
        return CarryCapability(
            algorithm=name, protocol=proto, carry=carry, excluded=excluded,
            custom_round=True, custom_builders=True, custom_step=fused,
            pure_server_update=False, round_aux=False,
            streaming=bool(getattr(cls, "supports_streaming", False)),
            fused=fused, pipelined=bool(tiers.get("pipelined", False)),
            windowed=bool(tiers.get("windowed", False)),
            on_device=bool(tiers.get("on_device", False)))
    proto = cls.window_protocol
    custom_round = (cls.train_one_round is not FedAvgAPI.train_one_round
                    or cls.run_round is not FederatedLoop.run_round)
    custom_builders = cls._make_vmap_round is not FedAvgAPI._make_vmap_round
    custom_step = cls._build_fused_step is not FedAvgAPI._build_fused_step
    # Either nothing to fold (the new model is the average) or the class
    # gives the pure form beside its host-side server update.
    pure = (cls._server_update is FedAvgAPI._server_update
            or cls._window_server_update
            is not FedAvgAPI._window_server_update)
    aux = (cls._round_aux is not FederatedLoop._round_aux
           or cls._window_scan_extras is not FedAvgAPI._window_scan_extras)
    streaming = bool(cls.supports_streaming)
    fused = pipelined = on_device = False
    if proto == "round":
        fused = not custom_round and pure
        # The host round applies _server_update on the host side, so an
        # impure override rides the pipelined loop too; only a custom
        # round refuses (its own procedure would be silently dropped).
        pipelined = not custom_round
        # The on-device round draws its cohort inside the captured step:
        # a host-computed per-round operand has no slot there.
        on_device = fused and not aux
    elif proto == "custom":
        fused = pipelined = custom_step
    return CarryCapability(
        algorithm=name, protocol=proto, carry=carry, excluded=excluded,
        custom_round=custom_round, custom_builders=custom_builders,
        custom_step=custom_step, pure_server_update=pure, round_aux=aux,
        streaming=streaming, fused=fused, pipelined=pipelined,
        windowed=fused and streaming, on_device=on_device)


def refusal(cls, tier: str) -> str:
    """The record-derived refusal of ``cls`` on ``tier``: every tier guard
    raises with this, so the reason the class declared, or the fact of
    its record that rules the tier out, reaches the user as it is."""
    rec = record_for(cls)
    name = cls.__name__
    if (tier == "train_rounds_windowed" and not rec.windowed
            and rec.excluded and rec.protocol is not None):
        # A class that rides other tiers but declares why the windowed
        # store tier does not apply (DecentralizedAPI's gossip).
        return f"{name} opts out of the windowed tier: {rec.excluded}"
    if (tier == "train_rounds_windowed" and not rec.streaming
            and (rec.fused or rec.custom_step)):
        # The class rides the round tiers but keeps client data resident:
        # the windowed tier is a store tier.
        return (f"{name} declares supports_streaming=False; "
                f"{tier} streams window superbatches from a "
                "FederatedStore — use the resident on-device scan or "
                "the per-round host loop")
    if rec.protocol is None:
        why = rec.excluded or "no reason declared"
        return (f"{name} opts out of the carry protocol "
                f"(window_protocol=None): {why}; {tier} replays a "
                "captured fused step, which it does not have — use its "
                "host loop")
    if rec.protocol == "round":
        if rec.custom_round:
            return (f"{name} customizes the round itself; {tier} only "
                    "serves algorithms whose per-round procedure is "
                    "run_round + _server_update (declare the 'custom' "
                    "carry protocol with a _build_fused_step for a bespoke "
                    "one-step round)")
        if not rec.pure_server_update:
            return (f"{name} overrides _server_update without providing "
                    f"its pure windowed form; {tier} needs the pure carry "
                    "record — override _window_server_update (and the "
                    "carry init/commit hooks) or set window_protocol = "
                    "None")
        if tier == "train_rounds_on_device" and rec.round_aux:
            return (f"{name} feeds its round per-round host-computed aux "
                    "operands (_round_aux/_window_scan_extras), which "
                    "the on-device scan — sampling inside the jit — has "
                    "no slot for; use the windowed streaming scan or "
                    "the host loop")
        return f"{name} does not ride {tier} (capability record: {rec})"
    if not rec.custom_step:
        return (f"{name} declares window_protocol='custom' but does not "
                f"provide _build_fused_step; {tier} replays the fused "
                "one-step round, which only the step hook defines")
    if tier == "train_rounds_on_device":
        return (f"{name} carries client-stacked state through a custom "
                "scan body; the on-device scan serves 'round'-protocol "
                "algorithms — use the windowed streaming scan")
    return f"{name} does not ride {tier} (capability record: {rec})"


class ExcludedScanTiers:
    """The multi-round tiers as record-derived refusals, for the standalone
    training loops outside the FedAvg family (FedGKT's alternating
    distillation, split learning's relay ring, vertical FL): each tier
    raises :func:`refusal`'s message, which quotes the class's
    ``window_exclusion``, instead of an ``AttributeError`` that says
    nothing."""

    window_protocol = None
    window_exclusion = None

    def train_rounds_windowed(self, *a, **k):
        raise NotImplementedError(refusal(type(self),
                                          "train_rounds_windowed"))

    def train_rounds_pipelined(self, *a, **k):
        raise NotImplementedError(refusal(type(self),
                                          "train_rounds_pipelined"))

    def train_rounds_on_device(self, *a, **k):
        raise NotImplementedError(refusal(type(self),
                                          "train_rounds_on_device"))


def zoo_records():
    """``[(display_name, cls, CarryCapability)]`` for the whole zoo, in
    matrix order (imports every algorithm module)."""
    import importlib

    out = []
    for name, module, clsname in ZOO:
        mod = importlib.import_module(f"fedml_tpu_torch.algos.{module}")
        cls = getattr(mod, clsname)
        out.append((name, cls, record_for(cls)))
    return out


def _cell(flag: bool) -> str:
    return "✓" if flag else "✗"


def render_matrix() -> str:
    """The algorithm × tier support matrix of the port, generated from the
    records that the tier guards consume, in the JAX package's format."""
    lines = [
        "| algorithm | protocol | carry | pipelined | fused round | "
        "windowed scan | on-device scan |",
        "|---|---|---|---|---|---|---|",
    ]
    excluded = []
    for name, cls, rec in zoo_records():
        proto = rec.protocol if rec.protocol else "—"
        lines.append(
            f"| {name} | {proto} | {rec.carry} | {_cell(rec.pipelined)} | "
            f"{_cell(rec.fused)} | {_cell(rec.windowed)} | "
            f"{_cell(rec.on_device)} |")
        if rec.excluded:
            excluded.append(f"- **{name}** — {rec.excluded}")
    out = "\n".join(lines)
    if excluded:
        out += ("\n\nRecord-derived exclusions (the refusal each guard "
                "raises):\n\n" + "\n".join(excluded))
    return out
