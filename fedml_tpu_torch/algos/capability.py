"""Carry capability records of the FedAvg family (port of
``fedml_tpu/algos/capability.py``'s ``record_for``, ``refusal`` and
``ExcludedScanTiers``).

One record per algorithm class, derived from its declarations: the carry
protocol (``window_protocol`` and the ``_window_*`` hooks) and which
hooks of ``FedAvgAPI`` the class overrides; a standalone class with its
own loop (``DecentralizedAPI``) declares its tiers in
``capability_tiers``. A class that opts out says why in
``window_exclusion``. Every round tier keys its guard on the record and
refuses with :func:`refusal`, a message derived from it, never on a list
of classes.

What differs from the JAX package's records: the port's host loop
(``train_one_round``, ``train_rounds_pipelined``) replays the fused step
and has no eager fallback, so ``fused`` stands for both tiers;
and the port has no streaming store or windowed tier yet (ROADMAP.md A5,
A9), so the record has no fields for them (the windowed tier refuses
every class).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional


@dataclass(frozen=True)
class CarryCapability:
    """One algorithm's declared and derived record. ``fused`` (the
    replayed fused round of ``train_one_round`` and
    ``train_rounds_pipelined``) and ``on_device`` are the tiers the class
    can ever ride; a resident dataset is still checked per call."""

    algorithm: str
    protocol: Optional[str]       # "round" | "custom" | None
    excluded: Optional[str]       # the class's window_exclusion
    custom_round: bool            # round != run_round + _server_update
    custom_builders: bool         # round_fn not from the shared builder
    custom_step: bool             # provides its own _build_fused_step
    pure_server_update: bool      # a pure server update exists
    round_aux: bool               # per-round host-computed operands
    fused: bool
    on_device: bool


@lru_cache(maxsize=None)
def record_for(cls) -> CarryCapability:
    """The capability record of an algorithm class (cached per class):
    derived from the hooks for a ``FedAvgAPI`` subclass; a standalone
    class with its own loop declares ``capability_tiers`` (``fused``,
    ``pipelined``, ``on_device``), or rides no tier."""
    from fedml_tpu_torch.algos.fedavg import FedAvgAPI
    from fedml_tpu_torch.algos.loop import FederatedLoop

    excluded = getattr(cls, "window_exclusion", None)
    if not isinstance(cls, type):
        raise TypeError(f"{cls!r} is not an algorithm class")
    if not issubclass(cls, FedAvgAPI):
        tiers = getattr(cls, "capability_tiers", {})
        proto = getattr(cls, "window_protocol", None)
        if proto is None and excluded is None:
            excluded = ("no carry capability record declared "
                        "(window_protocol=None and no window_exclusion)")
        # The port's pipelined tier replays the fused step: "fused"
        # answers for both.
        fused = bool(tiers.get("fused", False))
        return CarryCapability(
            algorithm=cls.__name__, protocol=proto, excluded=excluded,
            custom_round=True, custom_builders=True, custom_step=fused,
            pure_server_update=False, round_aux=False, fused=fused,
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
    aux = cls._round_aux is not FederatedLoop._round_aux
    fused = on_device = False
    if proto == "round":
        fused = not custom_round and pure
        # The on-device round draws its cohort inside the captured step:
        # a host-computed per-round operand has no slot there.
        on_device = fused and not aux
    elif proto == "custom":
        fused = custom_step
    return CarryCapability(
        algorithm=cls.__name__, protocol=proto, excluded=excluded,
        custom_round=custom_round, custom_builders=custom_builders,
        custom_step=custom_step, pure_server_update=pure, round_aux=aux,
        fused=fused, on_device=on_device)


def refusal(cls, tier: str) -> str:
    """The record-derived refusal of ``cls`` on ``tier``: every tier guard
    raises with this, so the reason the class declared, or the fact of
    its record that rules the tier out, reaches the user as it is."""
    rec = record_for(cls)
    name = cls.__name__
    if (tier == "train_rounds_windowed" and rec.excluded
            and rec.protocol is not None):
        # A class that rides other tiers but declares why the windowed
        # store tier does not apply (DecentralizedAPI's gossip).
        return f"{name} opts out of the windowed tier: {rec.excluded}"
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
                    "operands (_round_aux), which the on-device round — "
                    "drawing its cohort inside the captured step — has no "
                    "slot for; use train_one_round or "
                    "train_rounds_pipelined")
        return f"{name} does not ride {tier} (capability record: {rec})"
    if not rec.custom_step:
        return (f"{name} declares window_protocol='custom' but does not "
                f"provide _build_fused_step; {tier} replays the fused "
                "one-step round, which only the step hook defines")
    if tier == "train_rounds_on_device":
        return (f"{name} carries client-stacked state through a custom "
                "scan body; the on-device scan serves 'round'-protocol "
                "algorithms — use train_one_round or "
                "train_rounds_pipelined (the windowed streaming scan is "
                "ROADMAP.md A5/A9)")
    return (f"{name} carries client-stacked state through a custom step; "
            f"{tier} serves 'round'-protocol algorithms")


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


def refuse_model_state(who: str, *modules) -> None:
    """The guard of the classes whose rounds do not carry trained model
    state yet (BatchNorm's running stats): a model with buffers is refused
    by name, as its stats would silently stay at their init."""
    for module in modules:
        names = [n for n, _ in module.named_buffers()]
        if names:
            raise NotImplementedError(
                f"{who} does not carry trained model state yet (the model "
                f"has buffers, e.g. {names[0]!r}: norm='bn'); ROADMAP.md A2 "
                "carries it through the FedAvg family only — use norm='gn'")
