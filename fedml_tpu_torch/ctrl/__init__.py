"""Self-tuning federation control (port of ``fedml_tpu/ctrl``).

Closes the loop from the live telemetry the repo already emits (registry
histograms, ``health()``, ``ingest_profile()``, flight events) to the
knobs the server managers already expose — through a validated,
boundary-gated actuation seam. See docs/ROBUSTNESS.md "Adaptive
control" for the operational contract.
"""

from .actuator import ActuationRefused, ActuationSeam, Knob
from .policy import (
    ControlPolicy,
    FederationController,
    StalenessAdmissionPolicy,
    TimeoutAutoscalePolicy,
    WindowSchedulePolicy,
    read_telemetry,
)

__all__ = [
    "ActuationRefused",
    "ActuationSeam",
    "ControlPolicy",
    "FederationController",
    "Knob",
    "StalenessAdmissionPolicy",
    "TimeoutAutoscalePolicy",
    "WindowSchedulePolicy",
    "controller_from_args",
    "read_telemetry",
]


def controller_from_args(args):
    """Build the controller selected by ``--controller`` (None when the
    flag is ``none``, the default — the managers then behave bit-equal
    to a build without this subsystem)."""
    kind = getattr(args, "controller", "none")
    if kind == "none":
        return None
    if kind != "adaptive":
        raise SystemExit(f"unknown --controller {kind!r}; expected none|adaptive")
    band_lo = getattr(args, "controller_band_lo", 2.0)
    band_hi = getattr(args, "controller_band_hi", 6.0)
    return FederationController(
        [
            WindowSchedulePolicy(),
            TimeoutAutoscalePolicy(),
            # safety last: admission control overrides the optimistic arms
            StalenessAdmissionPolicy(band_lo=band_lo, band_hi=band_hi),
        ],
        interval=getattr(args, "controller_interval", 1),
    )
