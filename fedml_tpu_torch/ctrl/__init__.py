"""Self-tuning federation control: the actuation seam (port of
``fedml_tpu/ctrl``).

The server managers build an :class:`ActuationSeam` over their live knobs
on every run (``algos/fedavg_distributed.py``); external code tunes them
through it between rounds. The JAX package's controllers
(``ctrl/policy.py``: ``FederationController`` and its policies) are not
ported yet (ROADMAP.md A10c).
"""

from .actuator import ActuationRefused, ActuationSeam, Knob

__all__ = ["ActuationRefused", "ActuationSeam", "Knob"]
