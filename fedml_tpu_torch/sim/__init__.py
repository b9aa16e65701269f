"""Trace-driven fleet simulation (virtual clock) for the message-passing
federation tiers (port of ``fedml_tpu/sim``).

The cross-device story the paper implies — millions of unreliable phones
on diurnal schedules — never runs in a test harness wired to
always-available loopback workers. This package drives the REAL control
plane (``algos/fedavg_distributed.py``'s sync/first-k path,
``algos/fedasync.py``, ``algos/fedbuff.py``, and ``ChaosTransport``)
under a seeded, deterministic fleet trace: device arrival times, diurnal
availability windows, power-law device-speed heterogeneity, and
mid-round churn, all on a VIRTUAL clock so an hour-scale serving
scenario replays in seconds of wall time and two runs with the same seed
are event-for-event identical.

- :mod:`fedml_tpu_torch.sim.clock` — ``VirtualClock`` + ``EventQueue``;
- :mod:`fedml_tpu_torch.sim.trace` — ``FleetSpec`` / ``FleetTrace``;
- :mod:`fedml_tpu_torch.sim.transport` — ``SimNetwork`` / ``SimCommManager``
  (the ``backend="SIM"`` comm fabric);
- :mod:`fedml_tpu_torch.sim.fleet` — ``FleetSimulator`` / ``FleetResult``.

See docs/ROBUSTNESS.md "Serving under churn".
"""

from fedml_tpu_torch.sim.clock import EventQueue, VirtualClock
from fedml_tpu_torch.sim.fleet import FleetResult, FleetSimulator, StoreFleetData
from fedml_tpu_torch.sim.trace import FleetSpec, FleetTrace, make_fleet_trace
from fedml_tpu_torch.sim.transport import SimCommManager, SimNetwork

__all__ = [
    "EventQueue",
    "FleetResult",
    "FleetSimulator",
    "FleetSpec",
    "FleetTrace",
    "SimCommManager",
    "SimNetwork",
    "StoreFleetData",
    "VirtualClock",
    "make_fleet_trace",
]
