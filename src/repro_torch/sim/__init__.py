"""The simulator's parts that the port has so far: discrete events, traffic
traces, the report and the token-level serving model.

The JAX package's ``repro.sim`` is the closed-loop trace-driven cluster
simulation of the paper's Figures 13-14: traffic arrives, is routed over
MIG instances, SLO attainment is measured, and a periodic re-optimizer
executes transparent transitions.  These modules are its leaves, copied op
for op and held to the reference run live (``tests/test_torch_sim_parts.py``):

  * :mod:`repro_torch.sim.events`     — :class:`EventQueue` (ties pop in
    push order) and :class:`Clock`;
  * :mod:`repro_torch.sim.traffic`    — :class:`Trace`, the five trace
    generators, :class:`PriorityMix` and the priority classes;
  * :mod:`repro_torch.sim.report`     — :class:`SimReport` and its records,
    whose ``to_json()`` bytes equal the reference's on the same records;
  * :mod:`repro_torch.sim.servemodel` — the token-level twin of the engine.

The re-optimize driver (``reoptimize``), the simulator loop (``simulator``)
and the scenario matrix (``scenarios``) follow, and with them the rest of
the reference's exports.  Like the reference's, these modules are numpy and
stdlib only: they import neither torch nor jax, and read no wall clock.
"""

from repro_torch.sim.events import Clock, Event, EventQueue
from repro_torch.sim.report import (
    FaultRecord,
    ServiceTimeline,
    SimReport,
    TransitionRecord,
)
from repro_torch.sim.servemodel import (
    InstanceModel,
    TokenKnobs,
    TokenRequest,
    TokenServingState,
)
from repro_torch.sim.traffic import (
    PRIORITY_CLASSES,
    PriorityMix,
    Trace,
    correlated_surge_trace,
    diurnal_trace,
    flash_crowd_trace,
    poisson_burst_trace,
    replay_trace,
)

__all__ = [
    "Clock", "Event", "EventQueue", "FaultRecord", "ServiceTimeline",
    "SimReport", "Trace", "TransitionRecord", "correlated_surge_trace",
    "diurnal_trace", "flash_crowd_trace", "poisson_burst_trace",
    "replay_trace",
    "InstanceModel", "TokenKnobs", "TokenRequest", "TokenServingState",
    "PRIORITY_CLASSES", "PriorityMix",
]
