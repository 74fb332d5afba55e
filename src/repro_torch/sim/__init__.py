"""Closed-loop trace-driven cluster serving simulation (Figures 13-14).

The port's copy of the JAX package's ``repro.sim``, op for op and held to
the reference run live (``tests/test_torch_sim_parts.py``,
``tests/test_torch_sim.py``): traffic arrives, gets routed over MIG
instances, SLO attainment is measured, and a periodic re-optimizer executes
transparent transitions whose Figure-13c action latencies are charged to
in-flight capacity.

  * :mod:`repro_torch.sim.events`     — :class:`EventQueue` (ties pop in
    push order) and :class:`Clock`;
  * :mod:`repro_torch.sim.traffic`    — :class:`Trace`, the five trace
    generators, :class:`PriorityMix` and the priority classes;
  * :mod:`repro_torch.sim.report`     — :class:`SimReport` and its records,
    whose ``to_json()`` bytes equal the reference's on the same records;
  * :mod:`repro_torch.sim.servemodel` — the token-level twin of the engine;
  * :mod:`repro_torch.sim.reoptimize` — :class:`ReoptimizeDriver`, the
    observe -> optimize -> transition actuator;
  * :mod:`repro_torch.sim.simulator`  — :class:`ClusterSimulator` and
    :class:`SimConfig`, the loop itself;
  * :mod:`repro_torch.sim.scenarios`  — the declarative scenario matrix.

Extension points:

  * new trace shapes  -> add a generator in :mod:`repro_torch.sim.traffic`
  * SLO policies      -> :class:`SimConfig` (headroom, latency, cadence)
  * algorithm swaps   -> ``optimizer_kwargs`` routes to
                         :class:`repro_torch.core.optimizer.TwoPhaseOptimizer`'s
                         registry (``fast=/slow=``)

Like the reference's, these modules are numpy and stdlib only: they import
neither torch nor jax, and read no wall clock.
"""

from repro_torch.controlplane.faults import FAULT_PROFILES
from repro_torch.sim.events import Clock, Event, EventQueue
from repro_torch.sim.reoptimize import PendingTransition, ReoptimizeDriver
from repro_torch.sim.report import (
    FaultRecord,
    ServiceTimeline,
    SimReport,
    TransitionRecord,
)
from repro_torch.sim.scenarios import (
    FLUID_SCHEDULERS,
    PRIORITY_MIXES,
    SCALES,
    SCHEDULERS,
    SLO_POLICIES,
    TRACE_SHAPES,
    CellResult,
    ScaleSpec,
    ScenarioCell,
    build_cell,
    default_matrix,
    run_cell,
    run_cell_obs,
    run_matrix,
    smoke_matrix,
)
from repro_torch.sim.servemodel import (
    InstanceModel,
    TokenKnobs,
    TokenRequest,
    TokenServingState,
)
from repro_torch.sim.simulator import ClusterSimulator, SimConfig
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
    "Clock", "ClusterSimulator", "Event", "EventQueue", "FaultRecord",
    "PendingTransition", "ReoptimizeDriver", "ServiceTimeline", "SimConfig",
    "SimReport", "Trace", "TransitionRecord", "correlated_surge_trace",
    "diurnal_trace", "flash_crowd_trace", "poisson_burst_trace",
    "replay_trace", "FAULT_PROFILES", "FLUID_SCHEDULERS", "SCALES",
    "SCHEDULERS", "SLO_POLICIES",
    "TRACE_SHAPES", "CellResult", "ScaleSpec", "ScenarioCell", "build_cell",
    "default_matrix", "run_cell", "run_cell_obs", "run_matrix",
    "smoke_matrix",
    "InstanceModel", "TokenKnobs", "TokenRequest", "TokenServingState",
    "PRIORITY_CLASSES", "PRIORITY_MIXES", "PriorityMix",
]
