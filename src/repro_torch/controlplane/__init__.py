"""Fault-tolerant control plane: declarative reconciler + failure injection.

The paper runs MIG-serving as a Kubernetes controller (§6-§7) that
continuously drives the cluster from observed state to the optimizer's
target state.  This package is that control plane for the simulated
cluster: declarative specs (``spec``), a level-triggered reconcile loop
through the §6 exchange-and-compact controller (``reconciler``), seeded
fault injection (``faults``), and degraded-mode admission control
(``degraded``).

Numpy-only and seed-deterministic: like ``repro_torch.core`` and
``repro_torch.sim`` it imports neither torch nor jax
(``tests/test_torch_static.py``).  The port's copy of the JAX package's
``controlplane`` package, op for op: its seeded schedules, verdicts and
reconcile passes equal the reference's (``tests/test_torch_controlplane.py``).
"""

from repro_torch.controlplane.degraded import AdmissionController
from repro_torch.controlplane.faults import (
    FAULT_PROFILES,
    DeviceFault,
    FaultInjector,
    FaultProfile,
    register_fault_profile,
)
from repro_torch.controlplane.reconciler import (
    ControlPlane,
    Reconciler,
    ReconcileStats,
    build_control_plane,
)
from repro_torch.controlplane.spec import (
    ClusterSpec,
    DesiredState,
    NodeSpec,
    ObservedState,
    StateDiff,
    diff,
)

__all__ = [
    "AdmissionController",
    "ClusterSpec",
    "ControlPlane",
    "DesiredState",
    "DeviceFault",
    "FAULT_PROFILES",
    "FaultInjector",
    "FaultProfile",
    "NodeSpec",
    "ObservedState",
    "Reconciler",
    "ReconcileStats",
    "StateDiff",
    "build_control_plane",
    "diff",
    "register_fault_profile",
]
