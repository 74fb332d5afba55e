"""Level-triggered reconciliation: drive observed state to desired state.

The paper's §6 controller plans one transition and assumes every action
lands.  This reconciler wraps it in the loop a production control plane
(§7: a Kubernetes controller) actually runs:

  1. **observe** the cluster and :func:`~repro_torch.controlplane.spec.diff` it
     against the :class:`DesiredState`;
  2. **plan + execute** one exchange-and-compact transition through the
     existing §6 :class:`Controller` — per-device action DAGs, disjoint-GPU
     actions parallel, bounded by the profile's ``max_inflight`` executor
     slots;
  3. on an injected :class:`ActionFault`, **back off exponentially and
     re-plan from the new observed state** — the cluster itself is the
     partial-progress checkpoint, so completed actions are never redone and
     a crashed pass resumes instead of thrashing.  Re-planning re-runs the
     full §6 algorithm, so create-first-delete-second (and with it the
     transparency guarantee) is preserved under retry.

With no injector the loop degenerates to exactly one direct
``Controller.transition`` call and returns its report unchanged — the
``none`` fault profile is bit-for-bit identical to a direct transition.

The port's copy of the JAX package's ``controlplane/reconciler.py``, op
for op, driving the port's ``SimulatedCluster.fault_hook``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.cluster import ActionFault, SimulatedCluster, parallel_makespan
from repro_torch.core.controller import Controller, TransitionReport

from repro_torch.controlplane.degraded import AdmissionController
from repro_torch.controlplane.faults import FAULT_PROFILES, FaultInjector, FaultProfile
from repro_torch.controlplane.spec import DesiredState, ObservedState, diff


@dataclasses.dataclass
class ReconcileStats:
    """What one reconcile pass did (feeds the scenario-cell metrics)."""

    iterations: int = 0  # transition attempts (1 = clean single pass)
    retried: int = 0  # attempts that died on an injected ActionFault
    abandoned: int = 0  # diff items still outstanding when we gave up
    converged: bool = True
    backoff_s: float = 0.0  # exponential-backoff wall clock charged
    wasted_s: float = 0.0  # failed-attempt wall clock charged
    faults: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "iterations": self.iterations,
            "retried": self.retried,
            "abandoned": self.abandoned,
            "converged": self.converged,
            "backoff_s": self.backoff_s,
            "wasted_s": self.wasted_s,
            "faults": list(self.faults),
        }


class Reconciler:
    """Reconcile a :class:`SimulatedCluster` toward a :class:`DesiredState`."""

    def __init__(
        self,
        controller: Controller,
        injector: Optional[FaultInjector] = None,
        max_iterations: Optional[int] = None,
    ):
        self.controller = controller
        self.injector = injector
        profile = injector.profile if injector is not None else None
        self.max_iterations = max_iterations or (
            profile.max_iterations if profile is not None else 2
        )
        self.max_inflight = profile.max_inflight if profile is not None else None

    def diverged(self, cluster: SimulatedCluster, desired: DesiredState) -> bool:
        """The level trigger: does observed state differ from desired?"""
        return not diff(ObservedState.observe(cluster), desired).converged

    def reconcile(
        self, cluster: SimulatedCluster, desired: DesiredState
    ) -> Tuple[TransitionReport, ReconcileStats]:
        """Run the reconcile loop; returns the merged transition report over
        every attempt plus the pass's stats.

        The report's serial/parallel seconds include straggler-stretched
        action charges, wasted failed-attempt time, and backoff waits
        (failures and backoffs are barriers between re-plans)."""
        start = len(cluster.actions_applied)
        stats = ReconcileStats()
        inner: Optional[TransitionReport] = None
        peak = cluster.gpus_in_use()
        hook = (
            self.injector.action_hook
            if self.injector is not None and self.injector.profile.injects_actions
            else None
        )
        for attempt in range(1, self.max_iterations + 1):
            stats.iterations = attempt
            n_before = len(cluster.actions_applied)
            cluster.fault_hook = hook
            try:
                inner = self.controller.transition(cluster, desired.deployment)
            except ActionFault as fault:
                stats.retried += 1
                stats.faults.append(
                    f"{fault.action.kind}@gpu{fault.action.gpu}: {fault.reason}"
                )
                stats.wasted_s += fault.wasted_s
                if self.injector is None:  # hooks only exist with one
                    raise RuntimeError(
                        "ActionFault raised without an injector — only the "
                        "fault injector's hooks may raise ActionFault"
                    )
                stats.backoff_s += self.injector.backoff_s(attempt)
                peak = max(peak, cluster.gpus_in_use())
                inner = None
                continue
            finally:
                cluster.fault_hook = None
            peak = max(peak, inner.peak_gpus_busy)
            d = diff(ObservedState.observe(cluster), desired)
            if d.converged:
                break
            if len(cluster.actions_applied) == n_before:
                # zero actions applied and still diverged: another identical
                # plan would thrash, not converge — give up this pass
                stats.converged = False
                stats.abandoned = (
                    sum(d.missing.values())
                    + sum(d.surplus.values())
                    + len(d.misplaced)
                )
                break
        else:
            d = diff(ObservedState.observe(cluster), desired)
            stats.converged = d.converged
            if not d.converged:
                stats.abandoned = (
                    sum(d.missing.values())
                    + sum(d.surplus.values())
                    + len(d.misplaced)
                )

        extra_s = stats.wasted_s + stats.backoff_s
        if (
            inner is not None
            and stats.iterations == 1
            and extra_s == 0.0
            and self.max_inflight is None
        ):
            # clean single pass, unbounded concurrency: the §6 report IS the
            # answer — returned unchanged so the `none` profile stays
            # bit-for-bit identical to the direct-transition path
            return inner, stats
        actions = cluster.actions_applied[start:]
        secs = cluster.applied_seconds[start:]
        report = TransitionReport(
            actions=actions,
            serial_seconds=float(sum(secs)) + extra_s,
            parallel_seconds=parallel_makespan(
                actions, seconds=secs, max_concurrent=self.max_inflight
            )
            + extra_s,
            peak_gpus_busy=peak,
            final_gpus_busy=cluster.gpus_in_use(),
        )
        return report, stats


@dataclasses.dataclass
class ControlPlane:
    """The bundle the closed-loop simulator wires in: reconciler + fault
    injector + degraded-mode admission control, under one profile."""

    reconciler: Reconciler
    profile: FaultProfile
    injector: Optional[FaultInjector] = None
    admission: Optional[AdmissionController] = None

    @property
    def fault_mode(self) -> bool:
        """Faults active?  Gates every report-schema extension, so the
        ``none`` profile's reports keep their exact pre-control-plane bytes."""
        return self.profile.name != "none"


def build_control_plane(
    controller: Controller, profile_name: str, seed: int, duration_s: float
) -> ControlPlane:
    """Wire a control plane for one run of one fault profile."""
    profile = FAULT_PROFILES[profile_name]
    injector = (
        FaultInjector(profile, seed, duration_s)
        if profile.name != "none"
        else None
    )
    return ControlPlane(
        reconciler=Reconciler(controller, injector=injector),
        profile=profile,
        injector=injector,
        admission=AdmissionController() if injector is not None else None,
    )
