"""The closed loop's actuator: observe load, re-optimize, transition.

This is the piece that turns the repo's isolated components into the paper's
system: a :class:`ReoptimizeDriver` periodically takes the observed
per-service arrival rates, builds a workload (SLO throughput = observed rate
x headroom), runs the phase-1/phase-2 optimizer pipeline
(:class:`repro_torch.core.optimizer.TwoPhaseOptimizer`), and — when the demand
moved enough — executes the resulting target deployment through the
exchange-and-compact controller (§6).

The controller applies actions against :class:`SimulatedCluster`
synchronously; serving, however, must pay the paper's Figure-13c action
latencies.  The driver therefore converts the cluster's instance-level
action trace into a :class:`PendingTransition`: a timeline of instance-set
snapshots placed at list-scheduled times compressed to the dependency-aware
parallel makespan.  The simulator serves from this timeline while the
transition is in flight, so creates only add capacity once their 62 s have
elapsed, and the §6 transparency margin is measured at every trace point.

The port's copy of the JAX package's ``sim/reoptimize.py``, op for op, on
the port's :mod:`repro_torch.core` and :mod:`repro_torch.controlplane`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.controlplane.reconciler import ControlPlane, ReconcileStats
from repro_torch.controlplane.spec import DesiredState
from repro_torch.core.cluster import SimulatedCluster
from repro_torch.core.controller import Controller, TransitionReport
from repro_torch.core.deployment import Deployment, IndexedDeployment, Workload
from repro_torch.core.optimizer import OptimizeReport, TwoPhaseOptimizer
from repro_torch.core.profiles import PerfProfile
from repro_torch.core.rms import SLO, ReconfigRules

from repro_torch.sim.report import TransitionRecord

# uid -> (service, size, throughput)
InstanceSet = Dict[int, Tuple[str, int, float]]


@dataclasses.dataclass
class PendingTransition:
    """A transition whose actions are still paying their latencies."""

    start_s: float
    end_s: float
    # (sim time, busy instances after that action), ascending in time
    timeline: List[Tuple[float, InstanceSet]]
    record: TransitionRecord

    def instances_at(self, t: float) -> InstanceSet:
        """The serving instance set at sim time ``t`` (last snapshot <= t)."""
        current = self.timeline[0][1]
        for ts, snap in self.timeline:
            if ts <= t + 1e-9:
                current = snap
            else:
                break
        return current


class ReoptimizeDriver:
    """Observe -> optimize -> transition, with explicit seeds throughout."""

    def __init__(
        self,
        rules: ReconfigRules,
        profile: PerfProfile,
        latency_slo_ms: float = 100.0,
        headroom: float = 1.1,
        change_threshold: float = 0.15,
        use_phase2: bool = False,
        seed: int = 0,
        optimizer_kwargs: Optional[Dict] = None,
        latency_targets: Optional[Mapping[str, float]] = None,
        control_plane: Optional[ControlPlane] = None,
        warm_start: bool = False,
        warm_divergence: float = 0.5,
        warm_edit_frac: float = 0.5,
        time_budget_s: Optional[float] = None,
    ):
        self.rules = rules
        self.profile = profile
        self.controller = Controller(rules, profile)
        # control_plane= mode (repro_torch.controlplane): transitions route through
        # the level-triggered reconciler instead of one direct
        # Controller.transition, and divergence (device faults) triggers
        # repair passes even when demand did not move.  None = the direct
        # path, bit-for-bit identical to the pre-control-plane behavior.
        self.control_plane = control_plane
        self.desired: Optional[DesiredState] = None  # reconciler's target
        self.latency_slo_ms = latency_slo_ms
        # per-service latency SLOs (an interactive service can demand 50 ms
        # while a batchy one tolerates 200 ms); services absent from the map
        # fall back to the uniform latency_slo_ms
        self.latency_targets = dict(latency_targets or {})
        self.headroom = headroom
        self.change_threshold = change_threshold
        self.use_phase2 = use_phase2
        self.seed = seed
        self.optimizer_kwargs = dict(optimizer_kwargs or {})
        # Driver-level knobs may also arrive through optimizer_kwargs — the
        # scenario matrix's SCHEDULERS registry reaches the driver only that
        # way — so pop them before the dict is forwarded to the optimizer.
        self.warm_start = bool(self.optimizer_kwargs.pop("warm_start", warm_start))
        self.warm_divergence = float(
            self.optimizer_kwargs.pop("warm_divergence", warm_divergence)
        )
        self.warm_edit_frac = float(
            self.optimizer_kwargs.pop("warm_edit_frac", warm_edit_frac)
        )
        self.time_budget_s = self.optimizer_kwargs.pop("time_budget_s", time_budget_s)
        # warm-start state: the last solve's ConfigSpace and winning indexed
        # deployment, carried cycle to cycle.  Populated only when warm_start
        # is on, so the cold path's behavior (and bytes) cannot shift.
        self._warm_space = None
        self._incumbent: Optional[IndexedDeployment] = None
        self._incumbent_workload: Optional[Workload] = None
        self.workload: Optional[Workload] = None  # currently deployed target
        # wall-clock of the most recent optimizer pipeline run; optimizer
        # latency sits on the serving hot path (every reoptimize fires the
        # full greedy/GA/MCTS stack), so the closed loop exposes it for
        # benchmarks without touching the deterministic SimReport bytes
        self.last_optimize_report: Optional[OptimizeReport] = None
        # flight-recorder observability (repro_torch.obs.Observability): installed
        # by ClusterSimulator only when SimConfig.observability is on, so the
        # default path pays one None check per cycle and nothing else
        self.obs = None

    # -- observation --------------------------------------------------------------
    def workload_for(self, observed_rates: Mapping[str, float]) -> Workload:
        """SLO throughput = observed rate x headroom (floored at 1 req/s so
        the optimizer's per-service normalization stays finite); latency =
        the service's entry in ``latency_targets``, else ``latency_slo_ms``."""
        return Workload.make(
            {
                svc: SLO(
                    max(rate * self.headroom, 1.0),
                    self.latency_targets.get(svc, self.latency_slo_ms),
                )
                for svc, rate in sorted(observed_rates.items())
            }
        )

    def demand_moved(self, new: Workload) -> bool:
        """Did any service's required throughput move more than the
        threshold relative to the deployed target?"""
        if self.workload is None:
            return True
        old = {s.name: s.slo.throughput for s in self.workload.services}
        for s in new.services:
            base = max(old.get(s.name, 1.0), 1.0)
            if abs(s.slo.throughput - base) / base > self.change_threshold:
                return True
        return False

    # -- optimization -------------------------------------------------------------
    def optimize(self, workload: Workload) -> Deployment:
        kwargs = dict(self.optimizer_kwargs)
        if self.time_budget_s is not None:
            kwargs["time_budget_s"] = self.time_budget_s
        if (
            self.warm_start
            and self._warm_space is not None
            and self._incumbent is not None
            and self._warm_space.compatible(workload)
        ):
            # warm start: rebind last cycle's ConfigSpace to the drifted
            # rates (shared enumeration, so incumbent counts carry over
            # index-for-index) and seed the optimizer with the incumbent
            space = self._warm_space.rebind(workload)
            kwargs.update(
                space=space,
                incumbent=IndexedDeployment(
                    space, self._incumbent.counts.copy(), list(self._incumbent.extras)
                ),
                incumbent_workload=self._incumbent_workload,
                warm_divergence=self.warm_divergence,
                warm_edit_frac=self.warm_edit_frac,
            )
        opt = TwoPhaseOptimizer(
            self.rules,
            self.profile,
            workload,
            seed=self.seed,
            **kwargs,
        )
        report = opt.run(skip_phase2=not self.use_phase2)
        self.last_optimize_report = report
        dep = report.best_deployment
        if self.warm_start:
            self._warm_space = opt.space
            self._incumbent = report.best_indexed(opt.space)
            self._incumbent_workload = workload
        if self.control_plane is not None:
            # refresh the reconciler's declarative target (§6's "desired
            # state"): the deployment, its array-native twin, and the
            # required rates it was sized for
            self.desired = DesiredState(
                deployment=dep,
                required={
                    s.name: s.slo.throughput for s in workload.services
                },
                indexed=IndexedDeployment.from_deployment(opt.space, dep),
            )
        return dep

    # -- actuation ----------------------------------------------------------------
    def initial_deploy(
        self, cluster: SimulatedCluster, observed_rates: Mapping[str, float]
    ) -> Deployment:
        workload = self.workload_for(observed_rates)
        dep = self.optimize(workload)
        self.controller.deploy_fresh(cluster, dep)
        # the driver is the sole instance_trace consumer and only ever reads
        # the current transition's tail — drop consumed history so long
        # many-transition runs stay O(one transition) in memory
        cluster.instance_trace.clear()
        self.workload = workload
        return dep

    def reoptimize(
        self,
        cluster: SimulatedCluster,
        observed_rates: Mapping[str, float],
        now: float,
    ) -> Optional[PendingTransition]:
        """Run one observe->optimize->transition step at sim time ``now``.

        Returns ``None`` when demand has not moved enough to act.  In
        ``control_plane=`` mode a steady demand still level-triggers a
        repair pass when the observed cluster diverged from the desired
        state (device faults since the last look).
        """
        new_workload = self.workload_for(observed_rates)
        if not self.demand_moved(new_workload):
            if self.control_plane is not None:
                return self.reconcile_divergence(cluster, now)
            return None
        if self.workload is None:
            raise RuntimeError(
                "reoptimize() before initial_deploy(): the driver has no "
                "deployed workload to transition from"
            )
        cluster.record_instance_trace = True
        old_required = {
            s.name: s.slo.throughput for s in self.workload.services
        }
        new_required = {
            s.name: s.slo.throughput for s in new_workload.services
        }

        new_dep = self.optimize(new_workload)
        if self.obs is not None:
            rep = self.last_optimize_report
            # zero sim-time: the solve is instantaneous in simulation time
            # (its real wall clock lives in OptimizeReport, off the report
            # bytes); warm/cold tells which solver path produced the target
            self.obs.tracer.span(
                "reoptimize",
                "optimize",
                now,
                now,
                args={
                    "warm": bool(getattr(rep, "warm", False)),
                    "phase2": self.use_phase2,
                },
            )
        pre_instances = cluster.busy_instances()
        gpus_before = cluster.gpus_in_use()
        n0 = len(cluster.instance_trace)
        na0 = len(cluster.actions_applied)
        clock0 = cluster.clock
        report, stats = self._execute_transition(cluster, new_dep)
        self.workload = new_workload

        pending = self._build_pending(
            now, pre_instances, cluster, n0, clock0, report,
            old_required, new_required, gpus_before,
            trigger="demand", stats=stats, na0=na0,
        )
        cluster.instance_trace.clear()  # consumed; see initial_deploy
        return pending

    def _execute_transition(
        self, cluster: SimulatedCluster, new_dep: Deployment
    ) -> Tuple[TransitionReport, Optional[ReconcileStats]]:
        """Direct §6 transition, or the reconciler in control-plane mode.

        Reconcile stats surface only under a fault profile, so the ``none``
        profile's reports keep their exact direct-path bytes.  When the warm
        optimizer actually produced the target (``report.warm``), the edit
        distance to the running deployment is bounded, so the delta-aware
        :meth:`Controller.transition_incremental` applies O(edits) actions
        instead of exchange-and-compact's O(cluster) scans; cold solves —
        including warm-path divergence/edit-budget fallbacks — keep the full
        §6 path, so every warm-off byte is untouched."""
        if self.control_plane is None:
            if (
                self.warm_start
                and self.last_optimize_report is not None
                and self.last_optimize_report.warm
            ):
                return self.controller.transition_incremental(cluster, new_dep), None
            return self.controller.transition(cluster, new_dep), None
        if self.desired is None:
            raise RuntimeError(
                "control-plane transition without a desired state: "
                "optimize() must set the reconciler target first"
            )
        report, stats = self.control_plane.reconciler.reconcile(
            cluster, self.desired
        )
        return report, (stats if self.control_plane.fault_mode else None)

    def reconcile_divergence(
        self, cluster: SimulatedCluster, now: float
    ) -> Optional[PendingTransition]:
        """Level-triggered repair: if observed state diverged from the
        standing desired state (a device failed, a node is draining), run a
        reconcile pass toward the unchanged target.  Returns ``None`` when
        already converged."""
        if self.control_plane is None:
            raise RuntimeError(
                "reconcile_divergence() requires control_plane= mode"
            )
        if (
            self.desired is None
            or self.workload is None
            or not self.control_plane.reconciler.diverged(cluster, self.desired)
        ):
            return None
        cluster.record_instance_trace = True
        required = {s.name: s.slo.throughput for s in self.workload.services}
        pre_instances = cluster.busy_instances()
        gpus_before = cluster.gpus_in_use()
        n0 = len(cluster.instance_trace)
        na0 = len(cluster.actions_applied)
        clock0 = cluster.clock
        report, stats = self.control_plane.reconciler.reconcile(
            cluster, self.desired
        )
        if not report.actions:
            cluster.instance_trace.clear()
            return None
        pending = self._build_pending(
            now, pre_instances, cluster, n0, clock0, report,
            required, required, gpus_before,
            trigger="fault",
            stats=stats if self.control_plane.fault_mode else None,
            na0=na0,
        )
        cluster.instance_trace.clear()
        return pending

    def _build_pending(
        self,
        now: float,
        pre_instances: InstanceSet,
        cluster: SimulatedCluster,
        n0: int,
        clock0: float,
        report: TransitionReport,
        old_required: Dict[str, float],
        new_required: Dict[str, float],
        gpus_before: int,
        trigger: str = "demand",
        stats: Optional[ReconcileStats] = None,
        na0: int = 0,
    ) -> PendingTransition:
        # The cluster trace advances serially (one action at a time); real
        # wall clock is the dependency-aware parallel makespan.  Compress
        # serial offsets onto the parallel window — ordering (hence the §6
        # guarantee, which the controller enforces on the serial trace) is
        # preserved.
        serial = max(report.serial_seconds, 1e-9)
        scale = report.parallel_seconds / serial
        timeline: List[Tuple[float, InstanceSet]] = [(now, dict(pre_instances))]
        # sorted: the margin dict feeds TransitionRecord serialization, so
        # its construction must never depend on set hash order
        margin = {
            svc: float("inf")
            for svc in sorted(set(old_required) | set(new_required))
        }

        def note_margin(instances: InstanceSet) -> None:
            provided: Dict[str, float] = {}
            for svc, _size, tput in instances.values():
                provided[svc] = provided.get(svc, 0.0) + tput
            for svc in margin:
                floor = min(
                    old_required.get(svc, 0.0), new_required.get(svc, 0.0)
                )
                margin[svc] = min(margin[svc], provided.get(svc, 0.0) - floor)

        note_margin(pre_instances)
        for clock, snap in cluster.instance_trace[n0:]:
            t = now + (clock - clock0) * scale
            timeline.append((t, dict(snap)))
            note_margin(snap)

        end = now + report.parallel_seconds
        record = TransitionRecord(
            start_s=now,
            end_s=end,
            serial_seconds=report.serial_seconds,
            parallel_seconds=report.parallel_seconds,
            action_counts=dict(report.action_counts),
            old_required=dict(sorted(old_required.items())),
            new_required=dict(sorted(new_required.items())),
            gpus_before=gpus_before,
            gpus_after=report.final_gpus_busy,
            transparency_margin=dict(sorted(margin.items())),
            trigger=trigger,
            reconcile=stats.to_dict() if stats is not None else None,
        )
        if self.obs is not None:
            self._trace_transition(now, cluster, n0, na0, clock0, scale, record, stats)
        return PendingTransition(now, end, timeline, record)

    def _trace_transition(
        self,
        now: float,
        cluster: SimulatedCluster,
        n0: int,
        na0: int,
        clock0: float,
        scale: float,
        record: TransitionRecord,
        stats: Optional[ReconcileStats],
    ) -> None:
        """Emit the plan/execute spans for one transition, one span per
        applied §6 action, and the reconcile counters.  Called only when the
        simulator installed an :class:`repro_torch.obs.Observability` on the
        driver, so the default path never reaches this."""
        tracer = self.obs.tracer
        tracer.span(
            "reoptimize",
            "plan",
            now,
            now,
            args={
                "trigger": record.trigger,
                "actions": {
                    k: v for k, v in sorted(record.action_counts.items())
                },
            },
        )
        tracer.span(
            "reoptimize",
            "execute",
            now,
            record.end_s,
            args={
                "serial_s": round(record.serial_seconds, 6),
                "parallel_s": round(record.parallel_seconds, 6),
                "gpus_before": record.gpus_before,
                "gpus_after": record.gpus_after,
            },
        )
        # each applied action's serial window, compressed by the same factor
        # as the instance-set timeline.  instance_trace entries pair 1:1 with
        # actions_applied while record_instance_trace is on (apply() appends
        # both), so the action's completion clock comes from the trace entry
        # — robust to fault hooks stretching or wasting wall clock between
        # attempts — and its start backs off by the charged seconds.
        trace_tail = cluster.instance_trace[n0:]
        actions = cluster.actions_applied[na0:]
        seconds = cluster.applied_seconds[na0:]
        for (clock, _snap), action, dur in zip(trace_tail, actions, seconds):
            t1 = now + (clock - clock0) * scale
            t0 = now + (clock - dur - clock0) * scale
            args = {"gpu": action.gpu}
            if action.service:
                args["service"] = action.service
            if action.size:
                args["size"] = action.size
            if action.kind == "migrate":
                args["dst_gpu"] = action.dst_gpu
            tracer.span("actions", action.kind, t0, t1, args=args)
        m = self.obs.metrics
        m.counter("transitions").inc(1.0)
        m.histogram("transition.parallel_s").observe(record.parallel_seconds)
        if stats is not None:
            m.counter("reconcile.iterations").inc(float(stats.iterations))
            m.counter("reconcile.retried").inc(float(stats.retried))
            m.counter("reconcile.abandoned").inc(float(stats.abandoned))
            for name in stats.faults:
                tracer.instant(
                    "reconcile", f"fault:{name}", now, args={"trigger": record.trigger}
                )
