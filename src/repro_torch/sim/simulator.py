"""Closed-loop trace-driven cluster serving simulator.

The loop the paper's headline figures (13-14) measure, in one place:

  traffic arrives (a :class:`repro_torch.sim.traffic.Trace`)
    -> the per-service :class:`WeightedRouter` spreads requests over the
       service's MIG instances proportionally to their profiled throughput
    -> each instance serves at its profile rate; excess queues (fluid backlog)
    -> per-bin SLO-attainment accounting
    -> every ``reoptimize_every_s`` the :class:`ReoptimizeDriver` re-runs the
       optimizer pipeline on the observed load and, when demand moved,
       executes a transparent exchange-and-compact transition whose
       Figure-13c action latencies are charged to in-flight capacity.

Everything is driven by the deterministic event queue in
:mod:`repro_torch.sim.events`, and all randomness (Poisson arrivals, serving
noise) flows from the single ``SimConfig.seed`` — the same seed yields a
byte-identical :class:`SimReport`.

The port's copy of the JAX package's ``sim/simulator.py``, op for op: the
draws come in the same order and the floats are summed in the same order,
so one seed gives the reference's report bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.controlplane.faults import FAULT_PROFILES, DeviceFault
from repro_torch.controlplane.reconciler import ControlPlane, build_control_plane
from repro_torch.controlplane.spec import ClusterSpec
from repro_torch.core.cluster import SimulatedCluster
from repro_torch.core.profiles import PerfProfile
from repro_torch.core.rms import ReconfigRules
from repro_torch.obs import Observability
from repro_torch.serving.router import InstanceHandle, WeightedRouter

from repro_torch.sim.events import (
    BIN_TICK,
    END,
    FAULT,
    RECONCILE,
    REOPTIMIZE,
    TRANSITION_DONE,
    Clock,
    EventQueue,
)
from repro_torch.sim.reoptimize import InstanceSet, PendingTransition, ReoptimizeDriver
from repro_torch.sim.report import (
    FaultRecord,
    ServiceTimeline,
    SimReport,
    TransitionRecord,
)
from repro_torch.sim.servemodel import TokenKnobs, TokenServingState
from repro_torch.sim.traffic import PRIORITY_CLASSES, PriorityMix, Trace


@dataclasses.dataclass
class SimConfig:
    """Knobs of one simulation run (all defaults paper-flavored)."""

    reoptimize_every_s: float = 1800.0  # observe->optimize cadence
    latency_slo_ms: float = 100.0  # per-request latency SLO (§8)
    # per-service latency SLO overrides (svc -> ms); unlisted services use
    # latency_slo_ms (the "richer SLO policy" knob).
    latency_targets: Optional[Dict[str, float]] = None
    headroom: float = 1.1  # required = observed rate x headroom
    change_threshold: float = 0.15  # demand move that triggers a transition
    use_phase2: bool = False  # run the GA/MCTS phase (slower, fewer GPUs)
    arrivals: str = "poisson"  # "poisson" | "fluid" (exact rate x dt)
    max_picks_per_bin: int = 256  # router picks per (service, bin); arrivals
    # beyond this are dispatched in equal chunks through the same picks
    throughput_noise: float = 0.0  # serving-vs-profiling variance (Fig. 14)
    seed: int = 0
    initial_gpus: int = 1  # cluster grows on demand past this
    # control plane (repro_torch.controlplane): route transitions through the
    # level-triggered reconciler.  With fault_profile="none" this is
    # bit-for-bit identical to the direct path (the tests pin it); a real
    # fault profile implies control_plane=True.
    control_plane: bool = False
    fault_profile: str = "none"  # a repro_torch.controlplane FAULT_PROFILES name
    # serving model: "fluid" (per-bin rate arithmetic, the historical
    # default) or "token" (repro_torch.sim.servemodel: discrete requests with
    # per-token clocks, paged-KV pressure, preemption, TTFT/TPOT metrics)
    serving_model: str = "fluid"
    token_knobs: Optional[TokenKnobs] = None  # None -> TokenKnobs() defaults
    # overload resilience (token mode only): when set, requests carry a
    # priority class + SLO deadline, the token model runs its resilience
    # path (priority admission, deadline drops, victim eviction, retry
    # backoff), admission control sheds lowest-class-first, and the report
    # gains the per-class priority block.  None keeps every historical code
    # path (and its report bytes) identical.
    priority_mix: Optional[PriorityMix] = None
    # warm-start incremental reoptimization: seed each reoptimize from the
    # incumbent deployment (rebound ConfigSpace + greedy delta repair +
    # bounded edit distance) instead of re-solving from scratch.  Off by
    # default — every historical report stays byte-identical.
    warm_start: bool = False
    # flight-recorder observability (repro_torch.obs): sim-time span tracing, a
    # per-bin-sampled metrics registry, and (token mode) the per-request
    # flight recorder, all surfaced through SimReport.obs and the tracer's
    # Chrome trace-event export.  Off by default — every historical report
    # (and every cell's report SHA) stays byte-identical.
    observability: bool = False
    obs_record_limit: int = 256  # flight-recorder request cap (token mode)

    def __post_init__(self):
        # fail fast with the valid names — not a deep KeyError mid-run
        if self.arrivals not in ("poisson", "fluid"):
            raise ValueError(
                f"unknown arrivals mode {self.arrivals!r}; "
                "valid: ['fluid', 'poisson']"
            )
        if self.fault_profile not in FAULT_PROFILES:
            raise ValueError(
                f"unknown fault profile {self.fault_profile!r}; "
                f"registered profiles: {sorted(FAULT_PROFILES)}"
            )
        if self.serving_model not in ("fluid", "token"):
            raise ValueError(
                f"unknown serving model {self.serving_model!r}; "
                "valid: ['fluid', 'token']"
            )
        if self.serving_model == "token" and self.arrivals != "poisson":
            # discrete requests need integer arrivals
            raise ValueError(
                "serving_model='token' requires arrivals='poisson'"
            )
        if self.priority_mix is not None and self.serving_model != "token":
            raise ValueError(
                "priority_mix requires serving_model='token' (the fluid "
                "model has no per-request priority semantics)"
            )
        if self.obs_record_limit < 0:
            raise ValueError(
                f"obs_record_limit must be >= 0, got {self.obs_record_limit}"
            )
        if self.fault_profile != "none":
            self.control_plane = True


class ClusterSimulator:
    """Wires trace -> router -> instances -> SLO accounting -> re-optimizer."""

    def __init__(
        self,
        rules: ReconfigRules,
        profile: PerfProfile,
        trace: Trace,
        config: Optional[SimConfig] = None,
        optimizer_kwargs: Optional[Dict] = None,
    ):
        self.rules = rules
        self.profile = profile
        self.trace = trace
        self.config = config or SimConfig()
        self.driver = ReoptimizeDriver(
            rules,
            profile,
            latency_slo_ms=self.config.latency_slo_ms,
            headroom=self.config.headroom,
            change_threshold=self.config.change_threshold,
            use_phase2=self.config.use_phase2,
            seed=self.config.seed,
            optimizer_kwargs=optimizer_kwargs,
            latency_targets=self.config.latency_targets,
            warm_start=self.config.warm_start,
        )
        self.cluster = SimulatedCluster(rules, self.config.initial_gpus)
        # flight-recorder observability: null implementations when off, so
        # every instrumentation site costs one attribute check and the
        # historical report bytes cannot shift
        self.obs = (
            Observability.on(self.config.obs_record_limit)
            if self.config.observability
            else Observability.off()
        )
        if self.obs.enabled:
            self.driver.obs = self.obs
        # the control plane (None in direct mode): reconciler + fault
        # injector + degraded-mode admission control under one profile
        self.control_plane: Optional[ControlPlane] = None
        if self.config.control_plane:
            self.control_plane = build_control_plane(
                self.driver.controller,
                self.config.fault_profile,
                self.config.seed,
                trace.duration_s,
            )
            self.driver.control_plane = self.control_plane
        # serving state
        self._pending: Optional[PendingTransition] = None
        self._routers: Dict[str, Tuple[Tuple, WeightedRouter]] = {}
        self._backlog: Dict[int, float] = {}  # uid -> queued requests
        self._backlog_svc: Dict[int, str] = {}  # uid -> owning service
        self._spill: Dict[str, float] = {}  # requeued load of vanished uids
        self._noise: Dict[int, float] = {}  # uid -> serving noise factor
        self._dead_uids: set = set()  # instances lost to device failures
        self._faults: List[FaultRecord] = []  # injected device faults
        # token serving model (None in fluid mode — the fluid path is
        # untouched, so fluid reports keep their exact bytes)
        self._token: Optional[TokenServingState] = None
        if self.config.serving_model == "token":
            targets = self.config.latency_targets or {}
            default_slo = self.config.latency_slo_ms
            self._token = TokenServingState(
                trace.services,
                profile,
                lambda svc: targets.get(svc, default_slo),
                self.config.token_knobs,
                mix=self.config.priority_mix,
                recorder=self.obs.flight,  # None when observability is off
            )
            # per-service [preemptions, refusals, deadline_dropped,
            # retry_dropped] seen through the prior bin, for the per-bin
            # delta series (the last two only serialize under a mix)
            self._tok_prev: Dict[str, List[int]] = {
                svc: [0, 0, 0, 0] for svc in trace.services
            }

    @property
    def _fault_mode(self) -> bool:
        return self.control_plane is not None and self.control_plane.fault_mode

    # -- instance plumbing -------------------------------------------------------
    def _active_instances(self, t: float) -> InstanceSet:
        if self._pending is not None and t < self._pending.end_s:
            insts = self._pending.instances_at(t)
            if self._dead_uids:
                # a device failed while the transition timeline was still
                # paying latencies: its instances are gone, whatever the
                # snapshot says
                insts = {
                    u: v for u, v in insts.items() if u not in self._dead_uids
                }
            return insts
        return self.cluster.busy_instances()

    def _noise_of(self, uid: int) -> float:
        if self.config.throughput_noise <= 0:
            return 1.0
        if uid not in self._noise:
            # one seeded draw per instance lifetime, independent of when the
            # instance first serves (instance-creation order is deterministic)
            sub = np.random.default_rng((self.config.seed, uid))
            self._noise[uid] = float(
                sub.uniform(
                    1.0 - self.config.throughput_noise,
                    1.0 + self.config.throughput_noise,
                )
            )
        return self._noise[uid]

    def _router_for(
        self, svc: str, members: List[Tuple[int, int, float]]
    ) -> WeightedRouter:
        """A persistent smooth-WRR per service, rebuilt only when the
        instance set changes (so WRR state survives across bins)."""
        key = tuple(members)
        cached = self._routers.get(svc)
        if cached is not None and cached[0] == key:
            return cached[1]
        router = WeightedRouter(
            [
                InstanceHandle(instance_id=uid, size=size, throughput=tput)
                for uid, size, tput in members
            ]
        )
        self._routers[svc] = (key, router)
        return router

    # -- one traffic bin ---------------------------------------------------------
    def _process_bin(
        self,
        k: int,
        t: float,
        rng: np.random.Generator,
        out: Dict[str, Dict[str, List[float]]],
    ) -> None:
        if self._token is not None:
            self._process_bin_token(k, t, rng, out)
            return
        dt = self.trace.bin_s
        instances = self._active_instances(t)
        # queued requests of instances that vanished (deleted/migrated away
        # mid-transition) are re-dispatched at the service level this bin
        for uid in [u for u in self._backlog if u not in instances]:
            q = self._backlog.pop(uid)
            svc = self._backlog_svc.pop(uid)
            if q > 0:
                self._spill[svc] = self._spill.get(svc, 0.0) + q
        # uids never recur (itertools.count), so their noise draws are dead
        for uid in [u for u in self._noise if u not in instances]:
            del self._noise[uid]
        by_svc: Dict[str, List[Tuple[int, int, float]]] = {}
        for uid in sorted(instances):
            svc, size, tput = instances[uid]
            by_svc.setdefault(svc, []).append(
                (uid, size, tput * self._noise_of(uid))
            )
        required = {
            s.name: s.slo.throughput for s in self.driver.workload.services
        } if self.driver.workload else {}
        # degraded-mode admission control (repro_torch.controlplane.degraded):
        # engaged only while the control plane is actually in an outage —
        # observed state diverged from desired (a device died, a node is
        # draining) or a fault-triggered repair is still paying its action
        # latencies.  Healthy-cluster bursts, before or after an outage,
        # keep the fluid-queue backlog semantics of the default mode.
        admission = (
            self.control_plane.admission
            if self.control_plane is not None
            else None
        )
        degraded = bool(
            admission is not None
            and self.driver.desired is not None
            and (
                (
                    self._pending is not None
                    and self._pending.record.trigger == "fault"
                )
                or self.control_plane.reconciler.diverged(
                    self.cluster, self.driver.desired
                )
            )
        )

        tot_backlog = 0.0  # observability gauges (cost: two adds per svc)
        tot_shed = 0.0
        for svc in self.trace.services:
            rate = float(self.trace.rates[svc][k])
            if self.config.arrivals == "poisson":
                arrivals = float(rng.poisson(rate * dt))
            else:
                arrivals = rate * dt
            # demand = this bin's true arrivals + requeued spill; only the
            # former is recorded as arrivals (spill was counted on arrival)
            demand = arrivals + self._spill.pop(svc, 0.0)
            members = by_svc.get(svc, [])
            served = 0.0
            capacity_rate = sum(m[2] for m in members)
            shed = 0.0
            req_rate_now = required.get(svc, 0.0)
            if (
                degraded
                and req_rate_now > 0
                and capacity_rate < req_rate_now * (1.0 - 1e-9)
            ):
                # this service is under-provisioned against its SLO (the
                # outage, not a stochastic burst): shed what post-failure
                # capacity cannot absorb.  Shed requests were counted as
                # arrivals and are never served, so the outage charges
                # honestly to the report
                demand, shed = admission.admit(demand, capacity_rate * dt)
            if members:
                router = self._router_for(svc, members)
                load: Dict[int, float] = {}
                if demand > 0:
                    picks = min(
                        int(math.ceil(demand)), self.config.max_picks_per_bin
                    )
                    chunk = demand / picks
                    for _ in range(picks):
                        h = router.pick()
                        load[h.instance_id] = load.get(h.instance_id, 0.0) + chunk
                for uid, _size, tput in members:
                    q = self._backlog.get(uid, 0.0) + load.get(uid, 0.0)
                    s = min(q, tput * dt)
                    self._backlog[uid] = q - s
                    self._backlog_svc[uid] = svc
                    served += s
            elif demand > 0:
                # no capacity this bin: everything queues at the service level
                self._spill[svc] = self._spill.get(svc, 0.0) + demand

            backlog = sum(
                self._backlog.get(m[0], 0.0) for m in members
            ) + self._spill.get(svc, 0.0)

            req_rate = required.get(svc, 0.0)
            series = out[svc]
            series["arrivals"].append(arrivals)
            series["served"].append(served)
            series["capacity"].append(capacity_rate * dt)
            series["backlog"].append(backlog)
            series["required"].append(req_rate * dt)
            series["attainment"].append(
                min(1.0, capacity_rate / req_rate) if req_rate > 0 else 1.0
            )
            if self._fault_mode:
                series["shed"].append(shed)
            tot_backlog += backlog
            tot_shed += shed

        if self.obs.enabled:
            m = self.obs.metrics
            m.gauge("queue.depth").set(tot_backlog)
            if self._fault_mode:
                m.counter("admission.shed").inc(tot_shed)
            m.sample(t + dt)

    def _process_bin_token(
        self,
        k: int,
        t: float,
        rng: np.random.Generator,
        out: Dict[str, Dict[str, List[float]]],
    ) -> None:
        """Token-level serving for one bin: discrete requests through the
        per-instance :class:`repro_torch.sim.servemodel.InstanceModel`s instead of
        fluid backlog arithmetic.  capacity/required/attainment use the same
        math as the fluid path; served and backlog come from actual request
        completions and in-system counts, and two extra series (preempted,
        refused) surface the KV-pressure events the fluid model cannot see.
        """
        dt = self.trace.bin_s
        tok = self._token
        instances = self._active_instances(t)
        # uids never recur (itertools.count), so their noise draws are dead
        for uid in [u for u in self._noise if u not in instances]:
            del self._noise[uid]
        by_svc: Dict[str, List[Tuple[int, int, float]]] = {}
        for uid in sorted(instances):
            svc, size, tput = instances[uid]
            by_svc.setdefault(svc, []).append(
                (uid, size, tput * self._noise_of(uid))
            )
        # vanished instances spill their queued/in-flight requests back to
        # the service level; new instances get fresh engine twins
        tok.sync_instances(instances, self._noise_of, t)
        required = {
            s.name: s.slo.throughput for s in self.driver.workload.services
        } if self.driver.workload else {}
        admission = (
            self.control_plane.admission
            if self.control_plane is not None
            else None
        )
        degraded = bool(
            admission is not None
            and self.driver.desired is not None
            and (
                (
                    self._pending is not None
                    and self._pending.record.trigger == "fault"
                )
                or self.control_plane.reconciler.diverged(
                    self.cluster, self.driver.desired
                )
            )
        )

        # dispatch pass: draw this bin's discrete arrivals and route them
        # through the same persistent smooth-WRR the fluid path uses
        arrived: Dict[str, int] = {}
        shed_by_svc: Dict[str, float] = {}
        for svc in self.trace.services:
            rate = float(self.trace.rates[svc][k])
            n = int(rng.poisson(rate * dt))
            arrived[svc] = n
            members = by_svc.get(svc, [])
            capacity_rate = sum(m[2] for m in members)
            shed = 0.0
            req_rate_now = required.get(svc, 0.0)
            under_capacity = bool(
                degraded
                and req_rate_now > 0
                and capacity_rate < req_rate_now * (1.0 - 1e-9)
            )
            if tok.mix is not None:
                # resilience path: draw ALL arrivals first (each with its
                # class + deadline), then shed lowest-class-first through
                # the priority-aware admission controller, keeping the
                # earliest arrivals within the marginal class
                reqs = [
                    tok.make_request(svc, t + (i + 0.5) * dt / n, rng)
                    for i in range(n)
                ]
                if under_capacity:
                    counts = [0] * len(PRIORITY_CLASSES)
                    for r in reqs:
                        counts[r.priority] += 1
                    plan = admission.admit_by_class(
                        [
                            (c, 1.0, float(counts[c]))
                            for c in range(len(counts))
                        ],
                        capacity_rate * dt,
                    )
                    quota = [int(adm) for adm, _ in plan]
                    kept = []
                    used = [0] * len(PRIORITY_CLASSES)
                    for r in reqs:
                        if used[r.priority] < quota[r.priority]:
                            used[r.priority] += 1
                            kept.append(r)
                        else:
                            tok.record_shed(r)
                    shed = float(len(reqs) - len(kept))
                    reqs = kept
            else:
                n_admit = n
                if under_capacity:
                    kept, _ = admission.admit(float(n), capacity_rate * dt)
                    n_admit = int(kept)
                    shed = float(n - n_admit)
                # deterministic arrival offsets spread through the bin
                reqs = [
                    tok.make_request(svc, t + (i + 0.5) * dt / n_admit, rng)
                    for i in range(n_admit)
                ]
            shed_by_svc[svc] = shed
            if members:
                router = self._router_for(svc, members)
                tok.dispatch(
                    svc,
                    [m[0] for m in members],
                    lambda r=router: r.pick().instance_id,
                    reqs,
                )
            else:
                tok.dispatch(svc, [], lambda: 0, reqs)

        # serving pass: advance every instance's clock to the bin edge
        tok.serve_bin(t + dt)

        # accounting pass; the last bin's window is open-ended so step
        # overrun past the trace end still counts its completions
        t1 = float("inf") if k == self.trace.num_bins - 1 else t + dt
        tot_completed = 0.0
        for svc in self.trace.services:
            members = by_svc.get(svc, [])
            capacity_rate = sum(m[2] for m in members)
            req_rate = required.get(svc, 0.0)
            prev = self._tok_prev[svc]
            pre = tok.metrics.preemptions[svc]
            ref = tok.metrics.refusals[svc]
            dd = tok.metrics.deadline_dropped[svc]
            rd = tok.metrics.retry_dropped[svc]
            done = float(tok.completed_in(svc, t, t1))
            tot_completed += done
            series = out[svc]
            series["arrivals"].append(float(arrived[svc]))
            series["served"].append(done)
            series["capacity"].append(capacity_rate * dt)
            series["backlog"].append(float(tok.in_system(svc)))
            series["required"].append(req_rate * dt)
            series["attainment"].append(
                min(1.0, capacity_rate / req_rate) if req_rate > 0 else 1.0
            )
            series["preempted"].append(float(pre - prev[0]))
            series["refused"].append(float(ref - prev[1]))
            if tok.mix is not None:
                series["deadline_dropped"].append(float(dd - prev[2]))
                series["retry_dropped"].append(float(rd - prev[3]))
            self._tok_prev[svc] = [pre, ref, dd, rd]
            if self._fault_mode:
                series["shed"].append(shed_by_svc[svc])

        if self.obs.enabled:
            m = self.obs.metrics
            tm = tok.metrics
            used = total_pages = backoff_n = 0
            depth = [0] * len(PRIORITY_CLASSES)
            for inst in tok.instances.values():
                used += inst.pool.num_pages - inst.pool.free_pages
                total_pages += inst.pool.num_pages
                backoff_n += len(inst.backoff)
                for cls, q in enumerate(inst.queues):
                    depth[cls] += len(q)
            spilled = sum(len(v) for v in tok.spill.values())
            m.gauge("pages.used").set(float(used))
            m.gauge("pages.total").set(float(total_pages))
            m.gauge("queue.depth").set(float(sum(depth) + spilled))
            if tok.mix is not None:
                for cls, name in enumerate(PRIORITY_CLASSES):
                    m.gauge(f"queue.depth.{name}").set(float(depth[cls]))
                m.gauge("backoff.heap").set(float(backoff_n))
                m.counter("serving.deadline_dropped").inc_to(
                    float(sum(tm.deadline_dropped.values()))
                )
                m.counter("serving.retry_dropped").inc_to(
                    float(sum(tm.retry_dropped.values()))
                )
                m.counter("serving.retries").inc_to(
                    float(sum(tm.class_retries))
                )
            # counters advance to the model's running totals, so per-bin
            # deltas fall out of the sampled series without shadow state
            m.counter("serving.preemptions").inc_to(
                float(sum(tm.preemptions.values()))
            )
            m.counter("serving.refusals").inc_to(
                float(sum(tm.refusals.values()))
            )
            m.counter("serving.completed").inc_to(
                float(sum(len(v) for v in tm.completed_at.values()))
            )
            if self._fault_mode:
                m.counter("admission.shed").inc(sum(shed_by_svc.values()))
            m.sample(t + dt)
            self.obs.tracer.span(
                "serving",
                f"bin{k}",
                t,
                t + dt,
                args={
                    "arrivals": int(sum(arrived.values())),
                    "completed": int(tot_completed),
                },
            )

    # -- main loop ---------------------------------------------------------------
    def run(self) -> SimReport:
        cfg = self.config
        trace = self.trace
        rng = np.random.default_rng(cfg.seed)
        clock = Clock(0.0)
        queue = EventQueue()
        for k in range(trace.num_bins):
            queue.push(k * trace.bin_s, BIN_TICK, k)
        t = cfg.reoptimize_every_s
        while t < trace.duration_s - 1e-9:
            queue.push(t, REOPTIMIZE, None)
            t += cfg.reoptimize_every_s
        queue.push(trace.duration_s, END, None)
        # injected device faults fire as first-class events
        if self._fault_mode and self.control_plane.injector is not None:
            for fault in self.control_plane.injector.device_faults():
                if fault.time_s < trace.duration_s - 1e-9:
                    queue.push(fault.time_s, FAULT, fault)

        # initial deployment sized for the trace's opening rates
        self.driver.initial_deploy(self.cluster, trace.rates_at(0.0))

        series_names = (
            "arrivals", "served", "capacity",
            "backlog", "required", "attainment",
        ) + (("shed",) if self._fault_mode else ()) + (
            ("preempted", "refused") if self._token is not None else ()
        ) + (
            ("deadline_dropped", "retry_dropped")
            if self._token is not None and self._token.mix is not None
            else ()
        )
        out: Dict[str, Dict[str, List[float]]] = {
            svc: {name: [] for name in series_names}
            for svc in trace.services
        }
        transitions: List[TransitionRecord] = []
        checks = 0

        for ev in queue.drain():
            clock.advance_to(ev.time)
            if ev.kind == BIN_TICK:
                self._process_bin(ev.payload, ev.time, rng, out)
            elif ev.kind == REOPTIMIZE:
                checks += 1
                if self._pending is not None and ev.time < self._pending.end_s:
                    continue  # a transition is still paying its latencies
                observed = trace.mean_rates(
                    ev.time - cfg.reoptimize_every_s, ev.time
                )
                if self.obs.enabled:
                    # the observe leg of observe->optimize->plan->execute:
                    # zero-duration (rates are read instantaneously in sim
                    # time), carrying the windowed per-service rates
                    self.obs.tracer.span(
                        "reoptimize",
                        "observe",
                        ev.time,
                        ev.time,
                        args={
                            "window_s": cfg.reoptimize_every_s,
                            "rates": {
                                s: round(float(r), 6)
                                for s, r in sorted(observed.items())
                            },
                        },
                    )
                pending = self.driver.reoptimize(self.cluster, observed, ev.time)
                if pending is not None:
                    self._pending = pending
                    transitions.append(pending.record)
                    queue.push(pending.end_s, TRANSITION_DONE, None)
            elif ev.kind == TRANSITION_DONE:
                if self._pending is not None and ev.time >= self._pending.end_s:
                    self._pending = None
                    self._routers.clear()
            elif ev.kind == FAULT:
                rec = self._apply_device_fault(ev.payload, ev.time)
                if rec is not None:
                    self._faults.append(rec)
                    if self.obs.enabled:
                        self.obs.tracer.instant(
                            "faults",
                            f"inject:{rec.kind}",
                            ev.time,
                            args={
                                "target": rec.target,
                                "fault_domain": rec.fault_domain,
                                "killed_instances": rec.killed_instances,
                            },
                        )
                        self.obs.metrics.counter("faults.injected").inc(1.0)
                    if rec.kind != "instance_crash":
                        self._routers.clear()
                        # the control plane notices after its detection delay
                        delay = self.control_plane.profile.detection_delay_s
                        if self.obs.enabled:
                            # the inject->detect arc: the window where the
                            # cluster is degraded but the plane is blind
                            self.obs.tracer.span(
                                "faults",
                                f"detect:{rec.kind}",
                                ev.time,
                                ev.time + delay,
                                args={"target": rec.target},
                            )
                        queue.push(ev.time + delay, RECONCILE, None)
                    # an instance crash restarts in place: the device is
                    # healthy and the instance set unchanged, so there is
                    # nothing for the reconciler to repair — the cost is
                    # the spilled in-flight work, not a capacity hole
            elif ev.kind == RECONCILE:
                if self._pending is not None and ev.time < self._pending.end_s - 1e-9:
                    # let the in-flight transition settle, then look again
                    queue.push(self._pending.end_s, RECONCILE, None)
                    continue
                pending = self.driver.reconcile_divergence(self.cluster, ev.time)
                if pending is not None:
                    self._pending = pending
                    transitions.append(pending.record)
                    queue.push(pending.end_s, TRANSITION_DONE, None)
                    if self.obs.enabled:
                        # the detect->recover arc closes when the repair
                        # transition finishes paying its action latencies
                        self.obs.tracer.span(
                            "faults",
                            "recover",
                            ev.time,
                            pending.end_s,
                            args={
                                "actions": sum(
                                    pending.record.action_counts.values()
                                ),
                                "gpus_after": pending.record.gpus_after,
                            },
                        )
            elif ev.kind == END:
                break

        times = np.arange(trace.num_bins, dtype=np.float64) * trace.bin_s
        timelines = {
            svc: ServiceTimeline(
                arrivals=np.asarray(series["arrivals"]),
                served=np.asarray(series["served"]),
                capacity=np.asarray(series["capacity"]),
                backlog=np.asarray(series["backlog"]),
                required=np.asarray(series["required"]),
                attainment=np.asarray(series["attainment"]),
                shed=(
                    np.asarray(series["shed"]) if "shed" in series else None
                ),
                preempted=(
                    np.asarray(series["preempted"])
                    if "preempted" in series
                    else None
                ),
                refused=(
                    np.asarray(series["refused"])
                    if "refused" in series
                    else None
                ),
                deadline_dropped=(
                    np.asarray(series["deadline_dropped"])
                    if "deadline_dropped" in series
                    else None
                ),
                retry_dropped=(
                    np.asarray(series["retry_dropped"])
                    if "retry_dropped" in series
                    else None
                ),
            )
            for svc, series in out.items()
        }
        obs_block: Optional[Dict] = None
        if self.obs.enabled:
            self.obs.tracer.assert_well_formed()
            obs_block = {
                "metrics": self.obs.metrics.snapshot(),
                "spans": self.obs.tracer.span_summary(),
            }
            if self.obs.flight is not None and self._token is not None:
                obs_block["flight"] = self.obs.flight.snapshot()
        return SimReport(
            seed=cfg.seed,
            bin_s=trace.bin_s,
            times=times,
            services=trace.services,
            timelines=timelines,
            transitions=transitions,
            reoptimize_checks=checks,
            final_gpus=self.cluster.gpus_in_use(),
            faults=self._faults,
            serving_model=cfg.serving_model,
            latency=(
                self._token.latency_summary()
                if self._token is not None
                else None
            ),
            priority=(
                self._token.priority_summary()
                if self._token is not None and self._token.mix is not None
                else None
            ),
            obs=obs_block,
        )

    # -- device faults -----------------------------------------------------------
    def _apply_device_fault(
        self, fault: DeviceFault, now: float
    ) -> Optional[FaultRecord]:
        """Fire one scheduled device fault; target picked deterministically
        (seeded injector RNG over sorted candidates).  Returns ``None`` when
        no eligible target exists (nothing busy to break)."""
        cluster = self.cluster
        injector = self.control_plane.injector
        if injector is None:
            raise RuntimeError(
                "device fault fired without a fault injector — scheduled "
                "faults require control_plane.injector to be configured"
            )
        spec = ClusterSpec.from_cluster(cluster)
        if fault.kind == "gpu_failure":
            busy = [
                gid for gid, g in cluster.gpus.items()
                if g.busy() and gid not in cluster.failed
            ]
            gid = injector.pick_gpu(busy)
            if gid is None:
                return None
            machine = cluster.gpus[gid].machine
            lost: Dict[str, float] = {}
            for r in cluster.gpus[gid].instances.values():
                if r.service:
                    lost[r.service] = lost.get(r.service, 0.0) + r.throughput
            killed = cluster.fail_gpu(gid)
            # kill every uid that ever lived on this device, not just the
            # live ones: an in-flight transition timeline may still replay
            # snapshots holding instances the plan deletes later, and those
            # must not keep serving from dead hardware
            self._dead_uids.update(
                u for u, g in cluster.uid_gpu.items() if g == gid
            )
            return FaultRecord(
                time_s=now,
                kind="gpu_failure",
                target=gid,
                fault_domain=spec.fault_domain_of(machine),
                killed_instances=len(killed),
                lost_throughput=lost,
            )
        if fault.kind == "instance_crash":
            # serving-path fault: one instance's process dies mid-decode.
            # The device stays healthy and the instance restarts in place
            # with cold state, so no repair transition fires — the damage is
            # the spilled in-flight work (KV lost in token mode, backlog
            # respilled in fluid mode)
            if self._token is not None:
                tok = self._token
                busy = [
                    u
                    for u, inst in tok.instances.items()
                    if inst.in_system > 0
                ]
                uid = injector.pick_instance(busy or sorted(tok.instances))
                if uid is None:
                    return None
                svc = tok.instances[uid].service
                spilled = float(tok.crash_instance(uid, now))
            else:
                busy = [u for u, q in self._backlog.items() if q > 0]
                uid = injector.pick_instance(busy)
                if uid is None:
                    return None
                spilled = float(self._backlog.pop(uid, 0.0))
                svc = self._backlog_svc.pop(uid, "")
                if svc and spilled > 0:
                    self._spill[svc] = self._spill.get(svc, 0.0) + spilled
            gid = cluster.uid_gpu.get(uid)
            domain = (
                spec.fault_domain_of(cluster.gpus[gid].machine)
                if gid is not None and gid in cluster.gpus
                else "unknown"
            )
            return FaultRecord(
                time_s=now,
                kind="instance_crash",
                target=uid,
                fault_domain=domain,
                killed_instances=0,
                lost_throughput={},
                spilled=spilled,
            )
        if fault.kind == "node_drain":
            machines = sorted(
                {
                    g.machine
                    for gid, g in cluster.gpus.items()
                    if g.busy() and gid not in cluster.failed
                }
            )
            machine = injector.pick_machine(machines)
            if machine is None:
                return None
            cluster.drain_machine(machine)
            # a drain kills nothing — its instances keep serving until the
            # reconciler migrates them off the cordoned machine
            return FaultRecord(
                time_s=now,
                kind="node_drain",
                target=machine,
                fault_domain=spec.fault_domain_of(machine),
                killed_instances=0,
                lost_throughput={},
            )
        raise ValueError(fault.kind)
