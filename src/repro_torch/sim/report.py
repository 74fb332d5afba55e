"""Simulation reports: per-bin timelines, transition records, summaries.

A :class:`SimReport` is the simulator's only output — everything the
benchmarks and tests consume (SLO attainment, transition makespans, the §6
transparency margin) is derived from it.  ``to_json()`` is deterministic
(sorted keys, canonical float repr), so two runs with the same seed must
produce byte-identical serializations — the property the test suite pins.

The port's copy of the JAX package's ``sim/report.py``, op for op: the same
records serialize to the reference's bytes, which hang on dict insertion
order and on ``json.dumps``'s arguments, so neither may change.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TransitionRecord:
    """One re-optimization + controller transition executed mid-run."""

    start_s: float  # sim time the reoptimize fired
    end_s: float  # sim time in-flight actions all finished
    serial_seconds: float
    parallel_seconds: float
    action_counts: Dict[str, int]
    old_required: Dict[str, float]  # SLO throughput before
    new_required: Dict[str, float]  # SLO throughput after
    gpus_before: int
    gpus_after: int
    # min over trace points of (capacity - min(old, new) required), per service;
    # the §6 transparency guarantee is exactly: every value >= 0.
    transparency_margin: Dict[str, float]
    # control-plane extensions: populated ONLY under a fault profile (the
    # serializer skips them when None, so default-mode reports keep their
    # exact pre-control-plane bytes)
    trigger: str = "demand"  # "demand" | "fault" — what fired this pass
    reconcile: Optional[Dict] = None  # ReconcileStats.to_dict()

    @property
    def transparent(self) -> bool:
        return all(m >= -1e-6 for m in self.transparency_margin.values())


@dataclasses.dataclass
class FaultRecord:
    """One injected device-level fault (repro_torch.controlplane.faults)."""

    time_s: float
    kind: str  # "gpu_failure" | "node_drain" | "instance_crash"
    target: int  # gpu id (failure), machine id (drain) or uid (crash)
    fault_domain: str
    killed_instances: int
    lost_throughput: Dict[str, float]  # per-service req/s that vanished
    # instance_crash only: in-flight requests (token mode) or backlogged
    # fluid requests that spilled with their work lost.  Serialized only
    # for crash records so historical fault-profile bytes stay identical.
    spilled: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "time_s": self.time_s,
            "kind": self.kind,
            "target": self.target,
            "fault_domain": self.fault_domain,
            "killed_instances": self.killed_instances,
            "lost_throughput": dict(sorted(self.lost_throughput.items())),
            **(
                {"spilled": self.spilled}
                if self.kind == "instance_crash"
                else {}
            ),
        }


@dataclasses.dataclass
class ServiceTimeline:
    """Per-bin series for one service (arrays of length num_bins)."""

    arrivals: np.ndarray  # requests arriving in the bin
    served: np.ndarray  # requests served in the bin
    capacity: np.ndarray  # requests the bin's instances could serve
    backlog: np.ndarray  # queued requests at bin end
    required: np.ndarray  # current SLO throughput * bin_s
    attainment: np.ndarray  # min(1, capacity / required)
    # degraded-mode admission control (fault profiles only; None otherwise
    # so default-mode serializations are unchanged)
    shed: Optional[np.ndarray] = None  # requests shed by admission control
    # token-level serving model only (serving_model="token"; None in fluid
    # mode so fluid serializations keep their exact pre-token bytes)
    preempted: Optional[np.ndarray] = None  # KV-pressure preemptions per bin
    refused: Optional[np.ndarray] = None  # OutOfPages admission refusals
    # resilience path only (token mode + priority mix; None otherwise so
    # no-priority token serializations keep their exact bytes)
    deadline_dropped: Optional[np.ndarray] = None  # expired-in-queue drops
    retry_dropped: Optional[np.ndarray] = None  # retry-budget exhaustions


@dataclasses.dataclass
class SimReport:
    seed: int
    bin_s: float
    times: np.ndarray  # bin start times
    services: List[str]
    timelines: Dict[str, ServiceTimeline]
    transitions: List[TransitionRecord]
    reoptimize_checks: int  # how many observe-points fired
    final_gpus: int
    # injected device faults (control-plane fault profiles only; empty in
    # default mode, where the serializer omits the key entirely)
    faults: List[FaultRecord] = dataclasses.field(default_factory=list)
    # token-level serving model extensions (serving_model="token" only; the
    # serializer omits both keys in fluid mode so fluid reports keep their
    # exact pre-token bytes)
    serving_model: str = "fluid"
    # per-service TTFT/TPOT/queueing-delay percentiles + "_totals" counts,
    # as produced by TokenServingState.latency_summary()
    latency: Optional[Dict] = None
    # per-priority-class goodput / SLO-attainment / drop / retry totals, as
    # produced by TokenServingState.priority_summary(); present only when a
    # priority mix is active (the serializer omits the key otherwise so
    # no-priority reports keep their exact bytes)
    priority: Optional[Dict] = None
    # flight-recorder observability (SimConfig.observability=True only): the
    # metrics-registry snapshot, span counts, and — token mode — the
    # per-request flight-recorder block, all sim-time.  None by default, and
    # the serializer omits the key, so every report without it keeps its
    # exact bytes.
    obs: Optional[Dict] = None

    # -- derived -----------------------------------------------------------------
    def slo_satisfaction(self, svc: str) -> float:
        """Fraction of bins whose provided capacity met the required rate."""
        tl = self.timelines[svc]
        return float(np.mean(tl.attainment >= 1.0 - 1e-9))

    def mean_attainment(self, svc: str) -> float:
        return float(np.mean(self.timelines[svc].attainment))

    def served_fraction(self, svc: str) -> float:
        tl = self.timelines[svc]
        tot = float(np.sum(tl.arrivals))
        return float(np.sum(tl.served)) / tot if tot > 0 else 1.0

    @property
    def transparent(self) -> bool:
        return all(t.transparent for t in self.transitions)

    def _all_attained(self) -> np.ndarray:
        """Per-bin bool: every service met its required rate this bin."""
        ok = np.ones(len(self.times), dtype=bool)
        for tl in self.timelines.values():
            ok &= tl.attainment >= 1.0 - 1e-9
        return ok

    def availability(self) -> float:
        """Fraction of bins in which every service met its required rate —
        the headline the fault-profile scenario cells compare."""
        return float(np.mean(self._all_attained()))

    def recovery_time_s(self) -> Optional[float]:
        """Worst time from an injected device fault to SLO re-attainment
        (the first bin at or after the fault where every service meets its
        required rate again).  ``None`` when no faults were injected; when a
        fault is never recovered from, censored at the end of the trace."""
        if not self.faults:
            return None
        ok = self._all_attained()
        end_s = float(self.times[-1] + self.bin_s)
        worst = 0.0
        for f in self.faults:
            k = int(np.searchsorted(self.times, f.time_s - 1e-9))
            recovered = None
            for j in range(k, len(ok)):
                if ok[j]:
                    recovered = float(self.times[j])
                    break
            took = (recovered - f.time_s) if recovered is not None else (
                end_s - f.time_s
            )
            worst = max(worst, took)
        return float(max(worst, 0.0))

    def shed_total(self) -> float:
        """Requests shed by degraded-mode admission control over the run."""
        return float(
            sum(
                np.sum(tl.shed)
                for tl in self.timelines.values()
                if tl.shed is not None
            )
        )

    def transparency_margin(self) -> float:
        """Worst §6 margin over all transitions and services (>= 0 means the
        guarantee held at every trace point)."""
        margins = [
            m for t in self.transitions for m in t.transparency_margin.values()
        ]
        return min(margins) if margins else float("inf")

    # -- serialization -----------------------------------------------------------
    def to_dict(self) -> Dict:
        def arr(a: np.ndarray) -> List[float]:
            return [float(x) for x in a]

        return {
            "seed": self.seed,
            "bin_s": self.bin_s,
            "times": arr(self.times),
            "services": list(self.services),
            "timelines": {
                svc: {
                    "arrivals": arr(tl.arrivals),
                    "served": arr(tl.served),
                    "capacity": arr(tl.capacity),
                    "backlog": arr(tl.backlog),
                    "required": arr(tl.required),
                    "attainment": arr(tl.attainment),
                    # key present only under fault profiles — default-mode
                    # bytes must not change
                    **({"shed": arr(tl.shed)} if tl.shed is not None else {}),
                    # keys present only under the token serving model —
                    # fluid-mode bytes must not change
                    **(
                        {"preempted": arr(tl.preempted)}
                        if tl.preempted is not None
                        else {}
                    ),
                    **(
                        {"refused": arr(tl.refused)}
                        if tl.refused is not None
                        else {}
                    ),
                    # keys present only on the resilience path (token +
                    # priority mix) — no-priority bytes must not change
                    **(
                        {"deadline_dropped": arr(tl.deadline_dropped)}
                        if tl.deadline_dropped is not None
                        else {}
                    ),
                    **(
                        {"retry_dropped": arr(tl.retry_dropped)}
                        if tl.retry_dropped is not None
                        else {}
                    ),
                }
                for svc, tl in sorted(self.timelines.items())
            },
            "transitions": [
                {
                    "start_s": t.start_s,
                    "end_s": t.end_s,
                    "serial_seconds": t.serial_seconds,
                    "parallel_seconds": t.parallel_seconds,
                    "action_counts": dict(sorted(t.action_counts.items())),
                    "old_required": dict(sorted(t.old_required.items())),
                    "new_required": dict(sorted(t.new_required.items())),
                    "gpus_before": t.gpus_before,
                    "gpus_after": t.gpus_after,
                    "transparency_margin": dict(
                        sorted(t.transparency_margin.items())
                    ),
                    "transparent": t.transparent,
                    # reconcile metadata only exists under fault profiles
                    **(
                        {"trigger": t.trigger, "reconcile": t.reconcile}
                        if t.reconcile is not None
                        else {}
                    ),
                }
                for t in self.transitions
            ],
            "reoptimize_checks": self.reoptimize_checks,
            "final_gpus": self.final_gpus,
            # injected faults only exist under fault profiles
            **(
                {"faults": [f.to_dict() for f in self.faults]}
                if self.faults
                else {}
            ),
            # token serving model only: fluid-mode reports omit both keys so
            # their serializations keep the exact pre-token bytes
            **(
                {"serving_model": self.serving_model, "latency": self.latency}
                if self.serving_model != "fluid"
                else {}
            ),
            # priority-mix resilience path only: no-priority reports (token
            # or fluid) omit the key so their bytes stay identical
            **(
                {"priority": self.priority}
                if self.priority is not None
                else {}
            ),
            # observability only: absent unless SimConfig.observability was
            # on, so default-mode reports keep their exact bytes
            **({"obs": self.obs} if self.obs is not None else {}),
        }

    def to_json(self) -> str:
        """Canonical serialization: byte-identical across same-seed runs."""
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))

    def summary(self) -> str:
        lines = [
            f"simulated {self.times[-1] + self.bin_s:.0f}s in {len(self.times)} bins"
            f" of {self.bin_s:.0f}s, seed={self.seed}",
            f"re-optimization checks: {self.reoptimize_checks},"
            f" transitions executed: {len(self.transitions)},"
            f" final GPUs busy: {self.final_gpus}",
        ]
        for svc in self.services:
            lines.append(
                f"  {svc}: slo-satisfied {self.slo_satisfaction(svc):.1%} of bins,"
                f" mean attainment {self.mean_attainment(svc):.3f},"
                f" served {self.served_fraction(svc):.1%} of arrivals"
            )
        if self.latency is not None:
            tot = self.latency.get("_totals", {})
            lines.append(
                f"  token serving: completed={tot.get('completed', 0)}"
                f" preemptions={tot.get('preemptions', 0)}"
                f" refusals={tot.get('refusals', 0)}"
            )
            for svc in self.services:
                s = self.latency.get(svc)
                if not s:
                    continue
                lines.append(
                    f"    {svc}: ttft p50={s['ttft_p50_s']:.3f}s"
                    f" p99={s['ttft_p99_s']:.3f}s"
                    f" tpot p50={s['tpot_p50_s'] * 1e3:.1f}ms"
                    f" queue p99={s['queue_delay_p99_s']:.3f}s"
                )
        if self.priority is not None:
            for cls, s in self.priority.items():
                lines.append(
                    f"  class {cls}: goodput={s['goodput']}/{s['arrivals']}"
                    f" (slo {s['slo_attainment']:.1%})"
                    f" deadline_dropped={s['deadline_dropped']}"
                    f" retry_dropped={s['retry_dropped']}"
                    f" shed={s['shed']} retries={s['retries']}"
                )
        for f in self.faults:
            spill = (
                f" spilled={f.spilled:.0f}"
                if f.kind == "instance_crash"
                else ""
            )
            lines.append(
                f"  FAULT t={f.time_s:.0f}s {f.kind} target={f.target}"
                f" ({f.fault_domain}) killed={f.killed_instances}"
                f" lost={dict(sorted(f.lost_throughput.items()))}" + spill
            )
        for i, t in enumerate(self.transitions):
            extra = ""
            if t.reconcile is not None:
                extra = (
                    f" trigger={t.trigger}"
                    f" reconcile(iter={t.reconcile['iterations']},"
                    f" retried={t.reconcile['retried']},"
                    f" converged={t.reconcile['converged']})"
                )
            lines.append(
                f"  transition {i}: t={t.start_s:.0f}s"
                f" parallel={t.parallel_seconds:.0f}s serial={t.serial_seconds:.0f}s"
                f" actions={dict(sorted(t.action_counts.items()))}"
                f" transparent={t.transparent}" + extra
            )
        lines.append(
            "  §6 transparency margin (worst over trace points):"
            f" {self.transparency_margin():.3f} req/s"
        )
        return "\n".join(lines)
