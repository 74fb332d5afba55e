"""Seeded fault injection: device failures, drains, botched actions.

Placement-under-failure work (arXiv:2502.01909 — multi-objective MIG VM
placement across cloud fault domains; arXiv:2508.18556 — MIG instance
management for high throughput) treats failures as a first-class scheduling
input.  This module makes them a first-class *scenario axis*: a
:class:`FaultProfile` declares what can go wrong, and a
:class:`FaultInjector` draws every occurrence from a seed, so the same
``SimConfig.seed`` + the same profile yields a byte-identical run.

Two injection surfaces:

  * **device faults** — whole-GPU failures and node drains, scheduled as
    simulator events at seeded times inside a window of the trace;
  * **action faults** — hooks on :meth:`SimulatedCluster.apply`: a MIG
    repartition attempt errors with some probability (the reconciler
    retries under exponential backoff), and any action can straggle at a
    latency multiplier (charged to the transition makespan).

Register new profiles with :func:`register_fault_profile`; the JAX
package's scenario matrix (``sim/scenarios.py``) exposes the registry as
its fifth axis.

The port's copy of the JAX package's ``controlplane/faults.py``, op for op:
the same ``(seed, crc32(profile name))`` stream drawn in the same order, so
schedules, picks and action verdicts equal the reference's.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import ACTION_SECONDS, Action, ActionFault


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """A declarative bundle of failure modes (all seeded, all optional)."""

    name: str
    # whole-GPU failures: how many, uniformly drawn inside the window
    # (fractions of the trace duration)
    gpu_failures: int = 0
    failure_window: Tuple[float, float] = (0.3, 0.6)
    # node drains (cordon a whole machine; instances migrate off)
    node_drains: int = 0
    drain_window: Tuple[float, float] = (0.3, 0.6)
    # serving-path faults: an instance's *process* dies mid-decode — the
    # device stays healthy (no repair transition), but every in-flight
    # request on it loses its KV cache and spills for retry.  Only the
    # token serving model can represent this; under the fluid model the
    # instance's backlog re-spills to the service level instead.
    instance_crashes: int = 0
    crash_window: Tuple[float, float] = (0.25, 0.7)
    # MIG repartition attempts error with this probability; the reconciler
    # retries under exponential backoff.  Creates carve a MIG slice — the
    # same GI/CI reconfiguration — so they get their own error knob.
    repartition_error_prob: float = 0.0
    create_error_prob: float = 0.0
    backoff_base_s: float = 5.0
    backoff_mult: float = 2.0
    # stragglers: any action runs at straggler_mult x its Fig.-13c latency
    # with probability straggler_prob
    straggler_prob: float = 0.0
    straggler_mult: float = 1.0
    # how long until the control plane notices a device fault and reacts
    detection_delay_s: float = 30.0
    # bounded executor concurrency during reconcile (None = unbounded,
    # matching the direct-transition makespan model)
    max_inflight: Optional[int] = None
    # reconcile attempts before the control plane gives up on a pass
    max_iterations: int = 8

    @property
    def injects_actions(self) -> bool:
        return (
            self.repartition_error_prob > 0.0
            or self.create_error_prob > 0.0
            or self.straggler_prob > 0.0
        )

    @property
    def injects_devices(self) -> bool:
        return (
            self.gpu_failures > 0
            or self.node_drains > 0
            or self.instance_crashes > 0
        )


FAULT_PROFILES: Dict[str, FaultProfile] = {}


def register_fault_profile(profile: FaultProfile) -> FaultProfile:
    # a real exception, not an assert: registration clashes must surface
    # even under ``python -O``, where asserts are compiled away
    if profile.name in FAULT_PROFILES:
        raise ValueError(f"fault profile {profile.name!r} already registered")
    FAULT_PROFILES[profile.name] = profile
    return profile


register_fault_profile(FaultProfile("none"))
register_fault_profile(FaultProfile("gpu_loss", gpu_failures=1))
register_fault_profile(
    FaultProfile("drain", node_drains=1, drain_window=(0.35, 0.55))
)
register_fault_profile(
    FaultProfile(
        "flaky_mig",
        repartition_error_prob=0.35,
        create_error_prob=0.08,
        max_inflight=8,
    )
)
register_fault_profile(
    FaultProfile(
        "stragglers", straggler_prob=0.3, straggler_mult=4.0, max_inflight=8
    )
)
register_fault_profile(
    FaultProfile("instance_crash", instance_crashes=2)
)
register_fault_profile(
    FaultProfile(
        "chaos",
        gpu_failures=2,
        failure_window=(0.25, 0.7),
        repartition_error_prob=0.2,
        create_error_prob=0.05,
        straggler_prob=0.15,
        straggler_mult=3.0,
        max_inflight=8,
    )
)


def _stable_u32(name: str) -> int:
    """A numpy-seedable stable hash (Python's hash() is salted per process)."""
    return zlib.crc32(name.encode("utf-8")) & 0xFFFFFFFF


@dataclasses.dataclass
class DeviceFault:
    """One scheduled device-level fault (target picked at fire time)."""

    time_s: float
    kind: str  # "gpu_failure" | "node_drain" | "instance_crash"


class FaultInjector:
    """Draws every fault occurrence from ``(seed, profile name)``.

    One injector lives for one simulation run.  Its RNG is consumed in a
    deterministic order — device-fault times at construction, then targets
    and action verdicts in event order — so same seed => same faults.
    """

    def __init__(self, profile: FaultProfile, seed: int, duration_s: float):
        self.profile = profile
        self.rng = np.random.default_rng((int(seed), _stable_u32(profile.name)))
        self.duration_s = float(duration_s)
        self.action_log: List[Dict] = []  # injected action faults/stragglers
        self._schedule = self._draw_schedule()

    def _draw_schedule(self) -> List[DeviceFault]:
        p = self.profile
        faults: List[DeviceFault] = []
        lo, hi = p.failure_window
        for _ in range(p.gpu_failures):
            t = float(self.rng.uniform(lo, hi)) * self.duration_s
            faults.append(DeviceFault(t, "gpu_failure"))
        lo, hi = p.drain_window
        for _ in range(p.node_drains):
            t = float(self.rng.uniform(lo, hi)) * self.duration_s
            faults.append(DeviceFault(t, "node_drain"))
        # crash draws come AFTER the historical ones: pre-existing profiles
        # consume the rng in the same order, so their schedules stay
        # byte-identical to the reference's; reordering these loops changes
        # every schedule with more than one kind of fault
        lo, hi = p.crash_window
        for _ in range(p.instance_crashes):
            t = float(self.rng.uniform(lo, hi)) * self.duration_s
            faults.append(DeviceFault(t, "instance_crash"))
        faults.sort(key=lambda f: f.time_s)
        return faults

    def device_faults(self) -> List[DeviceFault]:
        """The run's scheduled device faults, ascending in time."""
        return list(self._schedule)

    # -- fire-time target selection (deterministic: sorted candidates + rng) --
    def pick_gpu(self, busy_gids: List[int]) -> Optional[int]:
        cands = sorted(busy_gids)
        if not cands:
            return None
        return cands[int(self.rng.integers(len(cands)))]

    def pick_machine(self, machines: List[int]) -> Optional[int]:
        cands = sorted(machines)
        if not cands:
            return None
        return cands[int(self.rng.integers(len(cands)))]

    def pick_instance(self, busy_uids: List[int]) -> Optional[int]:
        cands = sorted(busy_uids)
        if not cands:
            return None
        return cands[int(self.rng.integers(len(cands)))]

    # -- the SimulatedCluster.apply hook --------------------------------------
    def action_hook(self, action: Action) -> float:
        """Latency multiplier for this action; raises :class:`ActionFault`
        when the attempt is vetoed (state untouched, wall clock wasted)."""
        p = self.profile
        if (
            action.kind == "repartition"
            and p.repartition_error_prob > 0.0
            and float(self.rng.random()) < p.repartition_error_prob
        ):
            self.action_log.append(
                {"kind": "repartition_error", "gpu": action.gpu}
            )
            raise ActionFault(
                action,
                "MIG repartition error",
                wasted_s=ACTION_SECONDS["repartition"],
            )
        if (
            action.kind == "create"
            and p.create_error_prob > 0.0
            and float(self.rng.random()) < p.create_error_prob
        ):
            self.action_log.append({"kind": "create_error", "gpu": action.gpu})
            raise ActionFault(
                action,
                "MIG slice-carve error on create",
                wasted_s=ACTION_SECONDS["create"],
            )
        if p.straggler_prob > 0.0 and float(self.rng.random()) < p.straggler_prob:
            self.action_log.append(
                {
                    "kind": "straggler",
                    "action": action.kind,
                    "gpu": action.gpu,
                    "mult": p.straggler_mult,
                }
            )
            return p.straggler_mult
        return 1.0

    def backoff_s(self, attempt: int) -> float:
        """Exponential backoff before re-planning after a failed attempt
        (attempt counts from 1)."""
        p = self.profile
        return p.backoff_base_s * p.backoff_mult ** max(attempt - 1, 0)
