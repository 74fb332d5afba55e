"""Declarative control-plane state: inventory, desired state, observed state.

The paper deploys MIG-serving as a Kubernetes controller (§6-§7) that
continuously drives the cluster from *observed* state toward the
optimizer's *target* state.  This module is that controller's vocabulary:

  * :class:`ClusterSpec` — the per-node inventory (machines, device counts,
    fault domains), the static shape failures are drawn against;
  * :class:`DesiredState` — the optimizer's target: a :class:`Deployment`
    (optionally its array-native :class:`IndexedDeployment` twin) plus the
    per-service required throughput it was sized for;
  * :class:`ObservedState` — a point-in-time snapshot of the simulated
    cluster (instances, partitions, failed/draining devices);
  * :func:`diff` — the level-trigger: what the reconciler compares each
    pass to decide whether the cluster has converged.

Everything here is numpy-only and deterministic, like the rest of
``repro_torch.controlplane``.  The port's copy of the JAX package's
``controlplane/spec.py``, op for op.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Optional, Tuple

from repro_torch.core.cluster import GPUS_PER_MACHINE, SimulatedCluster
from repro_torch.core.deployment import Deployment, IndexedDeployment
from repro_torch.core.rms import Partition


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One machine of the inventory: its devices and its fault domain."""

    machine: int
    n_gpus: int = GPUS_PER_MACHINE
    fault_domain: str = "rack0"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Per-node fault-domain inventory (the static half of the spec)."""

    nodes: Tuple[NodeSpec, ...]

    @staticmethod
    def from_cluster(
        cluster: SimulatedCluster, domain_of: Optional[Dict[int, str]] = None
    ) -> "ClusterSpec":
        """Derive the inventory from a live cluster; machines default to one
        fault domain per rack (``rack<machine>``) unless mapped explicitly."""
        machines: Dict[int, int] = {}
        for g in cluster.gpus.values():
            machines[g.machine] = machines.get(g.machine, 0) + 1
        domain_of = domain_of or {}
        return ClusterSpec(
            tuple(
                NodeSpec(m, n, domain_of.get(m, f"rack{m}"))
                for m, n in sorted(machines.items())
            )
        )

    @property
    def machines(self) -> Tuple[int, ...]:
        return tuple(n.machine for n in self.nodes)

    def fault_domain_of(self, machine: int) -> str:
        for n in self.nodes:
            if n.machine == machine:
                return n.fault_domain
        return f"rack{machine}"


@dataclasses.dataclass
class DesiredState:
    """The optimizer's target the reconciler drives the cluster toward."""

    deployment: Deployment  # config order matters to the §6 controller
    required: Dict[str, float]  # per-service SLO throughput it was sized for
    indexed: Optional[IndexedDeployment] = None  # array-native twin
    cluster_spec: Optional[ClusterSpec] = None

    def content(self) -> Counter:
        """Target instance multiset {(size, service): count}."""
        return Counter(
            (a.size, a.service)
            for cfg in self.deployment.configs
            for a in cfg.assignments
            if a.service
        )

    @property
    def num_gpus(self) -> int:
        return self.deployment.num_gpus


@dataclasses.dataclass
class ObservedState:
    """A point-in-time snapshot of the cluster (what a metrics backend and
    the k8s API would report)."""

    time_s: float
    instances: Dict[int, Tuple[str, int, float]]  # uid -> (svc, size, req/s)
    partitions: Dict[int, Partition]  # gpu id -> current partition
    instance_gpu: Dict[int, int]  # uid -> gpu id
    failed: frozenset  # gpu ids lost to whole-device failures
    draining: frozenset  # gpu ids being drained

    @staticmethod
    def observe(cluster: SimulatedCluster, now: float = 0.0) -> "ObservedState":
        instances: Dict[int, Tuple[str, int, float]] = {}
        instance_gpu: Dict[int, int] = {}
        partitions: Dict[int, Partition] = {}
        for gid, g in cluster.gpus.items():
            partitions[gid] = g.partition()
            for r in g.instances.values():
                if r.service:
                    instances[r.uid] = (r.service, r.size, r.throughput)
                    instance_gpu[r.uid] = gid
        return ObservedState(
            time_s=now,
            instances=instances,
            partitions=partitions,
            instance_gpu=instance_gpu,
            failed=frozenset(cluster.failed),
            draining=frozenset(cluster.draining),
        )

    def content(self) -> Counter:
        """Observed instance multiset {(size, service): count}."""
        return Counter((size, svc) for svc, size, _ in self.instances.values())

    def provided(self) -> Dict[str, float]:
        """Per-service aggregate throughput currently serving."""
        out: Dict[str, float] = {}
        for svc, _size, tput in self.instances.values():
            out[svc] = out.get(svc, 0.0) + tput
        return out

    def misplaced_uids(self) -> Tuple[int, ...]:
        """Instances stranded on draining devices (they serve, but the
        level-trigger must keep firing until they are migrated off)."""
        return tuple(
            sorted(
                uid for uid, gid in self.instance_gpu.items()
                if gid in self.draining
            )
        )


@dataclasses.dataclass
class StateDiff:
    """Observed-vs-desired divergence — the reconciler's level trigger."""

    missing: Counter  # (size, svc) -> count the cluster lacks
    surplus: Counter  # (size, svc) -> count beyond the target
    misplaced: Tuple[int, ...]  # uids stranded on draining devices
    shortfall: Dict[str, float]  # svc -> required - provided (when > 0)

    @property
    def converged(self) -> bool:
        return not self.missing and not self.surplus and not self.misplaced

    def summary(self) -> str:
        if self.converged:
            return "converged"
        bits = []
        if self.missing:
            bits.append(f"missing={dict(sorted(self.missing.items()))}")
        if self.surplus:
            bits.append(f"surplus={dict(sorted(self.surplus.items()))}")
        if self.misplaced:
            bits.append(f"misplaced={len(self.misplaced)}")
        return " ".join(bits)


def diff(observed: ObservedState, desired: DesiredState) -> StateDiff:
    """What separates the observed cluster from the desired state."""
    want = desired.content()
    have = observed.content()
    provided = observed.provided()
    shortfall = {
        svc: req - provided.get(svc, 0.0)
        for svc, req in sorted(desired.required.items())
        if req - provided.get(svc, 0.0) > 1e-9
    }
    return StateDiff(
        missing=want - have,
        surplus=have - want,
        misplaced=observed.misplaced_uids(),
        shortfall=shortfall,
    )
