"""The Reconfigurable Machine Scheduling Problem (RMS) — abstract definitions.

The paper (§3) defines RMS as ``(R_m | reconf | *)``: unrelated parallel
machines that can be *partially* reconfigured under problem-specific
``rule_reconf``.  This module holds the problem-agnostic pieces:

  * :class:`Instance` — a machine (a GPU instance / a group of cards) of a given size.
  * :class:`ReconfigRules` — the ``rule_reconf`` interface: which partitions of
    one reconfigurable device are legal, and which reconfiguration operations
    are permitted.
  * :class:`Service` / :class:`SLO` — jobs.  Serving jobs are long-running
    (§3.3), which spares job-timing decisions.

Concrete rule-sets live in :mod:`repro_torch.core.mig` (the literal A100 rules used
for the paper-faithful reproduction) and :mod:`repro_torch.core.h100_slice` (the
H100's MIG instances and the groups of cards of an 8-card node).

The port's copy of the JAX package's ``core/rms.py``, unchanged in
behaviour: these modules are host numpy/stdlib code in both packages.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Sequence, Tuple

Partition = Tuple[int, ...]  # sorted multiset of instance sizes on one device


@dataclasses.dataclass(frozen=True)
class Instance:
    """One machine: an instance of ``size`` resource slices on device ``device_id``.

    ``uid`` disambiguates equal-sized instances on the same device.
    """

    size: int
    device_id: int = -1
    uid: int = -1


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objective: required aggregate throughput (req/s) and a
    per-request latency bound (ms) that every serving instance must meet."""

    throughput: float
    latency_ms: float


@dataclasses.dataclass(frozen=True)
class Service:
    """A long-running DNN serving job."""

    name: str
    slo: SLO
    index: int = -1  # position in the optimizer's service vector


class ReconfigRules(abc.ABC):
    """``rule_reconf`` (§3.1): the legality oracle for device partitions.

    A *partition* is the multiset of instance sizes living on one
    reconfigurable device (one A100 or H100 / one 8-card node).  A
    reconfiguration op replaces a sub-multiset ``mset`` of a device's
    partition with ``mset'``; it is legal iff both the old and the new
    partition are legal (§3.3).
    """

    # -- sizes ---------------------------------------------------------------
    @property
    @abc.abstractmethod
    def device_size(self) -> int:
        """Total resource slices on one device (7 for A100 and H100, 56 for a node)."""

    @property
    @abc.abstractmethod
    def instance_sizes(self) -> Sequence[int]:
        """Allocatable instance sizes, ascending (A100: 1,2,3,4,7)."""

    # -- legality ------------------------------------------------------------
    @abc.abstractmethod
    def is_legal_partition(self, partition: Partition) -> bool:
        """True iff this multiset of instance sizes can coexist on one device."""

    @abc.abstractmethod
    def legal_partitions(self) -> List[Partition]:
        """All legal partitions (including non-full ones), sorted multisets."""

    def full_partitions(self) -> List[Partition]:
        """Legal partitions to which no further instance can be added."""
        legal = set(self.legal_partitions())
        full = []
        for p in legal:
            extendable = any(
                tuple(sorted(p + (s,))) in legal for s in self.instance_sizes
            )
            if not extendable:
                full.append(p)
        return sorted(full)

    # -- rule_reconf (§3.3) ---------------------------------------------------
    def rule_reconf(
        self, mset: Sequence[int], mset_new: Sequence[int], partition: Partition
    ) -> bool:
        """Is replacing sub-multiset ``mset`` by ``mset_new`` legal on a device
        currently holding ``partition``?  Implements the paper's definition:
        both the current and the resulting partition must be legal, and the
        removed instances must actually be present."""
        cur = list(partition)
        for s in mset:
            if s not in cur:
                return False
            cur.remove(s)
        new_partition = tuple(sorted(cur + list(mset_new)))
        return self.is_legal_partition(partition) and self.is_legal_partition(
            new_partition
        )

    # -- helpers ---------------------------------------------------------------
    def max_instances(self) -> int:
        return max(len(p) for p in self.legal_partitions())

    def partition_slack(self, partition: Partition) -> int:
        return self.device_size - sum(partition)


def validate_partition_universe(rules: ReconfigRules) -> None:
    """Sanity checks shared by all rule-sets (used by tests and by new
    rule-set authors).  Raises :class:`ValueError` naming the offending
    partition — typed exceptions, not asserts, so the checks survive
    ``python -O`` (contract: no-bare-assert)."""
    legal = rules.legal_partitions()
    if not legal:
        raise ValueError(f"{type(rules).__name__}: no legal partitions")
    for p in legal:
        if p != tuple(sorted(p)):
            raise ValueError(f"partition not sorted: {p}")
        if sum(p) > rules.device_size:
            raise ValueError(
                f"oversubscribed partition {p}: sums to {sum(p)} on a "
                f"size-{rules.device_size} device"
            )
        if not all(s in rules.instance_sizes for s in p):
            raise ValueError(
                f"partition {p} uses a size outside "
                f"{tuple(rules.instance_sizes)}"
            )
        if not rules.is_legal_partition(p):
            raise ValueError(
                f"legal_partitions() returned {p} but is_legal_partition "
                "rejects it — the rule-set's oracles disagree"
            )
