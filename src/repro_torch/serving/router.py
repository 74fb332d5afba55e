"""Service router: load-balances one service's requests over its instances.

MIG-Serving "relies on load balancing systems to dispatch user requests
accordingly" (§7) when a service runs with different batch sizes on
different-sized instances — this module is that system: weighted round-robin
proportional to each instance's profiled throughput.

The port's copy of the JAX package's ``serving/router.py``, op for op: plain
Python, and its pick sequences equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class InstanceHandle:
    instance_id: int
    size: int
    throughput: float  # profiled req/s (the router weight)
    dispatched: int = 0


class WeightedRouter:
    """Deterministic smooth weighted round-robin.

    The weight total is computed once at construction (throughputs are fixed
    for a router's lifetime — the simulator rebuilds the router when the
    instance set changes), not on every pick.  When the weights carry no
    signal — all zero (freshly profiled, unmeasured instances) or any
    non-finite entry — smooth WRR would degenerate to always-instance-0, so
    the router falls back to plain round-robin until it is rebuilt with real
    throughputs."""

    def __init__(self, instances: Sequence[InstanceHandle]):
        if not instances:
            raise ValueError("router needs at least one instance")
        self.instances = list(instances)
        self._current = [0.0] * len(self.instances)
        total = sum(i.throughput for i in self.instances)
        finite = all(
            t >= 0.0 and t == t and t != float("inf")
            for t in (i.throughput for i in self.instances)
        )
        self._total = total if finite and total > 0.0 else None
        self._rr = 0  # round-robin cursor for the degenerate fallback

    def pick(self) -> InstanceHandle:
        if self._total is None:  # no usable weights: plain round-robin
            inst = self.instances[self._rr]
            self._rr = (self._rr + 1) % len(self.instances)
            inst.dispatched += 1
            return inst
        best_i = 0
        for idx, inst in enumerate(self.instances):
            self._current[idx] += inst.throughput
            if self._current[idx] > self._current[best_i]:
                best_i = idx
        self._current[best_i] -= self._total
        inst = self.instances[best_i]
        inst.dispatched += 1
        return inst

    def dispatch_counts(self) -> Dict[int, int]:
        return {i.instance_id: i.dispatched for i in self.instances}
