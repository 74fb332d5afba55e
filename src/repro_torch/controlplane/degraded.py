"""Degraded-mode serving: admission control when capacity < demand.

After a device failure the cluster may simply not have the capacity the
SLOs require until the reconciler restores it (creates pay their 62 s
Figure-13c latency).  Queueing everything during that window would let the
backlog grow without bound and then report a rosy served-fraction once
capacity returns; production systems shed instead.  The
:class:`AdmissionController` admits load up to current capacity and sheds
the excess, and the shed requests are charged honestly to the
:class:`~repro_torch.sim.report.SimReport` — they count as arrivals that were
never served, so SLO attainment and served-fraction reflect the outage.

Shedding is proportional: every service sheds the same *fraction* of its
over-capacity excess (here applied per service, whose capacity is its own
instance pool, so "proportional" degenerates to per-service clipping).
Only active while the cluster is in an outage the control plane can see —
observed state diverged from the desired state, or a fault-triggered
repair is still paying its Figure-13c latencies — AND the service's
capacity sits below its required rate.  Ordinary traffic bursts, before
or after an outage, keep the fluid-queue backlog semantics.

The port's copy of the JAX package's ``controlplane/degraded.py``, op for
op, its float arithmetic included (see :meth:`AdmissionController.admit_by_class`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class AdmissionController:
    """Clip per-service admitted load to capacity while degraded.

    ``min_admit_frac`` guarantees a floor (even a shedding frontend lets
    some traffic through to keep health signals alive)."""

    min_admit_frac: float = 0.0

    def admit(self, demand: float, capacity: float) -> Tuple[float, float]:
        """Split ``demand`` (requests this bin) into (admitted, shed) given
        ``capacity`` (requests the service's instances can absorb)."""
        if demand <= 0.0:
            return 0.0, 0.0
        if capacity >= demand:
            return demand, 0.0
        admitted = max(capacity, demand * self.min_admit_frac)
        return admitted, demand - admitted

    def admit_by_class(
        self,
        demands: Sequence[Tuple[int, float, float]],
        capacity: float,
    ) -> List[Tuple[float, float]]:
        """Priority-aware shedding: split each ``(priority_class, weight,
        demand)`` entry into ``(admitted, shed)`` under a shared capacity.

        Classes are served in priority order (class index 0 first): a class
        is shed only after every higher class is fully admitted, so the
        excess lands lowest-class-first.  The one *marginal* class that the
        remaining capacity only partially covers splits it across its
        entries by weighted max-min fairness (water-filling: each entry's
        share grows in proportion to its weight until its demand is met,
        surplus re-flows to the still-hungry), never by who asked loudest.
        ``min_admit_frac`` keeps its per-entry floor.  Deterministic, order
        preserving: the result aligns with the input sequence.

        ``shed`` is computed as ``d - admitted``, so ``admitted + shed``
        equals ``d`` only up to float rounding (the reference's own exact
        property test fails on some inputs for this reason).  The port
        keeps the reference's arithmetic bit for bit: the simulator's
        report bytes depend on it."""
        out: List[Tuple[float, float]] = [(0.0, 0.0)] * len(demands)
        remaining = max(float(capacity), 0.0)
        for cls in sorted({c for c, _, _ in demands}):
            idx = [
                i
                for i, (c, _, d) in enumerate(demands)
                if c == cls and d > 0.0
            ]
            total = sum(demands[i][2] for i in idx)
            if total <= remaining:
                for i in idx:
                    out[i] = (demands[i][2], 0.0)
                remaining -= total
                continue
            # marginal class: weighted water-filling of what's left
            alloc = {i: 0.0 for i in idx}
            budget = remaining
            hungry = list(idx)
            while budget > 1e-12 and hungry:
                wsum = sum(max(demands[i][1], 0.0) for i in hungry)
                if wsum <= 0.0:
                    # all-zero weights degenerate to equal split
                    share = {i: budget / len(hungry) for i in hungry}
                else:
                    share = {
                        i: budget * max(demands[i][1], 0.0) / wsum
                        for i in hungry
                    }
                budget = 0.0
                nxt = []
                for i in hungry:
                    room = demands[i][2] - alloc[i]
                    take = min(share[i], room)
                    alloc[i] += take
                    budget += share[i] - take
                    if alloc[i] < demands[i][2] - 1e-12:
                        nxt.append(i)
                if len(nxt) == len(hungry) and budget <= 1e-12:
                    break
                hungry = nxt
            for i in idx:
                d = demands[i][2]
                admitted = min(
                    max(alloc[i], d * self.min_admit_frac), d
                )
                out[i] = (admitted, d - admitted)
            remaining = 0.0
        return out
