"""The fast algorithm: heuristic-score greedy (§5.3, Appendix A.1 / Fig. 15).

Each round picks the GPU config with the highest score

    score(config) = Σ_i (1 − c_i) · u_i

over the pair-config space (mixing ≤ 2 services).  When services are "almost
satisfied" (Fig. 15 lines 18–22) two services can no longer saturate a
device, so the algorithm additionally *packs* more services into one config:
we build a packed candidate greedily — every instance of every full
partition is assigned to the service with the highest need-weighted marginal
utility — and let it compete with the pair configs on score.

Array-native hot path: completion and the per-config score vector are
maintained *incrementally* (a chosen pair config touches ≤ 2 services, so
only the configs sharing those services are re-scored), and the packed
candidate is one vectorized scan advancing every partition in lock-step
(``ConfigSpace.packed_tables``) instead of a per-service Python loop.  Both
paths reproduce the scalar reference float-for-float — same seed, same
deployment, byte-identical downstream ``SimReport``s.

Complexity: O(#configs) numpy work per round, #rounds = #devices emitted —
the paper's O(n²m).

The port's copy of the JAX package's ``core/greedy.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import time  # contract-ok: wall-clock anytime-budget deadline only; sim time stays logical
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.deployment import (
    ConfigSpace,
    Deployment,
    GPUConfig,
    IndexedDeployment,
    InstanceAssignment,
    OptimizerProcedure,
    make_assignment,
)


class GreedyFast(OptimizerProcedure):
    def __init__(self, space: ConfigSpace, pack_threshold: float = 0.9):
        super().__init__(space)
        self.pack_threshold = pack_threshold

    # -- Fig. 15 lines 18-22: packed multi-service candidate --------------------
    def _packed_candidate(self, completion: np.ndarray) -> Optional[GPUConfig]:
        """Scalar reference implementation (kept for the property tests that
        pin the vectorized scan to it; the hot path uses ``_packed_scan``)."""
        w = self.space.workload
        req = w.required()
        need0 = np.clip(1.0 - completion, 0.0, None)
        best_cfg, best_score = None, 0.0
        for partition in self.space.rules.full_partitions():
            need = need0.copy()
            assigns: List[InstanceAssignment] = []
            score = 0.0
            for size in sorted(partition, reverse=True):
                # marginal utility of putting each service on this instance
                gains = np.zeros(w.n)
                for svc in w.services:
                    t = self.space._tput.get((svc.name, size), 0.0)
                    if t <= 0:
                        continue
                    gains[svc.index] = need[svc.index] * (t / req[svc.index])
                i = int(np.argmax(gains))
                if gains[i] <= 0.0:
                    assigns.append(InstanceAssignment(size, None))
                    continue
                svc = w.services[i]
                a = make_assignment(self.space.profile, w, size, svc.name)
                assigns.append(a)
                u = a.throughput / req[i]
                score += need[i] * u
                need[i] = max(0.0, need[i] - u)
            if score > best_score and any(a.service for a in assigns):
                best_score = score
                best_cfg = GPUConfig(partition, tuple(assigns))
        return best_cfg

    def _packed_scan(
        self, need0: np.ndarray
    ) -> Optional[Tuple[np.ndarray, int, np.ndarray]]:
        """Vectorized packed-candidate scan over all full partitions at once.

        Returns ``(utility, row, choices)`` of the winning partition — or
        ``None`` when no partition scores positive — without materializing a
        :class:`GPUConfig` (losing candidates never allocate anything).
        Bit-identical to :meth:`_packed_candidate`.
        """
        tbl = self.space.packed_tables
        if tbl.max_len == 0:
            return None
        # scratch buffers from the tables: valid until the next scan, which
        # is fine — the caller consumes the winning row within the round
        need, gains = tbl.need_buf, tbl.gains_buf
        score, util, choice = tbl.score_buf, tbl.util_buf, tbl.choice_buf
        np.copyto(need, need0[None, :])
        score.fill(0.0)
        util.fill(0.0)
        choice.fill(-1)
        for j, m in enumerate(tbl.M_step):  # m: (k, n) normalized throughputs
            k = m.shape[0]
            g_all = np.multiply(need[:k], m, out=gains[:k])
            pick = g_all.argmax(axis=1)
            rows = tbl.arange[:k]
            g = g_all[rows, pick]
            assigned = g > 0.0
            if not assigned.all():
                if not assigned.any():
                    continue
                rows, pick, g = rows[assigned], pick[assigned], g[assigned]
            uval = m[rows, pick]
            score[rows] += g
            util[rows, pick] += uval
            need[rows, pick] = np.maximum(0.0, need[rows, pick] - uval)
            choice[rows, j] = pick
        # earliest-partition winner in full_partitions() order, as the
        # scalar loop's strict `score > best_score` replacement rule keeps it
        score_orig = score[tbl.orig_to_row]
        w = int(np.argmax(score_orig))
        if score_orig[w] <= 0.0:
            return None
        row = int(tbl.orig_to_row[w])
        return util[row], row, choice[row]

    def _build_packed(self, row: int, choices: np.ndarray) -> GPUConfig:
        """Materialize the winning packed candidate from its choice row."""
        space = self.space
        tbl = space.packed_tables
        names = space.workload.names
        partition = space.partitions[int(tbl.row_to_orig[row])]
        assigns = tuple(
            space._assign[
                (names[int(choices[j])] if choices[j] >= 0 else None,
                 int(tbl.step_size[row, j]))
            ]
            for j in range(int(tbl.row_len[row]))
        )
        return GPUConfig(partition, assigns)

    def produce(self, completion: np.ndarray) -> List[GPUConfig]:
        return self._produce(completion)[0]

    def produce_indexed(self, completion: np.ndarray) -> IndexedDeployment:
        """``produce`` in the array-native representation (config order is
        forgotten; completion math stays two gathers from here on)."""
        _, counts, extras = self._produce(completion)
        return IndexedDeployment(self.space, counts, extras)

    def _produce(
        self, completion: np.ndarray
    ) -> Tuple[List[GPUConfig], np.ndarray, List[GPUConfig]]:
        space = self.space
        ia, ib, ua, ub = space.ia, space.ib, space.ua, space.ub
        c = completion.astype(np.float64).copy()
        need = np.clip(1.0 - c, 0.0, None)
        scores = need[ia] * ua + need[ib] * ub
        out: List[GPUConfig] = []
        counts = np.zeros(len(space), dtype=np.int64)
        extras: List[GPUConfig] = []
        guard = 0
        while np.any(c < 1.0 - 1e-9):
            guard += 1
            if guard > 100_000:
                raise RuntimeError("greedy failed to converge")
            idx = int(np.argmax(scores)) if len(scores) else 0
            best_score = float(scores[idx]) if len(scores) else 0.0
            # Fig. 15 lines 18-22: a packed >2-service candidate competes on
            # score every round; it wins exactly in the near-satisfied tail,
            # where two services no longer saturate a device.
            packed = self._packed_scan(need)
            chosen_packed = None
            if packed is not None:
                pu, row, choices = packed
                ps = float(np.sum(need * pu))
                if ps > best_score:
                    chosen_packed, best_score = (pu, row, choices), ps
            if best_score <= 0.0:
                raise RuntimeError(
                    "no config has positive score but SLOs unmet — "
                    "some service is infeasible on every instance size"
                )
            if chosen_packed is None:
                out.append(space.configs[idx])
                counts[idx] += 1
                i, j = int(ia[idx]), int(ib[idx])
                c[i] += ua[idx]
                c[j] += ub[idx]
                changed = (i,) if i == j else (i, j)
            else:
                pu, row, choices = chosen_packed
                cfg = self._build_packed(row, choices)
                out.append(cfg)
                extras.append(cfg)
                c += pu
                changed = tuple(int(t) for t in np.flatnonzero(pu))
            # incremental maintenance: only configs touching a changed
            # service can change score
            for i in changed:
                need[i] = max(0.0, 1.0 - c[i])
            upd = (
                space.service_configs[changed[0]]
                if len(changed) == 1
                else np.concatenate([space.service_configs[i] for i in changed])
            )
            scores[upd] = need[ia[upd]] * ua[upd] + need[ib[upd]] * ub[upd]
        return out, counts, extras


# ---------------------------------------------------------------------------
# Warm-start repair (incremental reoptimization)
# ---------------------------------------------------------------------------


def warm_repair(
    space: ConfigSpace,
    fast: OptimizerProcedure,
    incumbent: IndexedDeployment,
    edit_budget: Optional[int] = None,
    deadline: Optional[float] = None,
) -> Optional[Tuple[IndexedDeployment, int]]:
    """Repair ``incumbent`` against ``space``'s (drifted) workload.

    Instead of packing a deployment from empty, start from the incumbent's
    completion under the new required rates and edit it: an *add* phase runs
    the fast algorithm from the incumbent's completion (covering only the
    deficit), then a *trim* phase drops devices the (possibly lower) demand
    no longer needs.  One edit = one device added or removed, the same count
    :func:`repro_torch.core.ga.deployment_edit_distance` measures — the §6
    controller pays per device changed, so bounding edits bounds transition
    cost.

    Returns ``(repaired, edits)``; ``None`` when the mandatory adds alone
    exceed ``edit_budget`` (callers fall back to a cold solve).  Trims are
    the anytime part: they stop at ``edit_budget`` or ``deadline`` (a
    ``time.monotonic()`` instant), never at the cost of validity.
    Deterministic for a fixed (space, incumbent, budget): ties break toward
    the lowest config index, enumerated configs before extras.
    """
    counts = incumbent.counts.copy()
    extras = list(incumbent.extras)
    c = space.completion_of_counts(counts)
    for cfg in extras:
        c = c + space.utility_cached(cfg)
    edits = 0
    # -- add phase (mandatory): cover the deficit left by upward drift ------
    if bool(np.any(c < 1.0 - 1e-9)):
        added = fast.produce(c.copy())
        edits += len(added)
        if edit_budget is not None and edits > edit_budget:
            return None
        for cfg in added:
            i = space.index_of(cfg)
            if i >= 0:
                counts[i] += 1
                c = c + space.utility_of(i)
            else:
                extras.append(cfg)
                c = c + space.utility_cached(cfg)
    # -- trim phase (anytime): shed devices over-provisioned by downward
    # drift, largest normalized utility first; every intermediate state is a
    # valid deployment, so stopping early is always safe
    ia, ib, ua, ub = space.ia, space.ib, space.ua, space.ub
    while edit_budget is None or edits < edit_budget:
        # wall clock only under a deadline; without one the trims, and so
        # the repaired deployment, depend on the inputs alone
        if deadline is not None and time.monotonic() >= deadline:
            break
        gi, g_best = -1, 0.0
        if len(counts):
            removable = (counts > 0) & (c[ia] - ua >= 1.0) & (c[ib] - ub >= 1.0)
            if bool(removable.any()):
                gain = np.where(removable, ua + ub, -1.0)
                gi = int(np.argmax(gain))
                g_best = float(gain[gi])
        ei, e_best = -1, 0.0
        for k, cfg in enumerate(extras):
            u = space.utility_cached(cfg)
            if bool(np.all(c - u >= 1.0)):
                s = float(u.sum())
                if s > e_best:
                    ei, e_best = k, s
        if gi < 0 and ei < 0:
            break
        if gi >= 0 and g_best >= e_best:
            counts[gi] -= 1
            c = c - space.utility_of(gi)
        else:
            c = c - space.utility_cached(extras.pop(ei))
        edits += 1
    return IndexedDeployment(space, counts, extras), edits
