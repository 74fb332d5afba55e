"""Exact search and tighter lower bounds for small RMS instances
(beyond-paper).

Two tools:

* :func:`per_service_lower_bound` — a *universal* bound: no device config can
  cover more of service s than a whole device dedicated to s (single-service
  configs are in the pair space), so ceil(max_s need_s / best_s) devices are
  required by ANY deployment.  Combined with the paper's LP-style sum bound
  this tightens the optimality gap.

* :class:`PairSpaceExact` — complete depth-first branch-and-bound over the
  ≤2-services-per-device config space (the space the paper's fast/slow
  algorithms search).  Utility-duplicate configs are collapsed and paths are
  enumerated as multisets (non-increasing candidate index), with the
  admissible per-service bound for pruning.  Note: the GA's packed configs
  mix >2 services, so the two-phase optimizer can legitimately beat the
  pair-space optimum — measuring exactly that effect is the point
  (see benchmarks/optimality_gap.py).

The port's copy of the JAX package's ``core/exact.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.deployment import ConfigSpace, Deployment, GPUConfig


def _best_per_service(space: ConfigSpace) -> np.ndarray:
    best = np.zeros(space.workload.n)
    for i in range(len(space)):
        best = np.maximum(best, space.utility_of(i))
    return best


def per_service_lower_bound(space: ConfigSpace) -> int:
    """Universal: ceil(max_s 1/best_coverage_s) devices needed."""
    best = _best_per_service(space)
    if np.any(best <= 0):
        raise ValueError("some service is uncoverable")
    return int(math.ceil(float(np.max(1.0 / best)) - 1e-9))


class PairSpaceExact:
    def __init__(self, space: ConfigSpace, node_limit: int = 2_000_000):
        self.space = space
        self.node_limit = node_limit
        self.best_per_device = _best_per_service(space)
        self.nodes = 0
        # collapse configs with identical utility signatures
        sig_seen = {}
        self.cand: List[int] = []
        for i in range(len(space)):
            sig = (
                int(space.ia[i]), int(space.ib[i]),
                round(float(space.ua[i]), 12), round(float(space.ub[i]), 12),
            )
            if sig not in sig_seen:
                sig_seen[sig] = i
                self.cand.append(i)
        # strongest first so good incumbents arrive early
        scores = space.score_all(np.zeros(space.workload.n))
        self.cand.sort(key=lambda i: -scores[i])

    def _bound(self, completion: np.ndarray) -> int:
        need = np.clip(1.0 - completion, 0.0, None)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(self.best_per_device > 0, need / self.best_per_device, np.inf)
        worst = float(np.max(per)) if per.size else 0.0
        if not math.isfinite(worst):
            return 10**9
        return int(math.ceil(worst - 1e-9))

    def solve(self, ub_deployment: Deployment) -> Tuple[Deployment, bool]:
        """Returns (best pair-space deployment found, completed) — when
        ``completed`` the result is the pair-space optimum."""
        space = self.space
        incumbent = list(ub_deployment.configs)
        best_len = len(incumbent)
        completed = True

        def dfs(completion: np.ndarray, path: List[int], start: int) -> None:
            nonlocal incumbent, best_len, completed
            self.nodes += 1
            if self.nodes > self.node_limit:
                completed = False
                return
            if not np.any(completion < 1.0 - 1e-9):
                if len(path) < best_len:
                    best_len = len(path)
                    incumbent = [space.configs[i] for i in path]
                return
            if len(path) + self._bound(completion) >= best_len:
                return
            need = np.clip(1.0 - completion, 0.0, None)
            # multiset enumeration: only candidates at index >= start
            for pos in range(start, len(self.cand)):
                idx = self.cand[pos]
                u = space.utility_of(idx)
                if float(np.sum(need * u)) <= 0.0:
                    continue  # config helps nothing that is still needed
                dfs(completion + u, path + [idx], pos)

        dfs(np.zeros(space.workload.n), [], 0)
        return Deployment(incumbent), completed
