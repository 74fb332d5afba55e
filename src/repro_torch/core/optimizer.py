"""The two-phase optimizer pipeline (§5.2, Figure 6) and algorithm registry.

Phase 1 runs the *fast algorithm* (greedy) to get a valid deployment quickly;
phase 2 runs the tailored GA whose crossover refills with the *slow
algorithm* (MCTS).  Both template algorithms are ``OptimizerProcedure``
subclasses and can be swapped (§7: "MIG-SERVING is designed to be able to
switch algorithms easily") — the registry also exposes the beyond-paper
``beam`` fast algorithm.

The port's copy of the JAX package's ``core/optimizer.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import time  # contract-ok: wall-clock anytime-budget deadline only; sim time stays logical
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.deployment import (
    ConfigSpace,
    Deployment,
    GPUConfig,
    IndexedDeployment,
    OptimizerProcedure,
)
from repro_torch.core.ga import GAResult, GeneticOptimizer
from repro_torch.core.greedy import GreedyFast, warm_repair
from repro_torch.core.mcts import MCTSSlow
from repro_torch.core.profiles import PerfProfile
from repro_torch.core.rms import ReconfigRules
from repro_torch.core.deployment import Workload
from repro_torch.core.zoo import EnergyAwareRepartitioner, FragAwarePacker


class BeamGreedy(OptimizerProcedure):
    """Beyond-paper fast algorithm: beam search of width B over the same
    heuristic score.  B=1 degenerates to the paper's greedy; B>1 keeps the
    B best partial deployments per round and returns the shortest finisher."""

    def __init__(self, space: ConfigSpace, beam: int = 4, branch: int = 4):
        super().__init__(space)
        self.beam = beam
        self.branch = branch

    def produce(self, completion: np.ndarray) -> List[GPUConfig]:
        space = self.space
        # state: (neg potential, completion, config-idx list)
        beams = [(completion.astype(np.float64).copy(), [])]
        done: Optional[List[int]] = None
        for _ in range(100_000):
            nxt = []
            for c, path in beams:
                if not np.any(c < 1.0 - 1e-9):
                    if done is None or len(path) < len(done):
                        done = path
                    continue
                if done is not None and len(path) + 1 >= len(done):
                    continue  # cannot beat the incumbent
                scores = space.score_all(c)
                # the default (quicksort, not stable) kind on the negated
                # float64 scores, as the reference calls it: another kind or
                # an ascending sort reversed reorders ties
                order = np.argsort(-scores)[: self.branch]
                for idx in order:
                    if scores[idx] <= 0.0:
                        continue
                    nxt.append((c + space.utility_of(int(idx)), path + [int(idx)]))
            if not nxt:
                break
            # keep the B states with the least residual need
            nxt.sort(key=lambda s: float(np.sum(np.clip(1.0 - s[0], 0.0, None))))
            beams = nxt[: self.beam]
        if done is None:
            # all beams pruned (incumbent-bound) before finishing — fall back
            return GreedyFast(space).produce(completion)
        return [space.configs[i] for i in done]


FAST_ALGORITHMS: Dict[str, Callable[[ConfigSpace], OptimizerProcedure]] = {
    "greedy": lambda s: GreedyFast(s),
    "beam": lambda s: BeamGreedy(s),
    # the scheduler zoo (repro_torch.core.zoo): competing policies from the
    # retrieved MIG-scheduling literature, benchmarked by the same closed loop
    "frag": lambda s: FragAwarePacker(s),
    "energy": lambda s: EnergyAwareRepartitioner(s),
}

SLOW_ALGORITHMS: Dict[str, Callable[[ConfigSpace], OptimizerProcedure]] = {
    "mcts": lambda s: MCTSSlow(s),
    "greedy": lambda s: GreedyFast(s),
    "frag": lambda s: FragAwarePacker(s),
    "energy": lambda s: EnergyAwareRepartitioner(s),
}


@dataclasses.dataclass
class OptimizeReport:
    fast_deployment: Deployment
    best_deployment: Deployment
    ga_history: List[int]
    fast_seconds: float
    total_seconds: float
    # warm-start telemetry: ``warm`` is True when phase 1 repaired the
    # incumbent instead of solving cold; ``warm_edits`` counts devices
    # added + removed against it; ``warm_fallback`` names why the warm path
    # bailed to a cold solve ("divergence" | "edit_budget"), None otherwise
    warm: bool = False
    warm_edits: Optional[int] = None
    warm_fallback: Optional[str] = None

    def best_indexed(self, space: ConfigSpace) -> IndexedDeployment:
        """The winning deployment in the array-native representation."""
        return IndexedDeployment.from_deployment(space, self.best_deployment)


class TwoPhaseOptimizer:
    def __init__(
        self,
        rules: ReconfigRules,
        profile: PerfProfile,
        workload: Workload,
        fast: str = "greedy",
        slow: str = "mcts",
        ga_rounds: int = 10,
        ga_population: int = 6,
        mcts_iterations: int = 200,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
        space: Optional[ConfigSpace] = None,
        incumbent: Optional[IndexedDeployment] = None,
        incumbent_workload: Optional[Workload] = None,
        warm_divergence: float = 0.5,
        warm_edit_frac: float = 0.5,
    ):
        # enumeration dominates setup cost — callers that already hold the
        # ConfigSpace for this exact problem can pass it in
        if space is not None:
            if (
                space.workload != workload
                or space.rules is not rules
                or space.profile is not profile
            ):
                raise ValueError(
                    "space was built for different rules/profile/workload"
                )
            self.space = space
        else:
            self.space = ConfigSpace(rules, profile, workload)
        # Warm start (incremental reoptimization): phase 1 repairs the
        # incumbent against the new workload instead of packing from empty.
        # ``incumbent_workload`` (what the incumbent was sized for) gates the
        # cold-solve fallback on required-rate divergence; without it the
        # caller has already decided the incumbent is usable.
        if incumbent is not None and incumbent.space is not self.space:
            raise ValueError(
                "incumbent must be indexed over this optimizer's space — "
                "rebind the old ConfigSpace to the new workload first"
            )
        self.incumbent = incumbent
        self.incumbent_workload = incumbent_workload
        self.warm_divergence = warm_divergence
        self.warm_edit_frac = warm_edit_frac
        self.time_budget_s = time_budget_s
        self.fast = FAST_ALGORITHMS[fast](self.space)
        if slow == "mcts":
            self.slow: OptimizerProcedure = MCTSSlow(
                self.space, iterations=mcts_iterations, seed=seed
            )
        else:
            self.slow = SLOW_ALGORITHMS[slow](self.space)
        self.ga = GeneticOptimizer(
            self.space,
            self.slow,
            population=ga_population,
            rounds=ga_rounds,
            seed=seed,
            time_budget_s=time_budget_s,
        )

    def _warm_fast(
        self, deadline: Optional[float]
    ) -> "tuple[Optional[Deployment], Optional[int], Optional[str], Optional[int]]":
        """Phase-1 warm path: (deployment, edits, fallback reason, budget)."""
        inc = self.incumbent
        if self.incumbent_workload is not None and self.space.workload.n:
            old = self.incumbent_workload.required()
            new = self.space.req
            div = float(np.max(np.abs(new - old) / np.maximum(old, 1e-12)))
            if div > self.warm_divergence:
                return None, None, "divergence", None
        budget = max(2, int(math.ceil(self.warm_edit_frac * max(inc.num_gpus, 1))))
        repaired = warm_repair(
            self.space, self.fast, inc, edit_budget=budget, deadline=deadline
        )
        if repaired is None:
            return None, None, "edit_budget", None
        idx, edits = repaired
        return idx.to_deployment(), edits, None, budget

    def run(self, skip_phase2: bool = False) -> OptimizeReport:
        # the wall clock feeds only the report's seconds and the anytime
        # deadline: with ``time_budget_s=None`` the result is seed-determined
        t0 = time.monotonic()
        fast_dep: Optional[Deployment] = None
        warm_edits: Optional[int] = None
        warm_fallback: Optional[str] = None
        edit_budget: Optional[int] = None
        if self.incumbent is not None:
            deadline = (
                t0 + self.time_budget_s if self.time_budget_s is not None else None
            )
            fast_dep, warm_edits, warm_fallback, edit_budget = self._warm_fast(deadline)
        warm = fast_dep is not None
        if fast_dep is None:
            fast_dep = self.fast.solve()
        t1 = time.monotonic()
        if not fast_dep.is_valid(self.space.workload):
            raise RuntimeError(
                "phase-1 deployment does not satisfy the workload — the fast "
                "algorithm or warm-start edits produced an invalid placement"
            )
        if skip_phase2:
            return OptimizeReport(
                fast_dep,
                fast_dep,
                [fast_dep.num_gpus],
                t1 - t0,
                t1 - t0,
                warm=warm,
                warm_edits=warm_edits,
                warm_fallback=warm_fallback,
            )
        result: GAResult = self.ga.run(
            fast_dep,
            incumbent=self.incumbent.to_deployment() if warm else None,
            edit_budget=edit_budget,
        )
        t2 = time.monotonic()
        return OptimizeReport(
            fast_deployment=fast_dep,
            best_deployment=result.best,
            ga_history=result.history,
            fast_seconds=t1 - t0,
            total_seconds=t2 - t0,
            warm=warm,
            warm_edits=warm_edits,
            warm_fallback=warm_fallback,
        )
