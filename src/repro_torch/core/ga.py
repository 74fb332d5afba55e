"""The tailored Genetic Algorithm gluing fast and slow algorithms (§5.2).

Chromosome = deployment; gene = GPU config.

  * **Crossover** (paper §5.2): randomly erase some GPU configs — completion
    drops below 100% — then run the *slow algorithm* against the residual to
    refill.  This mixes fast- and slow-algorithm genes and keeps the slow
    algorithm's problem size small.
  * **Mutation**: swap services between equal-sized instances running
    different services (inference has no affinity, §5.2).  Mutations do not
    change completion rates — they diversify the service mixes crossover can
    later split.

GA keeps the originals in each round's selection (elitism), so the best
deployment only improves; it stops on timeout/rounds or when the best stopped
improving for ``patience`` rounds (paper: ten).

The port's copy of the JAX package's ``core/ga.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import dataclasses
import time  # contract-ok: wall-clock anytime-budget deadline only; sim time stays logical
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.deployment import (
    ConfigSpace,
    Deployment,
    GPUConfig,
    InstanceAssignment,
    OptimizerProcedure,
)


def _fitness(dep: Deployment, space: ConfigSpace) -> Tuple[int, float]:
    """Primary: fewer devices.  Secondary: less over-provisioned throughput
    (slack), so equal-GPU deployments with tighter packing rank better."""
    c = dep.completion_rates(space.workload)
    return (dep.num_gpus, float(np.sum(np.clip(c - 1.0, 0.0, None))))


def fitness_batch(
    deps: Sequence[Deployment], space: ConfigSpace
) -> List[Tuple[int, float]]:
    """Fitness of a whole population in one vectorized pass.

    Bit-identical to ``[_fitness(d, space) for d in deps]``: each config's
    exact utility vector is computed once (memoized per config *object* by
    ``space.utility_cached``) and accumulated into a ``(P, n)`` completion
    matrix row by row *in deployment config order* — that sequential
    accumulation order is load-bearing: it reproduces the legacy
    config-by-config summation float-for-float, so the GA's selection order
    (and therefore its seeded output) is unchanged.  Do not replace it with
    an order-changing scatter (``np.add.at`` over a globally stacked index
    array is fine only if rows stay grouped per deployment in config order);
    the slack reduction over the matrix stays vectorized.
    """
    if not deps:
        return []
    comp = np.zeros((len(deps), space.workload.n))
    for p, dep in enumerate(deps):
        row = comp[p]
        for cfg in dep.configs:
            row += space.utility_cached(cfg)
    slack = np.sum(np.clip(comp - 1.0, 0.0, None), axis=1)
    return [(dep.num_gpus, float(s)) for dep, s in zip(deps, slack)]


def _canonical_counter(dep: Deployment) -> Counter:
    return Counter(cfg.canonical() for cfg in dep.configs)


def deployment_edit_distance(a: Deployment, b: Deployment) -> int:
    """Devices to add plus devices to remove to turn ``a`` into ``b``.

    Configs compare by canonical form — instances of equal size are
    interchangeable (§5.2), so reordering is free.  The §6 controller's
    transition cost is roughly proportional to this count (each differing
    device is a destroy and/or create), which is why the warm-start path
    bounds it.
    """
    ca, cb = _canonical_counter(a), _canonical_counter(b)
    return sum((ca - cb).values()) + sum((cb - ca).values())


def mutate_swap(dep: Deployment, rng: np.random.Generator, swaps: int = 4) -> Deployment:
    """Swap services between same-size instances of different configs.

    Candidate filtering runs on flat size/service arrays (services swap as
    integer ids alongside the assignment objects); ``np.flatnonzero``
    preserves the scan order of the original list comprehension, so the
    seeded swap sequence is unchanged.
    """
    configs = [list(c.assignments) for c in dep.configs]
    sid: dict = {}
    items = [
        (gi, ii, a.size, sid.setdefault(a.service, len(sid)))
        for gi, assigns in enumerate(configs)
        for ii, a in enumerate(assigns)
        if a.service is not None
    ]
    flat: List[Tuple[int, int]] = [(gi, ii) for gi, ii, _, _ in items]
    size_arr = np.array([t[2] for t in items], dtype=np.int64)
    svc_arr = np.array([t[3] for t in items], dtype=np.int64)
    touched = set()
    for _ in range(swaps):
        if len(flat) < 2:
            break
        i1 = int(rng.integers(len(flat)))
        # same-size instances running a different service; the picked slot
        # itself is excluded for free (its service equals its own)
        cands = np.flatnonzero(
            (size_arr == size_arr[i1]) & (svc_arr != svc_arr[i1])
        )
        if not len(cands):
            continue
        j = int(cands[rng.integers(len(cands))])
        g1, a1 = flat[i1]
        g2, a2 = flat[j]
        s1, s2 = configs[g1][a1], configs[g2][a2]
        configs[g1][a1], configs[g2][a2] = (
            InstanceAssignment(s1.size, s2.service, s2.batch, s2.throughput),
            InstanceAssignment(s2.size, s1.service, s1.batch, s1.throughput),
        )
        svc_arr[i1], svc_arr[j] = svc_arr[j], svc_arr[i1]
        touched.add(g1)
        touched.add(g2)
    # untouched configs keep their objects (and their memoized canonical /
    # utility), so downstream batched fitness stays warm
    return Deployment(
        [
            GPUConfig(dep.configs[gi].partition, tuple(configs[gi]))
            if gi in touched
            else dep.configs[gi]
            for gi in range(len(configs))
        ]
    )


def crossover(
    dep: Deployment,
    space: ConfigSpace,
    slow: OptimizerProcedure,
    rng: np.random.Generator,
    erase_frac: float = 0.25,
) -> Deployment:
    """Erase a random subset of configs and refill with the slow algorithm."""
    n = dep.num_gpus
    k = max(1, int(round(erase_frac * n)))
    erase = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    kept = [c for i, c in enumerate(dep.configs) if i not in erase]
    c = np.zeros(space.workload.n)
    for cfg in kept:
        c += space.utility_cached(cfg)  # exact per-config utility, memoized
    refill = slow.produce(c)
    return Deployment(kept + refill)


@dataclasses.dataclass
class GAResult:
    best: Deployment
    history: List[int]  # best num_gpus per round (round 0 = seed)


class GeneticOptimizer:
    """§5.2 two-phase glue: population of deployments evolved by
    crossover(slow-algorithm refill) + mutation(swap)."""

    def __init__(
        self,
        space: ConfigSpace,
        slow: OptimizerProcedure,
        population: int = 6,
        rounds: int = 10,
        patience: int = 10,
        erase_frac: float = 0.25,
        seed: int = 0,
        time_budget_s: Optional[float] = None,
    ):
        self.space = space
        self.slow = slow
        self.population = population
        self.rounds = rounds
        self.patience = patience
        self.erase_frac = erase_frac
        self.rng = np.random.default_rng(seed)
        self.time_budget_s = time_budget_s

    def run(
        self,
        seed_deployment: Deployment,
        incumbent: Optional[Deployment] = None,
        edit_budget: Optional[int] = None,
    ) -> GAResult:
        # Warm start: with an incumbent and an edit budget, children whose
        # edit distance from the incumbent exceeds the budget are discarded
        # *after* the rng has been consumed for them — the random stream is
        # identical with and without the bound, only selection changes.
        inc_counter: Optional[Counter] = None
        if incumbent is not None and edit_budget is not None:
            inc_counter = _canonical_counter(incumbent)
        space = self.space
        pop: List[Deployment] = [seed_deployment]
        # diversify the initial population with mutated copies
        while len(pop) < self.population:
            pop.append(mutate_swap(seed_deployment, self.rng))
        history = [min(p.num_gpus for p in pop)]
        fits = fitness_batch(pop, space)
        bi = min(range(len(pop)), key=fits.__getitem__)
        best, best_fit = pop[bi], fits[bi]
        stale = 0
        # the wall clock only cuts rounds when ``time_budget_s`` is set; with
        # None the rounds, and so the seeded result, are the reference's
        t0 = time.monotonic()
        for _ in range(self.rounds):
            if self.time_budget_s and time.monotonic() - t0 > self.time_budget_s:
                break
            children: List[Deployment] = []
            for parent in pop:
                child = crossover(parent, space, self.slow, self.rng, self.erase_frac)
                children.append(mutate_swap(child, self.rng))
            if inc_counter is not None:
                kept = []
                for ch in children:
                    cc = _canonical_counter(ch)
                    dist = sum((cc - inc_counter).values()) + sum(
                        (inc_counter - cc).values()
                    )
                    if dist <= edit_budget:
                        kept.append(ch)
                children = kept
            # elitism: originals compete with children (§5.2); the whole
            # merged population is scored in one batched call, then
            # decorate-sort-undecorate keeps the stable ordering
            merged = pop + children
            fits = fitness_batch(merged, space)
            order = sorted(range(len(merged)), key=fits.__getitem__)
            pop = [merged[i] for i in order[: self.population]]
            new_best, new_fit = pop[0], fits[order[0]]
            if new_fit < best_fit:
                best, best_fit = new_best, new_fit
                stale = 0
            else:
                stale += 1
            history.append(best.num_gpus)
            if stale >= self.patience:
                break
        # same accumulation as Deployment.is_valid, from the utility memo
        comp = np.zeros(space.workload.n)
        for cfg in best.configs:
            comp += space.utility_cached(cfg)
        if not bool(np.all(comp >= 1.0 - 1e-9)):
            raise RuntimeError(
                "GA best individual fails SLO completion — repair should have "
                f"kept every service >= 1.0, got min {float(comp.min()):.6f}"
            )
        return GAResult(best=best, history=history)
