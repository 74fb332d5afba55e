"""The scheduler zoo: alternative RMS scheduling policies (§3, §7).

The paper frames MIG serving as one instance of the Reconfigurable Machine
Scheduling Problem and its pipeline as one point in a family of algorithms
("MIG-SERVING is designed to be able to switch algorithms easily", §7).
This module adds two competitors from the retrieved MIG-scheduling
literature, both plugging into :data:`repro_torch.core.optimizer.FAST_ALGORITHMS`
/ ``SLOW_ALGORITHMS`` so the closed-loop simulator benchmarks them without
modification:

  * :class:`FragAwarePacker` — an online fragmentation-aware packer in the
    spirit of arXiv:2512.16099: candidate GPU configs are scored by the
    greedy need-weighted utility *discounted by residual-slice
    fragmentation* — slices a pick would strand, either statically (idle
    instances / unpartitionable slack no allocatable size can reuse) or
    dynamically (slices whose throughput overshoots the residual need of
    an almost-satisfied service).

  * :class:`EnergyAwareRepartitioner` — energy-efficient dynamic
    repartitioning in the spirit of arXiv:2606.25082: candidates are scored
    by SLO progress *per watt* under a per-GPU-slice :class:`PowerModel`
    with a per-instance overhead term, so at equal throughput the policy
    prefers fewer/larger instances (and the periodic reoptimize loop
    repartitions toward them as demand moves).

Both are array-native: per-config factor
vectors are precomputed once from :class:`ConfigSpace`, each round is one
``argmax`` over an incrementally-maintained score vector (only configs
touching the services a pick changed are re-scored), and
``produce_indexed`` emits an :class:`IndexedDeployment` count vector
directly.  Both are deterministic: score ties break by ascending config
index (``np.argmax`` takes the first maximum), and the ``seed`` argument
exists only for registry-API symmetry with the stochastic algorithms.

The port's copy of the JAX package's ``core/zoo.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.deployment import (
    ConfigSpace,
    GPUConfig,
    IndexedDeployment,
    OptimizerProcedure,
)
from repro_torch.core.rms import ReconfigRules


class WeightedScoreGreedy(OptimizerProcedure):
    """Greedy over a re-weighted pair-space score, maintained incrementally.

    Subclasses shape the per-config score through :meth:`_scores` (default:
    the greedy need-weighted utility times a fixed positive ``weights``
    vector).  The hook must preserve score *positivity* — zero only where
    the base score is zero — so this loop terminates exactly when the plain
    greedy does.  Unlike :class:`repro_torch.core.greedy.GreedyFast` there is no
    packed multi-service candidate: the zoo policies choose from the
    enumerated pair space only, which keeps every pick an enumerated config
    index (the count vector never needs ``extras``).
    """

    def __init__(
        self,
        space: ConfigSpace,
        weights: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        super().__init__(space)
        if weights is None:
            weights = np.ones(len(space))
        weights = np.asarray(weights, dtype=np.float64)
        if weights.shape != (len(space),):
            raise ValueError(
                f"one weight per config: got shape {weights.shape}, "
                f"expected ({len(space)},)"
            )
        if not np.all(weights > 0.0):
            raise ValueError("weights must be positive")
        self.weights = weights
        self.seed = seed  # deterministic policy; kept for registry symmetry

    def _scores(self, need: np.ndarray, idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Scores of all configs (``idx is None``) or of the subset ``idx``
        against the residual ``need`` vector."""
        space = self.space
        if idx is None:
            return (need[space.ia] * space.ua + need[space.ib] * space.ub) * self.weights
        return (
            need[space.ia[idx]] * space.ua[idx] + need[space.ib[idx]] * space.ub[idx]
        ) * self.weights[idx]

    def produce(self, completion: np.ndarray) -> List[GPUConfig]:
        configs, _ = self._produce(completion)
        return configs

    def produce_indexed(self, completion: np.ndarray) -> IndexedDeployment:
        """``produce`` in the array-native representation."""
        _, counts = self._produce(completion)
        return IndexedDeployment(self.space, counts)

    def _produce(
        self, completion: np.ndarray
    ) -> Tuple[List[GPUConfig], np.ndarray]:
        space = self.space
        ia, ib, ua, ub = space.ia, space.ib, space.ua, space.ub
        c = completion.astype(np.float64).copy()
        need = np.clip(1.0 - c, 0.0, None)
        scores = self._scores(need)
        out: List[GPUConfig] = []
        counts = np.zeros(len(space), dtype=np.int64)
        guard = 0
        while np.any(c < 1.0 - 1e-9):
            guard += 1
            if guard > 100_000:
                raise RuntimeError(f"{type(self).__name__} failed to converge")
            idx = int(np.argmax(scores)) if len(scores) else 0
            if not len(scores) or scores[idx] <= 0.0:
                raise RuntimeError(
                    "no config has positive score but SLOs unmet — "
                    "some service is infeasible on every instance size"
                )
            out.append(space.configs[idx])
            counts[idx] += 1
            i, j = int(ia[idx]), int(ib[idx])
            c[i] += ua[idx]
            c[j] += ub[idx]
            changed = (i,) if i == j else (i, j)
            for k in changed:
                need[k] = max(0.0, 1.0 - c[k])
            upd = (
                space.service_configs[changed[0]]
                if len(changed) == 1
                else np.concatenate([space.service_configs[k] for k in changed])
            )
            scores[upd] = self._scores(need, upd)
        return out, counts


# ---------------------------------------------------------------------------
# Fragmentation-aware online packing (arXiv:2512.16099)
# ---------------------------------------------------------------------------


def stranded_slices_of(cfg: GPUConfig, rules: ReconfigRules) -> float:
    """Statically stranded residual slices of one GPU config.

    Free capacity is every slice not serving a request: idle instances plus
    unpartitioned slack.  The *stranded* part is what remains after the
    largest allocatable instance size that fits in the largest free chunk is
    carved back out — free capacity no future service could be handed as one
    instance, the fragmentation the online scheduler in arXiv:2512.16099
    packs around.  ``0`` for a fully busy device.
    """
    idle_sizes = [a.size for a in cfg.assignments if a.service is None]
    slack = rules.device_size - sum(a.size for a in cfg.assignments)
    free = sum(idle_sizes) + slack
    if free == 0:
        return 0.0
    chunks = idle_sizes + ([slack] if slack > 0 else [])
    largest_chunk = max(chunks)
    usable = max((s for s in rules.instance_sizes if s <= largest_chunk), default=0)
    return float(free - usable + 0.5 * usable)  # reusable free still costs half


class FragAwarePacker(WeightedScoreGreedy):
    """Fragmentation-aware online packer.

    score(config) = base greedy score / (1 + frag_weight * frag(config, need))

    where ``frag`` counts the device's residual-slice fragmentation as a
    fraction of the device, from two sources:

      * **static** — idle instances and dead slack
        (:func:`stranded_slices_of`), fixed per config;
      * **dynamic** — the share of the config's busy slices whose throughput
        overshoots the residual need (capacity stranded past an
        almost-satisfied service's SLO), recomputed as completion moves.

    A config that exactly covers the remaining need on a full device keeps
    the plain greedy score; one that strands slices is dispreferred in
    proportion — the packer trades immediate utility for partitions whose
    capacity stays useful.
    """

    def __init__(self, space: ConfigSpace, frag_weight: float = 4.0, seed: int = 0):
        super().__init__(space, seed=seed)
        self.frag_weight = frag_weight
        dsize = float(space.rules.device_size)
        self.static_frag = np.array(
            [stranded_slices_of(cfg, space.rules) / dsize for cfg in space.configs],
            dtype=np.float64,
        )
        self.busy_frac = np.array(
            [
                sum(a.size for a in cfg.assignments if a.service is not None) / dsize
                for cfg in space.configs
            ],
            dtype=np.float64,
        )

    def _scores(self, need: np.ndarray, idx: Optional[np.ndarray] = None) -> np.ndarray:
        space = self.space
        if idx is None:
            na, nb = need[space.ia], need[space.ib]
            ua, ub = space.ua, space.ub
            static, busy = self.static_frag, self.busy_frac
        else:
            na, nb = need[space.ia[idx]], need[space.ib[idx]]
            ua, ub = space.ua[idx], space.ub[idx]
            static, busy = self.static_frag[idx], self.busy_frac[idx]
        base = na * ua + nb * ub
        # single-service configs carry ub == 0, so the b-side overshoot is 0
        over = np.maximum(ua - na, 0.0) + np.maximum(ub - nb, 0.0)
        frag = static + busy * (over / (ua + ub))
        return base / (1.0 + self.frag_weight * frag)


# ---------------------------------------------------------------------------
# Energy-aware dynamic repartitioning (arXiv:2606.25082)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Per-GPU-slice power model (A100-flavored defaults, ~400 W TDP).

    ``power(config) = base_w + slice_w * busy_slices + instance_w * n_instances``:
    a static floor for the powered device, a linear term per active compute
    slice, and a per-running-instance overhead (MIG runtime / context
    residency) — the overhead term is what makes fewer/larger instances
    cheaper at equal slice count, the preference arXiv:2606.25082 exploits.
    """

    base_w: float = 60.0
    slice_w: float = 40.0
    instance_w: float = 15.0

    def config_power(self, cfg: GPUConfig) -> float:
        active = [a for a in cfg.assignments if a.service is not None]
        busy = sum(a.size for a in active)
        return self.base_w + self.slice_w * busy + self.instance_w * len(active)

    def instances_power(
        self, instances: Iterable[Tuple[str, int, float]], gpus_in_use: int
    ) -> float:
        """Power of a live instance set (``(service, size, tput)`` triples,
        e.g. ``SimulatedCluster.busy_instances().values()``) across
        ``gpus_in_use`` powered devices."""
        watts = self.base_w * gpus_in_use
        for _svc, size, _tput in instances:
            watts += self.slice_w * size + self.instance_w
        return watts


class EnergyAwareRepartitioner(WeightedScoreGreedy):
    """Energy-aware scheduler: greedy score per watt.

    Each candidate's need-weighted utility is divided by its modeled power
    draw (normalized by a full-device reference so weights stay O(1)); at
    equal throughput the policy picks the config with fewer/larger
    instances.  Run inside the closed loop's periodic reoptimization it
    *repartitions* toward energy-lean deployments as demand moves — the
    dynamic-repartitioning setting of arXiv:2606.25082.
    """

    def __init__(
        self,
        space: ConfigSpace,
        power_model: PowerModel = PowerModel(),
        seed: int = 0,
    ):
        self.power_model = power_model
        power = np.array(
            [power_model.config_power(cfg) for cfg in space.configs],
            dtype=np.float64,
        )
        ref = (
            power_model.base_w
            + power_model.slice_w * space.rules.device_size
            + power_model.instance_w
        )
        super().__init__(space, ref / power, seed=seed)
        self.power = power


def deployment_power(
    configs: Iterable[GPUConfig], model: PowerModel = PowerModel()
) -> float:
    """Total modeled watts of a deployment (sum of per-config power)."""
    return sum(model.config_power(cfg) for cfg in configs)
