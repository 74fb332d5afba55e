"""Deployments, GPU configurations, utilities and completion rates (§5.1).

Vocabulary (paper §5.1):

  * **workload** — services with SLOs (required throughput + latency bound).
  * **GPU configuration** — one device's partition plus a service assignment
    (and batch size) per instance.
  * **utility** of a config — vector over services: fraction of each service's
    required throughput this one device contributes.
  * **completion rates** — vector over services: fraction of required
    throughput currently met (capped at 1 for scoring).
  * **deployment** — a list of GPU configurations; valid iff completion
    rates are all ≥ 1.

An *optimizer procedure* (§5.1) maps (profiles, workload, completion rates)
→ a list of GPU configs whose summed utility covers the remaining need.

The port's copy of the JAX package's ``core/deployment.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import abc
import dataclasses
import itertools
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import PerfProfile
from repro_torch.core.rms import Partition, ReconfigRules, Service, SLO


@dataclasses.dataclass(frozen=True)
class Workload:
    services: Tuple[Service, ...]

    def __post_init__(self):
        # name -> service index, built once: ``index`` is called per
        # assignment in every utility evaluation on the optimizer hot path.
        object.__setattr__(
            self, "_index", {s.name: s.index for s in self.services}
        )

    @staticmethod
    def make(slos: Dict[str, SLO]) -> "Workload":
        return Workload(
            tuple(
                Service(name=n, slo=s, index=i) for i, (n, s) in enumerate(slos.items())
            )
        )

    @property
    def names(self) -> List[str]:
        return [s.name for s in self.services]

    @property
    def n(self) -> int:
        return len(self.services)

    def required(self) -> np.ndarray:
        return np.array([s.slo.throughput for s in self.services], dtype=np.float64)

    def index(self, name: str) -> int:
        return self._index[name]


@dataclasses.dataclass(frozen=True)
class InstanceAssignment:
    """One instance inside a GPU config: ``service is None`` means idle."""

    size: int
    service: Optional[str]
    batch: int = 0
    throughput: float = 0.0  # req/s this instance sustains for its service


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    """A device partition plus per-instance service assignments."""

    partition: Partition
    assignments: Tuple[InstanceAssignment, ...]

    def __post_init__(self):
        sizes = tuple(sorted(a.size for a in self.assignments))
        if sizes != tuple(sorted(self.partition)):
            raise ValueError(
                f"assignments must cover the partition: assignment sizes "
                f"{sizes} != partition {tuple(sorted(self.partition))}"
            )

    def services_used(self) -> Tuple[str, ...]:
        return tuple(sorted({a.service for a in self.assignments if a.service}))

    def utility(self, workload: Workload) -> np.ndarray:
        """Fraction of each service's SLO throughput this device contributes."""
        u = np.zeros(workload.n)
        req = workload.required()
        for a in self.assignments:
            if a.service is not None:
                i = workload.index(a.service)
                u[i] += a.throughput / req[i]
        return u

    def canonical(self) -> Tuple:
        """Hashable form that ignores instance ordering (instances of equal
        size are interchangeable — the mutation insight, §5.2).  Memoized:
        it keys the config-index lookup on every fitness evaluation."""
        c = self.__dict__.get("_canonical")
        if c is None:
            c = tuple(
                sorted((a.size, a.service or "", a.batch) for a in self.assignments)
            )
            self.__dict__["_canonical"] = c
        return c


@dataclasses.dataclass
class Deployment:
    configs: List[GPUConfig]

    @property
    def num_gpus(self) -> int:
        return len(self.configs)

    def utility(self, workload: Workload) -> np.ndarray:
        u = np.zeros(workload.n)
        for c in self.configs:
            u += c.utility(workload)
        return u

    def completion_rates(self, workload: Workload) -> np.ndarray:
        return self.utility(workload)

    def is_valid(self, workload: Workload, atol: float = 1e-9) -> bool:
        return bool(np.all(self.completion_rates(workload) >= 1.0 - atol))

    def copy(self) -> "Deployment":
        return Deployment(list(self.configs))


@dataclasses.dataclass(eq=False)  # auto __eq__ would bool() the counts array
class IndexedDeployment:
    """A deployment as a config-index count vector over a :class:`ConfigSpace`.

    The array-native representation of the optimizer core: ``counts[i]`` is
    the multiplicity of ``space.configs[i]``; configs outside the enumerated
    pair space (the greedy's packed >2-service candidates, exotic mutants)
    ride along in ``extras``.  Completion rates collapse to two sparse
    ``np.bincount`` gathers instead of a Python walk over configs and
    assignments.

    The count vector forgets config *order*, so order-sensitive consumers
    (the §6 controller transitions one target config at a time) should keep
    using :class:`Deployment`; ``to_deployment`` emits enumeration order.
    """

    space: ConfigSpace
    counts: np.ndarray  # (len(space),) int64 multiplicities
    extras: List[GPUConfig] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_deployment(space: ConfigSpace, dep: Deployment) -> "IndexedDeployment":
        counts = np.zeros(len(space), dtype=np.int64)
        extras: List[GPUConfig] = []
        for cfg in dep.configs:
            i = space.index_of(cfg)
            if i >= 0:
                counts[i] += 1
            else:
                extras.append(cfg)
        return IndexedDeployment(space, counts, extras)

    @property
    def num_gpus(self) -> int:
        return int(self.counts.sum()) + len(self.extras)

    def completion_rates(self) -> np.ndarray:
        c = self.space.completion_of_counts(self.counts)
        for cfg in self.extras:
            c = c + self.space.utility_cached(cfg)
        return c

    def is_valid(self, atol: float = 1e-9) -> bool:
        return bool(np.all(self.completion_rates() >= 1.0 - atol))

    def to_deployment(self) -> Deployment:
        configs: List[GPUConfig] = []
        for i in np.flatnonzero(self.counts):
            configs.extend([self.space.configs[int(i)]] * int(self.counts[i]))
        return Deployment(configs + list(self.extras))


def make_assignment(
    profile: PerfProfile, workload: Workload, size: int, service: Optional[str]
) -> InstanceAssignment:
    """Assign ``service`` to a ``size`` instance at the paper's batching rule:
    largest batch whose latency meets the SLO."""
    if service is None:
        return InstanceAssignment(size, None)
    slo = workload.services[workload.index(service)].slo
    b = profile.best_batch(service, size, slo.latency_ms)
    if b == 0:
        return InstanceAssignment(size, None)  # infeasible: leave idle
    tput = profile.throughput(service, size, slo.latency_ms)
    return InstanceAssignment(size, service, b, tput)


# ---------------------------------------------------------------------------
# Config-space enumeration (§5.1: "the utility space is enormous")
# ---------------------------------------------------------------------------


class ConfigSpace:
    """All GPU configs mixing at most two services (Fig. 15 line 2), scored
    vectorially.

    For each full partition we group equal-sized instances; for a service
    pair (a, b) each size-group of multiplicity m admits m+1 splits.  Configs
    are deduplicated by canonical form.  The utility of each config touches
    ≤ 2 services, so scoring is two sparse gathers (see ``score_all``).
    """

    def __init__(
        self,
        rules: ReconfigRules,
        profile: PerfProfile,
        workload: Workload,
    ):
        self.rules = rules
        self.profile = profile
        self.workload = workload
        self.req = workload.required()
        self.partitions: List[Partition] = rules.full_partitions()
        self._tput: Dict[Tuple[str, int], float] = {}
        self._batch: Dict[Tuple[str, int], int] = {}
        # (service, size) -> the one InstanceAssignment every config shares;
        # assignments are frozen, so enumeration and the packed candidates
        # reuse objects instead of re-deriving batch/throughput.
        self._assign: Dict[Tuple[Optional[str], int], InstanceAssignment] = {
            (None, size): InstanceAssignment(size, None)
            for size in rules.instance_sizes
        }
        for svc in workload.services:
            for size in rules.instance_sizes:
                t = profile.throughput(svc.name, size, svc.slo.latency_ms)
                b = profile.best_batch(svc.name, size, svc.slo.latency_ms)
                self._tput[(svc.name, size)] = t
                self._batch[(svc.name, size)] = b
                self._assign[(svc.name, size)] = (
                    InstanceAssignment(size, svc.name, b, t)
                    if b > 0
                    else InstanceAssignment(size, None)  # infeasible: idle
                )
        self.configs: List[GPUConfig] = []
        self._ia: List[int] = []  # service index a
        self._ib: List[int] = []  # service index b (may equal a)
        self._ua: List[float] = []  # utility toward a
        self._ub: List[float] = []  # utility toward b
        self._ta: List[float] = []  # raw throughput toward a (for rebind)
        self._tb: List[float] = []  # raw throughput toward b
        self._index_of: Dict[Tuple, int] = {}  # canonical form -> config index
        self._build()
        self.ia = np.array(self._ia, dtype=np.int64)
        self.ib = np.array(self._ib, dtype=np.int64)
        self.ua = np.array(self._ua, dtype=np.float64)
        self.ub = np.array(self._ub, dtype=np.float64)
        self.ta = np.array(self._ta, dtype=np.float64)
        self.tb = np.array(self._tb, dtype=np.float64)
        # per-service boolean masks over the config space: row i is True at
        # configs touching service i (MCTS edge generation unions these
        # instead of scanning every config in Python).
        cidx = np.arange(len(self.configs))
        self.service_masks = np.zeros((workload.n, len(self.configs)), dtype=bool)
        if len(self.configs):
            self.service_masks[self.ia, cidx] = True
            self.service_masks[self.ib, cidx] = True
        # per-service config index lists, for incremental score maintenance
        self.service_configs: List[np.ndarray] = [
            np.flatnonzero(self.service_masks[i]) for i in range(workload.n)
        ]
        self._util_matrix: Optional[np.ndarray] = None
        self._packed_tables: Optional["_PackedTables"] = None

    # -- enumeration -----------------------------------------------------------
    def _config_for_split(
        self, partition: Partition, groups: List[Tuple[int, int]], pick: Tuple[int, ...], a: str, b: str
    ) -> Optional[GPUConfig]:
        assigns: List[InstanceAssignment] = []
        for (size, mult), ja in zip(groups, pick):
            assigns.extend([self._assign[(a, size)]] * ja)
            assigns.extend([self._assign[(b, size)]] * (mult - ja))
        if all(x.service is None for x in assigns):
            return None
        return GPUConfig(partition, tuple(assigns))

    def _build(self) -> None:
        req = self.req
        names = self.workload.names
        pairs = list(itertools.combinations(range(len(names)), 2)) + [
            (i, i) for i in range(len(names))
        ]
        for partition in self.partitions:
            groups = [
                (size, sum(1 for s in partition if s == size))
                for size in sorted(set(partition))
            ]
            ranges = [range(m + 1) for _, m in groups]
            for (i, j) in pairs:
                a, b = names[i], names[j]
                for pick in itertools.product(*ranges):
                    if i == j and any(p != groups[k][1] for k, p in enumerate(pick)):
                        continue  # single-service: only the all-a split
                    cfg = self._config_for_split(partition, groups, pick, a, b)
                    if cfg is None:
                        continue
                    key = cfg.canonical()
                    if key in self._index_of:
                        continue
                    self._index_of[key] = len(self.configs)
                    ta = sum(
                        x.throughput for x in cfg.assignments if x.service == a
                    )
                    self.configs.append(cfg)
                    self._ia.append(i)
                    self._ib.append(j)
                    self._ua.append(ta / req[i])
                    self._ta.append(ta)
                    if j != i:
                        tb = sum(
                            x.throughput for x in cfg.assignments if x.service == b
                        )
                        self._ub.append(tb / req[j])
                        self._tb.append(tb)
                    else:
                        self._ub.append(0.0)
                        self._tb.append(0.0)

    # -- scoring (§5.3) ----------------------------------------------------------
    def score_all(self, completion: np.ndarray) -> np.ndarray:
        """score(config) = Σ_i (1 − c_i)·u_i with c clamped to [0,1]."""
        # np.maximum is np.clip(lo=0, hi=None) minus the dispatch overhead
        need = np.maximum(1.0 - completion, 0.0)
        return need[self.ia] * self.ua + need[self.ib] * self.ub

    def utility_of(self, idx: int) -> np.ndarray:
        u = np.zeros(self.workload.n)
        u[self.ia[idx]] += self.ua[idx]
        u[self.ib[idx]] += self.ub[idx]
        return u

    # -- the array-native fast path ----------------------------------------------
    def index_of(self, cfg: GPUConfig) -> int:
        """Index of ``cfg`` in the enumerated space, or -1 when it lies
        outside it (packed >2-service candidates, exotic mutants)."""
        return self._index_of.get(cfg.canonical(), -1)

    def utility_cached(self, cfg: GPUConfig) -> np.ndarray:
        """Exact ``cfg.utility(workload)``, computed once per config object.

        The returned array is shared — treat it as read-only.  The memo is
        per *object*, not per canonical form: canonical-equal configs built
        with different instance orderings can sum to utilities differing in
        the last ulp, and the bit-identity contract (``fitness_batch`` ==
        the scalar ``_fitness``) requires each object to see exactly its own
        ``cfg.utility`` result.  The space is held through a weakref so a
        long-lived deployment doesn't pin every ConfigSpace it ever met.
        """
        memo = cfg.__dict__.get("_util")
        if memo is not None and memo[0]() is self:
            return memo[1]
        u = cfg.utility(self.workload)
        cfg.__dict__["_util"] = (weakref.ref(self), u)
        return u

    @property
    def util_matrix(self) -> np.ndarray:
        """Dense ``(num_configs, n)`` utility rows; row ``i`` equals
        ``utility_of(i)`` bit-for-bit (built by two scatter-adds)."""
        if self._util_matrix is None:
            m = np.zeros((len(self.configs), self.workload.n))
            if len(self.configs):
                cidx = np.arange(len(self.configs))
                np.add.at(m, (cidx, self.ia), self.ua)
                np.add.at(m, (cidx, self.ib), self.ub)
            self._util_matrix = m
        return self._util_matrix

    def completion_of_counts(self, counts: np.ndarray) -> np.ndarray:
        """Completion rates of a config-index count vector: two sparse
        ``np.bincount`` gathers over the (ia, ua)/(ib, ub) structure."""
        n = self.workload.n
        nz = np.flatnonzero(counts)
        if not len(nz):
            return np.zeros(n)
        w = counts[nz].astype(np.float64)
        c = np.bincount(self.ia[nz], weights=w * self.ua[nz], minlength=n)
        c += np.bincount(self.ib[nz], weights=w * self.ub[nz], minlength=n)
        return c

    def completion_of_count_matrix(self, counts: np.ndarray) -> np.ndarray:
        """Batched completion: ``(P, num_configs)`` counts -> ``(P, n)``
        completions in one matrix multiply against :attr:`util_matrix`."""
        return counts @ self.util_matrix

    @property
    def packed_tables(self) -> "_PackedTables":
        """Precomputed arrays for the vectorized packed-candidate scan."""
        if self._packed_tables is None:
            self._packed_tables = _PackedTables(self)
        return self._packed_tables

    # -- warm-start rebinding ----------------------------------------------------
    def compatible(self, workload: Workload) -> bool:
        """True when ``workload`` differs from this space's only in required
        throughputs: same service names in the same order, same latency SLOs.
        Enumeration (configs, assignments, batch sizes) depends only on names
        and latency bounds, so a compatible workload can :meth:`rebind`."""
        if workload.names != self.workload.names:
            return False
        return all(
            a.slo.latency_ms == b.slo.latency_ms
            for a, b in zip(workload.services, self.workload.services)
        )

    def rebind(self, workload: Workload) -> "ConfigSpace":
        """A ConfigSpace over ``workload`` sharing this one's enumeration.

        The reoptimize loop's workloads differ only in required rates (traffic
        drift), which enter the space solely through the ``t / req`` utility
        normalization.  Rebinding recomputes those divisions from the stored
        raw throughputs — the identical IEEE operations a cold build performs,
        so a rebound space is bit-identical to a fresh ``ConfigSpace`` (pinned
        by tests) at a fraction of the cost.  Config indices carry over
        one-for-one, so incumbent count vectors need no remapping.
        """
        if not self.compatible(workload):
            raise ValueError(
                "rebind requires identical service names and latency SLOs; "
                "build a fresh ConfigSpace instead"
            )
        new = object.__new__(ConfigSpace)
        new.rules = self.rules
        new.profile = self.profile
        new.workload = workload
        new.req = workload.required()
        new.partitions = self.partitions
        new._tput = self._tput
        new._batch = self._batch
        new._assign = self._assign
        new.configs = self.configs
        new._ia = self._ia
        new._ib = self._ib
        new._ua = self._ua
        new._ub = self._ub
        new._ta = self._ta
        new._tb = self._tb
        new._index_of = self._index_of
        new.ia = self.ia
        new.ib = self.ib
        new.ta = self.ta
        new.tb = self.tb
        # the only req-dependent arrays: same element-wise divisions _build
        # performs (ta / req[i]), so results match a cold build bit-for-bit
        new.ua = self.ta / new.req[self.ia] if len(self.ia) else self.ua
        new.ub = self.tb / new.req[self.ib] if len(self.ib) else self.ub
        new.service_masks = self.service_masks
        new.service_configs = self.service_configs
        new._util_matrix = None  # req-dependent lazies rebuild on demand
        new._packed_tables = None
        return new

    def __len__(self) -> int:
        return len(self.configs)


class _PackedTables:
    """Arrays driving the vectorized Fig.-15 packed-candidate scan.

    Partitions become rows, sorted by instance count (descending) so that at
    step ``j`` exactly the first ``active[j]`` rows still have an instance to
    assign; ``M[k, i]`` is service ``i``'s throughput on size-slot ``k``
    normalized by its required rate — the same ``t / req_i`` the scalar loop
    computed, so the vectorized scan reproduces it float-for-float.
    """

    def __init__(self, space: ConfigSpace):
        n = space.workload.n
        sizes = sorted({s for p in space.partitions for s in p})
        slot = {s: k for k, s in enumerate(sizes)}
        self.M = np.zeros((len(sizes), n))
        for k, s in enumerate(sizes):
            for svc in space.workload.services:
                self.M[k, svc.index] = (
                    space._tput[(svc.name, s)] / space.req[svc.index]
                )
        seqs = [sorted(p, reverse=True) for p in space.partitions]
        self.P = len(seqs)
        order = sorted(range(self.P), key=lambda i: -len(seqs[i]))
        self.row_to_orig = np.array(order, dtype=np.int64)
        self.orig_to_row = np.empty(self.P, dtype=np.int64)
        self.orig_to_row[self.row_to_orig] = np.arange(self.P)
        self.max_len = max((len(s) for s in seqs), default=0)
        self.step_slot = np.zeros((self.P, self.max_len), dtype=np.int64)
        self.step_size = np.zeros((self.P, self.max_len), dtype=np.int64)
        self.row_len = np.zeros(self.P, dtype=np.int64)
        for r, oi in enumerate(order):
            self.row_len[r] = len(seqs[oi])
            for j, s in enumerate(seqs[oi]):
                self.step_slot[r, j] = slot[s]
                self.step_size[r, j] = s
        self.active = np.array(
            [int(np.sum(self.row_len > j)) for j in range(self.max_len)],
            dtype=np.int64,
        )
        # per-step pre-gathered normalized-throughput rows: M_step[j][r] is
        # row r's instance at step j (rows are length-sorted, so the first
        # active[j] rows are exactly the live ones)
        self.M_step = [
            self.M[self.step_slot[: int(self.active[j]), j]]
            for j in range(self.max_len)
        ]
        self.arange = np.arange(self.P)
        # scratch buffers reused by every packed scan (single-threaded hot
        # loop; contents are only valid until the next scan)
        self.need_buf = np.zeros((self.P, n))
        self.gains_buf = np.zeros((self.P, n))
        self.util_buf = np.zeros((self.P, n))
        self.score_buf = np.zeros(self.P)
        self.choice_buf = np.full((self.P, max(self.max_len, 1)), -1, dtype=np.int64)


class OptimizerProcedure(abc.ABC):
    """§5.1: given completion rates, emit configs covering the residual need.

    Implementations: the fast greedy (Appendix A.1), the MCTS slow algorithm
    (Appendix A.2), and the beyond-paper beam-greedy.  MIG-Serving "is
    designed to be able to switch algorithms easily" (§7) — this ABC is that
    switch point.
    """

    def __init__(self, space: ConfigSpace):
        self.space = space

    @abc.abstractmethod
    def produce(self, completion: np.ndarray) -> List[GPUConfig]:
        ...

    def solve(self) -> Deployment:
        return Deployment(self.produce(np.zeros(self.space.workload.n)))

    def solve_indexed(self) -> IndexedDeployment:
        """``solve()`` in the array-native representation."""
        return IndexedDeployment.from_deployment(self.space, self.solve())
