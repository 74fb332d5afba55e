"""A100 MIG partition rules (§2.1, Figure 2) — the paper-faithful rule-set.

An A100 exposes 7 compute slices.  Instances come in sizes 1,2,3,4,7 (5/7 and
6/7 are not allocatable).  Each instance size has a fixed set of *placements*
(which compute slices it may occupy) — this placement structure, not a
free-count, decides legality, which is exactly the paper's point: "having n
units of free resources does not imply that a GPU is able to allocate an n/7
instance".

Placements follow NVIDIA's profile placement table (MIG user guide):

  * 1/7 : any single slice 0..6
  * 2/7 : aligned pairs {0,1} {2,3} {4,5}
  * 3/7 : {0,1,2} or {4,5,6}
  * 4/7 : {0,1,2,3}
  * 7/7 : {0..6}

plus the paper's *hard-coded exception*: "4/7 + 3/7" is placement-compatible
but prohibited in practice (§2.1), while "3/7 + 3/7" is legal.  We encode the
exception explicitly.

The port's copy of the JAX package's ``core/mig.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, FrozenSet, List, Sequence, Tuple

from repro_torch.core.rms import Partition, ReconfigRules

# placement -> frozenset of occupied compute slices
PLACEMENTS: Dict[int, Tuple[FrozenSet[int], ...]] = {
    1: tuple(frozenset({i}) for i in range(7)),
    2: (frozenset({0, 1}), frozenset({2, 3}), frozenset({4, 5})),
    3: (frozenset({0, 1, 2}), frozenset({4, 5, 6})),
    4: (frozenset({0, 1, 2, 3}),),
    7: (frozenset(range(7)),),
}

# The paper's hard-coded rule: a 4/7 and a 3/7 instance may not coexist.
FORBIDDEN_PAIRS: Tuple[FrozenSet[int], ...] = (frozenset({3, 4}),)


class A100Rules(ReconfigRules):
    """The literal A100 MIG legality oracle."""

    @property
    def device_size(self) -> int:
        return 7

    @property
    def instance_sizes(self) -> Sequence[int]:
        return (1, 2, 3, 4, 7)

    def is_legal_partition(self, partition: Partition) -> bool:
        partition = tuple(sorted(partition))
        if partition == ():
            return True
        sizes = set(partition)
        for bad in FORBIDDEN_PAIRS:
            if bad <= sizes:
                return False
        return self._placeable(partition)

    @functools.lru_cache(maxsize=None)
    def _placeable(self, partition: Partition) -> bool:
        """Backtracking search for a non-overlapping placement assignment."""

        def rec(idx: int, occupied: FrozenSet[int]) -> bool:
            if idx == len(partition):
                return True
            size = partition[idx]
            for pl in PLACEMENTS[size]:
                if not (pl & occupied):
                    if rec(idx + 1, occupied | pl):
                        return True
            return False

        # place large instances first: fewer placements, prunes faster
        ordered = tuple(sorted(partition, reverse=True))
        partition = ordered
        return rec(0, frozenset())

    @functools.lru_cache(maxsize=None)
    def _legal_cache(self) -> Tuple[Partition, ...]:
        out = set()
        sizes = self.instance_sizes

        def rec(cur: Tuple[int, ...], start: int) -> None:
            for i in range(start, len(sizes)):
                cand = tuple(sorted(cur + (sizes[i],)))
                if sum(cand) > self.device_size:
                    continue
                if cand in out:
                    continue
                if self.is_legal_partition(cand):
                    out.add(cand)
                    rec(cand, 0)

        rec((), 0)
        return tuple(sorted(out))

    def legal_partitions(self) -> List[Partition]:
        return list(self._legal_cache())


# A module-level singleton: TwoPhaseOptimizer refuses a ConfigSpace whose
# ``rules`` is not the very object it was given, and the methods' own
# lru_caches key on ``self``.  Keep the cache so every caller shares one.
@functools.lru_cache(maxsize=None)
def a100_rules() -> A100Rules:
    return A100Rules()
