"""H100 rule-sets: MIG instances of one card, and groups of cards of one node.

The port's counterpart of the JAX package's ``core/tpu_slice.py``, whose
rules carve a TPU pod.  Two granularities, both in compute slices (a
card's seventh):

  * :class:`H100MigRules` — one H100 80GB cut into MIG instances.  NVIDIA's
    MIG user guide (https://docs.nvidia.com/datacenter/tesla/mig-user-guide/)
    places the H100's profiles where it places the A100's: 1g at any of
    slices 0-6, 2g at 0/2/4, 3g at 0/4, 4g at 0, 7g at 0.  So the
    placement engine is :class:`repro_torch.core.mig.A100Rules`'s, and the
    sizes are 1, 2, 3, 4 and 7.  The paper's "no 4/7 + 3/7" exception is
    kept: it is carried over from the paper's A100 practice, and it cannot
    be checked on a card whose MIG mode cannot be switched on.  On top of
    the compute slices, the H100 80GB splits its memory into 8 slices and
    gives each profile its own share of them (1g.10gb 1, 2g.20gb 2,
    3g.40gb 4, 4g.40gb 4, 7g.80gb 8; ``roofline/hw.py:MIG_MEMORY_SLICES``),
    so a partition is legal only where those shares fit the card too.  Of
    the A100's partitions, that removes 1+3+3 (9 memory slices).
  * :class:`H100NodeRules` — one HGX node of 8 H100s on one NVSwitch,
    carved into groups of 1, 2, 4 or 8 cards (7, 14, 28 and 56 slices).
    NVSwitch joins every pair of cards, so a group needs no alignment: any
    multiset of those sizes that sums to at most 56 is legal.  This is the
    granularity that hosts a model no single card holds, as the
    reference's ``PodSliceRules`` does for its largest architectures.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

from repro_torch.core.mig import A100Rules
from repro_torch.core.rms import Partition, ReconfigRules
from repro_torch.roofline.hw import MEMORY_SLICES, MIG_MEMORY_SLICES

CARDS_PER_NODE = 8
SLICES_PER_CARD = 7


class H100MigRules(A100Rules):
    """Legality oracle for the MIG instances of one H100 80GB: the A100's
    placement table and exception, and the card's 8 memory slices (see the
    module docstring).  The inherited ``_legal_cache`` enumerates through
    :meth:`is_legal_partition`, so ``legal_partitions()`` drops what
    overfills memory too: the memory sum only grows as instances are
    added, so no legal partition lies beyond an illegal one."""

    def is_legal_partition(self, partition: Partition) -> bool:
        return (
            sum(MIG_MEMORY_SLICES[s] for s in partition) <= MEMORY_SLICES
            and super().is_legal_partition(partition)
        )


@functools.lru_cache(maxsize=None)
def h100_mig_rules() -> H100MigRules:
    """The shared instance (the optimizer checks rules by identity)."""
    return H100MigRules()


class H100NodeRules(ReconfigRules):
    """Legality oracle for groups of whole cards of one 8-card node."""

    @property
    def device_size(self) -> int:
        return CARDS_PER_NODE * SLICES_PER_CARD

    @property
    def instance_sizes(self) -> Sequence[int]:
        return tuple(SLICES_PER_CARD * n for n in (1, 2, 4, 8))

    def is_legal_partition(self, partition: Partition) -> bool:
        return (
            all(s in self.instance_sizes for s in partition)
            and sum(partition) <= self.device_size
        )

    @functools.lru_cache(maxsize=None)
    def _legal_cache(self) -> Tuple[Partition, ...]:
        out = set()
        sizes = self.instance_sizes

        def rec(cur: Tuple[int, ...]) -> None:
            for s in sizes:
                cand = tuple(sorted(cur + (s,)))
                if sum(cand) > self.device_size or cand in out:
                    continue
                out.add(cand)
                rec(cand)

        rec(())
        return tuple(sorted(out))

    def legal_partitions(self) -> List[Partition]:
        return list(self._legal_cache())


@functools.lru_cache(maxsize=None)
def h100_node_rules() -> H100NodeRules:
    """The shared instance (the optimizer checks rules by identity)."""
    return H100NodeRules()
