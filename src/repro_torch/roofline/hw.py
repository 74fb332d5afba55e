"""NVIDIA H100 hardware constants (the roofline denominators), whole card
and per MIG instance.

The port's counterpart of the JAX package's ``roofline/hw.py``, whose
constants describe a TPU v5e chip.  Whole-card figures are the NVIDIA
H100 SXM5 80GB data sheet's dense rates (no sparsity), the same ones
``chip_smoke.py`` and ``PERF.md`` take as bounds.

MIG: an H100 80GB is cut into 7 compute slices and 8 memory slices.  Its
GPU instance profiles 1g.10gb, 2g.20gb, 3g.40gb, 4g.40gb and 7g.80gb hold
1, 2, 3, 4 and 7 of the compute slices and 1, 2, 4, 4 and 8 of the memory
slices (NVIDIA Multi-Instance GPU user guide, H100 profiles:
https://docs.nvidia.com/datacenter/tesla/mig-user-guide/).  These are the
instance sizes 1/2/3/4/7 that the paper schedules on the A100.

A size that is a multiple of 7 beyond 7 is a group of whole cards of one
8-card node (14, 28 and 56 are 2, 4 and 8 cards): ``n`` cards have ``n``
times one card's FLOP/s, memory and bandwidth.  This is the granularity
that holds a model no single card holds
(:class:`repro_torch.core.h100_slice.H100NodeRules`).
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # bytes
NVLINK_BW = 900e9  # bytes/s to the other cards of the host, both ways together
# bytes/s to the cards of another node: one ConnectX-7 NDR InfiniBand port of
# 400 Gb/s a card (DGX/HGX H100 data sheet), 50 GB/s each way, both ways
# together as NVLINK_BW is counted
IB_BW = 2 * 400e9 / 8

COMPUTE_SLICES = 7
MEMORY_SLICES = 8
# instance size (compute slices) -> memory slices of its MIG profile
MIG_MEMORY_SLICES: Dict[int, int] = {1: 1, 2: 2, 3: 4, 4: 4, 7: 8}


def _cards(size: int) -> int:
    """Whole cards in an instance of ``size`` compute slices (0 for a MIG
    instance smaller than a card)."""
    if size in MIG_MEMORY_SLICES:
        return 1 if size == COMPUTE_SLICES else 0
    if size > 0 and size % COMPUTE_SLICES == 0:
        return size // COMPUTE_SLICES
    raise ValueError(
        f"no H100 MIG instance of size {size}; sizes are {sorted(MIG_MEMORY_SLICES)}"
        f" or a multiple of {COMPUTE_SLICES} (whole cards)"
    )


class H100MigChip:
    """The roofline's resources of one H100 MIG instance of ``size``
    compute slices: ``size / 7`` of the card's FLOP/s, and the memory
    slices of its profile (bytes and bandwidth, ``slices / 8`` of the
    card's).  Size 7 is the whole card, and ``7n`` is ``n`` whole cards."""

    def flops(self, size: int) -> float:
        n = _cards(size)
        return PEAK_FLOPS_BF16 * n if n else PEAK_FLOPS_BF16 * size / COMPUTE_SLICES

    def hbm_bw(self, size: int) -> float:
        n = _cards(size)
        return HBM_BW * n if n else HBM_BW * MIG_MEMORY_SLICES[size] / MEMORY_SLICES

    def hbm_bytes(self, size: int) -> float:
        n = _cards(size)
        return HBM_BYTES * n if n else HBM_BYTES * MIG_MEMORY_SLICES[size] / MEMORY_SLICES
