"""Bridge: the port's architectures → scheduler performance profiles.

The port's counterpart of the JAX package's ``core/arch_bridge.py``: the
architecture configs the port serves are turned into
:class:`ArchPerfSpec`s, so :class:`RooflineProfiles` can hand the
MIG-Serving optimizer analytically derived (throughput, latency) numbers
per (arch × H100 MIG instance size) or, for a model no card holds, per
(arch × group of cards of an 8-card node).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.profiles import ArchPerfSpec, RooflineProfiles
from repro_torch.roofline.hw import H100MigChip


def arch_perf_specs(
    arch_ids: Optional[Sequence[str]] = None, context: int = 4096
) -> List[ArchPerfSpec]:
    out = []
    for aid in arch_ids or ARCH_IDS:
        cfg = get_config(aid)
        out.append(
            ArchPerfSpec(
                name=aid,
                params=cfg.param_count(),
                active_params=cfg.active_param_count(),
                kv_bytes_per_token=cfg.kv_bytes_per_token(),
                context=context,
            )
        )
    return out


def h100_arch_profiles(
    arch_ids: Optional[Sequence[str]] = None,
    context: int = 4096,
    sizes: Sequence[int] = (1, 2, 3, 4, 7),
) -> RooflineProfiles:
    """Profiles over the H100 MIG instance sizes (7 = the whole card), the
    counterpart of the reference's ``tpu_arch_profiles`` over TPU pod
    slices."""
    return RooflineProfiles(arch_perf_specs(arch_ids, context), sizes=sizes,
                            chip=H100MigChip())


def h100_node_profiles(
    arch_ids: Optional[Sequence[str]] = None,
    context: int = 4096,
    sizes: Sequence[int] = (7, 14, 28, 56),
) -> RooflineProfiles:
    """Profiles over groups of 1, 2, 4 and 8 whole cards of one node (in
    compute slices, as :class:`repro_torch.core.h100_slice.H100NodeRules`
    counts them), the counterpart of the reference's ``tpu_arch_profiles``
    over pod slices: the granularity on which the largest models fit."""
    return h100_arch_profiles(arch_ids, context, sizes)
