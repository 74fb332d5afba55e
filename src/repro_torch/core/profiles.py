"""Performance profiles: throughput/latency of a service on each instance size.

The port's copy of the JAX package's ``core/profiles.py``.  MIG-Serving's
optimizer (§5) consumes only a profile: for service *m* on an instance of
size *s*, what throughput can it sustain with per-request latency below
the SLO?

  * :class:`PerfProfile` — the interface, with the paper's §7 rule
    (:meth:`PerfProfile.throughput`: the largest batch whose latency meets
    the SLO) and §2.2 classification;
  * :class:`SyntheticPaperProfiles` — the seeded generator of the paper's
    49-model study (sub-, super- and linear scaling classes), which the
    paper-faithful experiments run on;
  * :class:`RooflineProfiles` — profiles derived from an analytic decode
    roofline over the architectures' configs, on the instances of a
    ``chip`` (by default an H100 cut into MIG instances,
    :class:`repro_torch.roofline.hw.H100MigChip`).
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Dict, List, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.roofline.hw import H100MigChip

BATCH_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)


class PerfProfile(abc.ABC):
    """Throughput/latency oracle consumed by the optimizer."""

    @abc.abstractmethod
    def services(self) -> List[str]:
        ...

    @abc.abstractmethod
    def sizes(self) -> Sequence[int]:
        """Instance sizes this profile covers (must match the rule-set)."""

    @abc.abstractmethod
    def latency_ms(self, model: str, size: int, batch: int) -> float:
        """Per-request latency at the given batch (inf if infeasible)."""

    def feasible(self, model: str, size: int) -> bool:
        return math.isfinite(self.latency_ms(model, size, 1))

    def min_size(self, model: str) -> int:
        for s in sorted(self.sizes()):
            if self.feasible(model, s):
                return s
        raise ValueError(f"{model} fits on no instance size")

    def best_batch(self, model: str, size: int, latency_slo_ms: float) -> int:
        """Largest batch whose latency meets the SLO (0 if none)."""
        best = 0
        for b in BATCH_CANDIDATES:
            if self.latency_ms(model, size, b) <= latency_slo_ms:
                best = b
        return best

    def throughput(self, model: str, size: int, latency_slo_ms: float) -> float:
        """Sustained req/s on one instance at the best SLO-compliant batch."""
        b = self.best_batch(model, size, latency_slo_ms)
        if b == 0:
            return 0.0
        return b * 1000.0 / self.latency_ms(model, size, b)

    # -- the paper's §2.2 classification --------------------------------------
    def classify(self, model: str, latency_slo_ms: float = 1e9) -> str:
        """sub-linear / linear / super-linear, per §2.2's ratio test,
        normalized so the thresholds [6.5, 7.5]/7 transfer to any device size."""
        sizes = sorted(self.sizes())
        full = sizes[-1]
        smallest = self.min_size(model)
        unit = self.throughput(model, smallest, latency_slo_ms) / smallest
        if unit <= 0:
            return "infeasible"
        ratio = self.throughput(model, full, latency_slo_ms) / unit
        lo, hi = 6.5 / 7.0 * full, 7.5 / 7.0 * full
        if ratio < lo:
            return "sub-linear"
        if ratio > hi:
            return "super-linear"
        return "linear"


# ---------------------------------------------------------------------------
# Synthetic paper-like profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _SyntheticModel:
    name: str
    unit_tput: float  # req/s per slice-unit at saturation on min instance
    alpha: float  # throughput ~ size**alpha  (alpha<1 sub-linear, >1 super)
    overhead_ms: float  # fixed per-batch launch overhead
    min_size: int  # smallest instance the model fits on


class SyntheticPaperProfiles(PerfProfile):
    """Seeded generator mirroring the paper's 49-model study (§2.2, App. B).

    Scaling classes are drawn so that non-linear models are prevalent
    (the paper's Figure 4): roughly 45% sub-linear, 30% linear, 25%
    super-linear at moderate batch sizes.  The draws are the reference's,
    in its order, from ``np.random.default_rng(seed)``: the same
    ``(n_models, seed)`` gives the same models in both packages.
    """

    def __init__(
        self,
        n_models: int = 24,
        seed: int = 0,
        sizes: Sequence[int] = (1, 2, 3, 4, 7),
    ):
        rng = np.random.default_rng(seed)
        self._sizes = tuple(sizes)
        full = max(sizes)
        self._models: Dict[str, _SyntheticModel] = {}
        classes = rng.choice(
            ["sub", "lin", "sup"], size=n_models, p=[0.45, 0.30, 0.25]
        )
        for i in range(n_models):
            cls = classes[i]
            if cls == "sub":
                alpha = float(rng.uniform(0.55, 0.85))
            elif cls == "lin":
                alpha = float(rng.uniform(0.95, 1.05))
            else:
                alpha = float(rng.uniform(1.15, 1.45))
            unit = float(rng.uniform(40.0, 400.0))
            overhead = float(rng.uniform(1.0, 6.0))
            # ~20% of models are "large": need a 2- or 3-slice instance
            if rng.random() < 0.2:
                min_size = int(rng.choice([s for s in sizes if 1 < s < full]))
            else:
                min_size = min(sizes)
            name = f"model{i:02d}-{cls}"
            self._models[name] = _SyntheticModel(name, unit, alpha, overhead, min_size)

    def services(self) -> List[str]:
        return list(self._models)

    def sizes(self) -> Sequence[int]:
        return self._sizes

    def latency_ms(self, model: str, size: int, batch: int) -> float:
        m = self._models[model]
        if size < m.min_size:
            return math.inf
        rate = m.unit_tput * (size ** m.alpha)  # req/s at saturation
        return m.overhead_ms + batch * 1000.0 / rate


# ---------------------------------------------------------------------------
# Roofline-derived profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchPerfSpec:
    """The numbers the analytic roofline needs about one architecture.

    Derived from the arch configs (``repro_torch.configs``): parameter
    counts and per-token KV/state bytes.  ``active_params`` < ``params``
    for MoE.
    """

    name: str
    params: float  # total parameters
    active_params: float  # parameters touched per token (MoE: shared+top-k)
    kv_bytes_per_token: float  # decode cache traffic per token per request
    context: int = 4096  # typical serving context for the profile


class Chip(Protocol):
    """The resources of one instance of ``size`` units of a device."""

    def flops(self, size: int) -> float:
        """Peak FLOP/s."""

    def hbm_bw(self, size: int) -> float:
        """Device-memory bytes/s."""

    def hbm_bytes(self, size: int) -> float:
        """Device-memory capacity in bytes."""


class RooflineProfiles(PerfProfile):
    """Decode-roofline profile: latency of one decode step on an instance of
    size ``s`` at batch ``b`` is

        max( (weights_active + b·kv_ctx)/BW(s),   2·N_active·b/F(s) )
        + dispatch overhead

    where F(s) and BW(s) are the instance's FLOP/s and memory bandwidth
    (``chip.flops(s)``, ``chip.hbm_bw(s)``).  Weight streaming dominates
    small batches (memory-bound: throughput per unit grows super-linearly
    with instance size at a fixed latency SLO); KV streaming dominates long
    contexts.  A model is infeasible on an instance whose memory
    (``chip.hbm_bytes(s)``) cannot hold weights + cache within 90% — the
    paper's "smallest instance that can run M".

    ``overhead_ms=0.3`` is the reference's assumed per-step dispatch
    overhead, kept so the two profiles agree; it is not a reading of the
    card.
    """

    def __init__(
        self,
        archs: Sequence[ArchPerfSpec],
        sizes: Sequence[int] = (1, 2, 3, 4, 7),
        chip: Chip = H100MigChip(),
        dtype_bytes: float = 2.0,
        overhead_ms: float = 0.3,
    ):
        self._archs = {a.name: a for a in archs}
        self._sizes = tuple(sizes)
        self.chip = chip
        self.dtype_bytes = dtype_bytes
        self.overhead_ms = overhead_ms

    def services(self) -> List[str]:
        return list(self._archs)

    def sizes(self) -> Sequence[int]:
        return self._sizes

    def latency_ms(self, model: str, size: int, batch: int) -> float:
        a = self._archs[model]
        c = self.chip
        weight_bytes = a.params * self.dtype_bytes
        kv_ctx = a.kv_bytes_per_token * a.context
        hbm_need = weight_bytes + batch * kv_ctx
        if hbm_need > 0.9 * c.hbm_bytes(size):
            return math.inf
        mem_s = (a.active_params * self.dtype_bytes + batch * kv_ctx) / c.hbm_bw(size)
        comp_s = 2.0 * a.active_params * batch / c.flops(size)
        return (max(mem_s, comp_s)) * 1000.0 + self.overhead_ms
