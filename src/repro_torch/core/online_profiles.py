"""Online profile refinement from production measurements (paper §8.3).

The port's copy of the JAX package's ``core/online_profiles.py``.  The
paper attributes its <5% SLO shortfall to "slight performance variance
between the model performance profiling and the performance of serving
frameworks", and proposes "collecting model performance in production and
gradually updating profiling data used in MIG-SERVING's algorithms".
:class:`MeasuredProfile` is that loop: it wraps any base profile, accepts
per-(service, size) throughput observations from running engines
(``run_closed_loop(measured=...)``), and serves an EWMA-corrected profile
back to the optimizer.

Corrections are multiplicative (observed / predicted at the observed
batch) so a single scale factor transfers across batch sizes and latency
SLOs.  The prediction is the base profile's decode-step rate,
``batch * 1000 / latency_ms``, while the engine reports finished requests
per second; the correction carries that difference as it comes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.profiles import PerfProfile


class MeasuredProfile(PerfProfile):
    def __init__(self, base: PerfProfile, ewma: float = 0.3):
        self.base = base
        self.ewma = ewma
        self._scale: Dict[Tuple[str, int], float] = {}

    # -- PerfProfile surface ---------------------------------------------------
    def services(self) -> List[str]:
        return self.base.services()

    def sizes(self) -> Sequence[int]:
        return self.base.sizes()

    def latency_ms(self, model: str, size: int, batch: int) -> float:
        lat = self.base.latency_ms(model, size, batch)
        s = self._scale.get((model, size), 1.0)
        # throughput scale s <=> service rate scale s <=> latency / s
        return lat / s if math.isfinite(lat) else lat

    # -- production feedback -----------------------------------------------------
    def predicted(self, model: str, size: int, batch: int) -> float:
        """The base profile's req/s at ``batch``, which :meth:`observe`
        compares a measurement with (0 where the model does not fit)."""
        base_lat = self.base.latency_ms(model, size, batch)
        return batch * 1000.0 / base_lat if math.isfinite(base_lat) else 0.0

    def observe(
        self, model: str, size: int, batch: int, measured_tput: float
    ) -> None:
        """Feed one measurement: sustained req/s at the given batch."""
        predicted = self.predicted(model, size, batch)
        if predicted <= 0 or measured_tput <= 0:
            return
        ratio = measured_tput / predicted
        key = (model, size)
        old = self._scale.get(key, 1.0)
        self._scale[key] = (1 - self.ewma) * old + self.ewma * ratio

    def correction(self, model: str, size: int) -> float:
        return self._scale.get((model, size), 1.0)
