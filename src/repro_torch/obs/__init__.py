"""Flight-recorder observability: sim-time tracing, metrics, lifecycles.

numpy-only, free of torch and jax (the same import contract as
``repro_torch.core`` / ``repro_torch.sim``; ``tests/test_torch_static.py``
holds it), and strictly *sim-time*: nothing in here reads wall clock, so enabling
observability can never perturb the deterministic report bytes it watches.

Three layers, bundled by :class:`Observability`:

* :mod:`repro_torch.obs.trace` — :class:`SpanTracer`: sim-time spans on named
  tracks, exported as Chrome trace-event JSON (open in Perfetto).
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry`: counters, gauges,
  histograms, sampled per traffic bin into deterministic series.
* :mod:`repro_torch.obs.flight` — :class:`FlightRecorder`: bounded per-request
  lifecycle records for the token serving model.

Everything defaults to the null implementations (``Observability.off()``),
so the instrumented code paths cost one attribute check when
observability is off, and the report bytes stay those of a run without
it.  See ``docs/OBSERVABILITY.md``.

The port's copy of the JAX package's ``obs`` package, op for op: same call
sequence, same snapshot dicts and trace bytes as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    percentile_summary,
)
from repro_torch.obs.trace import NullTracer, SpanTracer

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NullTracer",
    "Observability",
    "SpanTracer",
    "percentile_summary",
]


@dataclasses.dataclass
class Observability:
    """The bundle the simulator threads through its layers."""

    enabled: bool
    tracer: Union[SpanTracer, NullTracer]
    metrics: Union[MetricsRegistry, NullRegistry]
    flight: Optional[FlightRecorder]

    @classmethod
    def off(cls) -> "Observability":
        """Null everything — the zero-cost default."""
        return cls(False, NullTracer(), NullRegistry(), None)

    @classmethod
    def on(cls, record_limit: int = 256) -> "Observability":
        return cls(
            True, SpanTracer(), MetricsRegistry(), FlightRecorder(record_limit)
        )
