"""Counter/gauge/histogram registry with deterministic snapshots.

Naming convention (the docs and the serve CLI's ``--stats-json`` follow
it): ``subsystem.metric`` in lowercase, dot-separated — e.g.
``serving.preemptions``, ``pages.used``, ``reconcile.retried``,
``queue.depth.critical``.  Time-valued metrics carry an ``_s`` suffix
(sim seconds — this module never reads wall clock; like
:mod:`repro_torch.obs.trace` it does not import :mod:`time`).

Three metric kinds:

* :class:`Counter` — monotone total; ``inc(v)`` adds, ``inc_to(total)``
  advances to an externally-tracked cumulative value (handy when the
  instrumented subsystem already keeps running totals).
* :class:`Gauge` — last-set value (``set(v)``).
* :class:`Histogram` — fixed exponential bounds, ``observe(v)`` buckets it.

:meth:`MetricsRegistry.sample` snapshots every counter and gauge at a sim
time, building the per-bin series the ``SimReport.obs`` block serializes.
Metrics created after sampling started are back-filled with zeros, so all
series stay aligned.  :meth:`snapshot` returns a sorted, JSON-ready dict —
same call sequence, byte-identical serialization.

The port's copy of the JAX package's ``obs/metrics.py``, op for op (the
serve CLI's ``--stats-json`` uses :func:`percentile_summary`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# percentiles the summaries report, shared with the sim's latency block and
# the serve CLI's --stats-json (keys like "ttft_p50_s")
PCTS = (50.0, 95.0, 99.0)

# default histogram bucket upper bounds (seconds-flavored exponential grid;
# the final +inf bucket is implicit)
_DEFAULT_BOUNDS = (0.01, 0.1, 1.0, 10.0, 100.0, 1000.0)


def percentile_summary(
    vals: Sequence[float], prefix: str, pcts: Sequence[float] = PCTS
) -> Dict[str, float]:
    """``{prefix}_p{P}_s`` percentile keys over ``vals`` (0.0 when empty) —
    the schema shared by the simulator's latency block, the ``obs`` metrics
    block, and the real engine's ``--stats-json``."""
    if not vals:
        return {f"{prefix}_p{int(p)}_s": 0.0 for p in pcts}
    a = np.asarray(vals, dtype=np.float64)
    return {f"{prefix}_p{int(p)}_s": float(np.percentile(a, p)) for p in pcts}


class Counter:
    """Monotone running total."""

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v

    def inc_to(self, total: float) -> None:
        """Advance to an externally-tracked cumulative ``total``."""
        if total < self.value - 1e-9:
            raise ValueError(
                f"counter cannot move backwards: {self.value} -> {total}"
            )
        self.value = max(self.value, float(total))


class Gauge:
    """Last-set value."""

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound bucket counts plus running sum/count."""

    def __init__(self, bounds: Sequence[float] = _DEFAULT_BOUNDS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)  # trailing +inf bucket
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        i = int(np.searchsorted(self.bounds, v, side="left"))
        self.buckets[i] += 1
        self.count += 1
        self.total += float(v)


class _NullMetric:
    """Accepts every metric-mutation call and does nothing."""

    def inc(self, v: float = 1.0) -> None:
        pass

    def inc_to(self, total: float) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


class NullRegistry:
    """No-op twin of :class:`MetricsRegistry` (observability off)."""

    enabled = False
    _NULL = _NullMetric()

    def counter(self, name: str) -> _NullMetric:
        return self._NULL

    def gauge(self, name: str) -> _NullMetric:
        return self._NULL

    def histogram(self, name: str) -> _NullMetric:
        return self._NULL

    def sample(self, t_s: float) -> None:
        pass

    def snapshot(self) -> Dict:
        return {}


class MetricsRegistry:
    """Get-or-create metric registry with per-bin sampled series."""

    enabled = True

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sample_t: List[float] = []
        self._series: Dict[str, List[float]] = {}  # "counter:x" / "gauge:x"

    def _get(self, table: Dict, name: str, make, kind: str):
        m = table.get(name)
        if m is None:
            for other_kind, other in (
                ("counter", self._counters),
                ("gauge", self._gauges),
                ("histogram", self._histograms),
            ):
                if kind != other_kind and name in other:
                    raise ValueError(
                        f"metric {name!r} already registered as a {other_kind}"
                    )
            m = table[name] = make()
            if kind in ("counter", "gauge"):
                # back-fill so every series spans all samples taken so far
                self._series[f"{kind}:{name}"] = [0.0] * len(self._sample_t)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge, "gauge")

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get(
            self._histograms,
            name,
            (lambda: Histogram(bounds)) if bounds else Histogram,
            "histogram",
        )

    # -- sampling ----------------------------------------------------------------
    def sample(self, t_s: float) -> None:
        """Record every counter's and gauge's current value at sim ``t_s``
        (the simulator calls this once per traffic bin)."""
        self._sample_t.append(float(t_s))
        for name, c in self._counters.items():
            self._series[f"counter:{name}"].append(c.value)
        for name, g in self._gauges.items():
            self._series[f"gauge:{name}"].append(g.value)

    # -- export ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Sorted JSON-ready dict: final values plus the sampled series."""
        return {
            "counters": {
                name: c.value for name, c in sorted(self._counters.items())
            },
            "gauges": {
                name: g.value for name, g in sorted(self._gauges.items())
            },
            "histograms": {
                name: {
                    "bounds": list(h.bounds),
                    "buckets": list(h.buckets),
                    "count": h.count,
                    "total": h.total,
                }
                for name, h in sorted(self._histograms.items())
            },
            "series": {
                "t_s": list(self._sample_t),
                "counters": {
                    name: self._series[f"counter:{name}"]
                    for name in sorted(self._counters)
                },
                "gauges": {
                    name: self._series[f"gauge:{name}"]
                    for name in sorted(self._gauges)
                },
            },
        }
