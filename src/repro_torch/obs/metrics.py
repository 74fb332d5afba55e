"""Percentile summaries in the metrics schema of the JAX package's
``obs/metrics.py`` (keys like ``ttft_p50_s``), copied so that the serve
CLI's ``--stats-json`` reads like the reference's and the simulator's."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# percentiles the summaries report (keys like "ttft_p50_s")
PCTS = (50.0, 95.0, 99.0)


def percentile_summary(
    vals: Sequence[float], prefix: str, pcts: Sequence[float] = PCTS
) -> Dict[str, float]:
    """``{prefix}_p{P}_s`` percentile keys over ``vals`` (0.0 when empty)."""
    if not vals:
        return {f"{prefix}_p{int(p)}_s": 0.0 for p in pcts}
    a = np.asarray(vals, dtype=np.float64)
    return {f"{prefix}_p{int(p)}_s": float(np.percentile(a, p)) for p in pcts}
