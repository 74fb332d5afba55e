"""Arithmetic over a run's stamps, shared by the metric readers.

The window is ``[t0, t1)`` on the host clock; the host-clock per-layer
metrics take ``window=quiet(run)``, the part before a profiler started.  A request belongs to it
when it falls due inside it.  A token belongs to it when it came back
inside it; a gap between two tokens of one request belongs to it when its
second token does.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """numpy's linear percentile; nan for no values."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else math.nan


def quiet(run):
    """The window up to the profiler's start (all of it in an untraced run)."""
    return run.quiet or run.window


def due_in_window(run, window=None) -> List:
    t0, t1 = window or run.window
    return [r for r in run.records if t0 <= r.due < t1]


def ttfts(run, window=None) -> List[float]:
    """Time to first token from the due time of each request due in the
    window; one still without a first token at the close counts at its wait."""
    t1 = (window or run.window)[1]
    return [(r.first if r.first < t1 else t1) - r.due for r in due_in_window(run, window)]


def queue_waits(run, window=None) -> List[float]:
    """Due time to the start of admission, for each request due in the
    window; one not admitted by the close counts at its wait."""
    t1 = (window or run.window)[1]
    return [(r.admit_start if r.admit_start < t1 else t1) - r.due
            for r in due_in_window(run, window)]


def gaps(run, window=None) -> List[float]:
    """Every gap between consecutive tokens of one request whose second
    token came back in the window."""
    t0, t1 = window or run.window
    out = []
    for r in run.records:
        ts = r.times
        out += [b - a for a, b in zip(ts, ts[1:]) if t0 <= b < t1]
    return out


def tokens_in_window(run) -> int:
    t0, t1 = run.window
    return sum(1 for r in run.records for t in r.times if t0 <= t < t1)


def calls_in_window(run, calls, window=None) -> List:
    """The admissions or steps that started and ended inside the window."""
    t0, t1 = window or run.window
    return [c for c in calls if c.start >= t0 and c.end <= t1]
