"""The card's idle time split by the program's own spans.

The port names its host work for a torch profiler
(``repro_torch.kernels.ops.span``): ``engine.admit`` and ``engine.step``
around each call, with their phases ``.prepare``, ``.model``, ``.sync``
and ``.sample`` inside, and ``model.*`` ranges inside the model calls.
The parser keeps these ranges' host sides among the loop thread's host
ops (``TraceData.cpu_ops``), on the profiler's clock, the clock of the
device operations.  Here the device's idle intervals (the traced slice
less the union of its operations) are intersected exactly with the union
of the named spans' intervals.  A trace of a program without such spans
reads None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from servebench.profiling import Interval, TraceData

CALLS = ("engine.admit", "engine.step")
MODEL_CALLS = ("engine.admit.model", "engine.step.model")


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """``a`` less ``b``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def idle(t: TraceData) -> List[Interval]:
    """The traced slice's intervals in which no device operation ran."""
    return subtract([t.window], t.busy())


def host(t: TraceData, names: Iterable[str]) -> List[Interval]:
    """Union of the host intervals of the spans named ``names``, clipped
    to the traced slice."""
    names = frozenset(names)
    return intersect(union((s, e) for s, e, n in t.cpu_ops if n in names), [t.window])


def share(t: TraceData, intervals: List[Interval]) -> float:
    """The intervals' length as a % of the traced slice."""
    a, b = t.window
    return 100.0 * sum(e - s for s, e in intervals) / (b - a)


def idle_share(t: Optional[TraceData], inside: Iterable[str],
               outside: Iterable[str] = ()) -> Optional[float]:
    """% of the traced slice in which the device is idle while the host is
    inside a span named in ``inside`` and in none named in ``outside``;
    None where the trace holds no device operation or no span named in
    ``inside``."""
    if t is None or not t.ops:
        return None
    spans = host(t, inside)
    if not spans:
        return None
    return share(t, intersect(idle(t), subtract(spans, host(t, outside))))
