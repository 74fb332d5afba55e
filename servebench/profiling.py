"""The traced slice of a ``--trace 1`` run: torch.profiler over the last
``trace_s`` seconds of the window, read back from its raw event list.
The profiler starts inside the window and stops once it has closed, so
that neither stopping it nor reading its events stalls the served
traffic.

The serving loop wraps every admission and decode step in a ``record_function``
range named ``sb.admit.<n>`` / ``sb.step.<n>``, and the whole slice in
``sb.trace``.  The profiler gives each range a device side too, from its
first kernel to the end of its last; kernels are placed in a step by that
device side, since the profiler's mapping of the card's clock onto the
host's is loose.  Parsing reads ``kineto_results.events()`` directly: the
profiler's own event tree is far slower to build at some hundred thousand
launches a second.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]  # ns


@dataclasses.dataclass
class TraceData:
    window: Interval  # the sb.trace range on the host side
    ops: List[Tuple[str, int, int]]  # device operations: (name, start, end)
    device_ranges: Dict[str, Interval]  # sb.* ranges' device sides
    host_ranges: Dict[str, Interval]  # sb.* ranges' host sides
    cpu_ops: List[Tuple[int, int, str]]  # the loop thread's host ops: (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals inside the window."""
        a, b = self.window
        spans = sorted((max(s, a), min(e, b)) for _, s, e in self.ops if e > a and s < b)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def device_s(self, fragments) -> float:
        """Device seconds of the operations whose name holds a fragment."""
        return sum(e - s for n, s, e in self.ops if any(f in n for f in fragments)) / 1e9

    def ops_in(self, label: str) -> Optional[List[Tuple[str, int, int]]]:
        """The operations that start inside range ``label``'s device side."""
        if label not in self.device_ranges:
            return None
        a, b = self.device_ranges[label]
        return [o for o in self.ops if a <= o[1] <= b]


class Tracer:
    """Starts the profiler when the loop's clock reaches ``start``;
    :meth:`close` stops it; ``span`` is a range while it runs."""

    def __init__(self, start: float, cuda: bool):
        self.start, self.cuda = start, cuda
        self.active = False
        self._prof = self._window = None
        self.data: Optional[TraceData] = None
        self.parse_s = 0.0

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start sets
        up CUPTI for several seconds, which would otherwise eat the slice."""
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            (torch.ones(8, device="cuda" if self.cuda else "cpu") + 1).sum().item()

    def tick(self, now: float) -> None:
        if self._prof is None and self.data is None and now >= self.start:
            from torch.autograd.profiler import record_function
            from torch.profiler import profile

            self._prof = profile(activities=self._activities())
            self._prof.__enter__()
            self._window = record_function("sb.trace")
            self._window.__enter__()
            self.active = True

    def span(self, label: str):
        from torch.autograd.profiler import record_function

        return record_function(label) if self.active else contextlib.nullcontext()

    def close(self) -> None:
        if not self.active:
            return
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        t = time.perf_counter()
        self.data = parse(self._prof)
        self.parse_s = time.perf_counter() - t
        self._prof = None


def _events(prof):
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        return res.events()
    raise RuntimeError("the profiler kept no kineto results")


def parse(prof) -> TraceData:
    from torch.autograd import DeviceType

    ops, dev, host, cpu = [], {}, {}, []
    thread = None
    raw = list(_events(prof))
    for e in raw:
        name = e.name()
        if name == "sb.trace" and e.device_type() == DeviceType.CPU:
            thread = e.start_thread_id()
    window = None
    for e in raw:
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        annot = e.is_user_annotation() if hasattr(e, "is_user_annotation") else name.startswith("sb.")
        if e.device_type() == DeviceType.CUDA:
            if annot or name.startswith("sb."):
                if name.startswith("sb."):
                    a, b = dev.get(name, (s, t))
                    dev[name] = (min(a, s), max(b, t))
            else:
                ops.append((name, s, t))
        elif name == "sb.trace":
            window = (s, t)
        elif name.startswith("sb."):
            host[name] = (s, t)
        elif thread is None or e.start_thread_id() == thread:
            cpu.append((s, t, name))
    if window is None:
        raise RuntimeError("the trace holds no sb.trace range")
    ops.sort(key=lambda o: o[1])
    cpu.sort()
    return TraceData(window, ops, dev, host, cpu)


def top_ops(data: TraceData, n: int = 10) -> List[List]:
    """The ``n`` device operations that took most time: [name, seconds]."""
    tot: Dict[str, int] = defaultdict(int)
    for name, s, e in data.ops:
        tot[name[:160]] += e - s
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(data: TraceData, n: int = 10) -> List[List]:
    """Idle device time by what the host was doing: each gap between
    device operations is put under the loop's range (admit, step, or
    none) and the innermost host op at its middle; [label, seconds],
    the ``n`` largest."""
    busy = data.busy()
    a, b = data.window
    edges = [a] + [x for iv in busy for x in iv] + [b]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    ranges = sorted((s, e, k.split(".")[1]) for k, (s, e) in data.host_ranges.items())
    rstarts = [r[0] for r in ranges]
    starts = [c[0] for c in data.cpu_ops]
    tot: Dict[str, int] = defaultdict(int)
    for s, e in gaps:
        m = (s + e) // 2
        i = bisect.bisect_right(rstarts, m) - 1
        where = ranges[i][2] if i >= 0 and ranges[i][1] >= m else "loop"
        j = bisect.bisect_right(starts, m) - 1
        inner = "python"
        # the innermost op holding m: the latest-starting one that still runs
        for k in range(j, max(-1, j - 64), -1):
            if data.cpu_ops[k][1] >= m:
                inner = data.cpu_ops[k][2]
                break
        tot[f"{where}: {inner[:100]}"] += e - s
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
