"""Discrete-event machinery: a simulation clock and a deterministic queue.

Events fire in (time, sequence-number) order, so two events scheduled for
the same instant pop in the order they were pushed — the tie-break that
keeps a simulation run reproducible regardless of heap internals.

The port's copy of the JAX package's ``sim/events.py``, op for op.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Iterator, Optional

# Event kinds used by the cluster simulator.
BIN_TICK = "bin_tick"  # process one traffic bin
REOPTIMIZE = "reoptimize"  # periodic observe -> optimize -> transition
TRANSITION_DONE = "transition_done"  # a controller transition finished
FAULT = "fault"  # an injected device fault fires (repro_torch.controlplane)
RECONCILE = "reconcile"  # the control plane reacts to observed divergence
END = "end"  # end of trace


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False, default=None)


class EventQueue:
    """Min-heap of events with deterministic FIFO tie-breaking."""

    def __init__(self) -> None:
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str, payload: Any = None) -> Event:
        ev = Event(time, next(self._seq), kind, payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()


class Clock:
    """Monotone simulation clock; advancing backwards is a bug."""

    def __init__(self, t0: float = 0.0) -> None:
        self.now = t0

    def advance_to(self, t: float) -> float:
        # a real exception, not an assert: this invariant must hold even
        # under ``python -O``, where asserts are compiled away
        if t < self.now - 1e-9:
            raise RuntimeError(f"clock moved backwards: {self.now} -> {t}")
        self.now = max(self.now, t)
        return self.now
