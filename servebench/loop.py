"""The loop the measured window drives: ``Engine.admit`` and ``Engine.step``
under a traffic schedule, every request stamped on the host clock.

Policy, as the engine's own closed loop has it: each pass admits every
request that is due, first come first served, while a slot is free, then
runs one decode step of all live slots.  Open loop: requests fall due on
the schedule whether or not earlier ones are served.  Closed loop: each
of ``clients`` sends its next request the moment its last one finishes.
A request's times are its due time, the start of its admission, and the
host time at which each of its tokens came back (the first from the
admission, the others from steps; both return once the device is done).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from servebench import traffic


@dataclasses.dataclass(eq=False)
class Record:
    index: int
    due: float
    prompt_len: int
    out_len: int
    prompt: object = None  # np.ndarray of ids
    client: int = -1
    admit_start: float = math.nan
    first: float = math.nan
    finished: float = math.nan
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: str = ""
    req: object = None  # the engine's Request


@dataclasses.dataclass
class Call:
    """One admission or decode step: host start and end, the contexts it
    served (admission: the prompt length; step: each live slot's context
    with the new token), and whether the profiler was on."""
    start: float
    end: float
    lens: Tuple[int, ...]
    traced: bool
    label: str = ""


class Loop:
    def __init__(self, engine, workload: Dict, seed: int, vocab: int,
                 clock: Callable[[], float] = time.perf_counter,
                 arrivals: Optional[Dict] = None, tracer=None):
        from repro_torch.serving.engine import Request
        from repro_torch.serving.paged_cache import OutOfPages

        self.engine, self.Request, self.OutOfPages = engine, Request, OutOfPages
        self.workload, self.seed, self.vocab = workload, seed, vocab
        self.clock, self.arrivals, self.tracer = clock, arrivals, tracer
        self.records: List[Record] = []
        self.admits: List[Call] = []
        self.steps: List[Call] = []
        self._live: Dict[int, Record] = {}
        self._pending: Deque[Record] = deque()
        self._lengths = None

    # -- traffic ---------------------------------------------------------------
    def _new(self, due: float, prompt_len: int, out_len: int, client: int = -1) -> Record:
        i = len(self.records)
        rec = Record(i, due, prompt_len, out_len, client=client,
                     prompt=traffic.prompt_tokens(self.seed, i, prompt_len, self.vocab))
        self.records.append(rec)
        return rec

    def _send(self, due: float, client: int) -> None:
        p, o = self._lengths[len(self.records)]
        self._pending.append(self._new(due, p, o, client))

    # -- the loop ----------------------------------------------------------------
    def run(self, t_start: float, t_end: float) -> None:
        """Serve from ``t_start`` (the schedule's zero) until ``t_end``."""
        w = self.workload
        future: Deque[Record] = deque()
        if w["loop"] == "open":
            for off, p, o in traffic.open_schedule(w, self.seed, t_end - t_start, self.arrivals):
                future.append(self._new(t_start + float(off), p, o))
        elif w["loop"] == "closed":
            self._lengths = traffic.Lengths(w, self.seed, w["block"])
            for c in range(w["clients"]):
                self._send(t_start, c)
        else:
            raise ValueError(f"unknown loop {w['loop']!r}")
        eng = self.engine
        while True:
            now = self.clock()
            if self.tracer is not None:
                self.tracer.tick(now)
            if now >= t_end:
                break
            while future and future[0].due <= now:
                self._pending.append(future.popleft())
            while self._pending and eng.has_free_slot() and self.clock() < t_end:
                if not self._admit(self._pending[0]):
                    break
                self._pending.popleft()
            if eng.num_live:
                self._step()
            elif not self._pending:
                nxt = future[0].due if future else t_end
                time.sleep(max(0.0, min(nxt, t_end) - self.clock()))
        if self.tracer is not None:
            self.tracer.close()

    def _span(self, label: str):
        return self.tracer.span(label) if self.tracer is not None else contextlib.nullcontext()

    def _traced(self) -> bool:
        return self.tracer is not None and self.tracer.active

    def _admit(self, rec: Record) -> bool:
        """Admit ``rec``; False if the page pool refused it (it stays queued)."""
        if rec.req is None:
            rec.req = self.Request(rid=rec.index, prompt=rec.prompt, max_new_tokens=rec.out_len)
        label = f"sb.admit.{len(self.admits)}"
        t0 = self.clock()
        try:
            with self._span(label):
                self.engine.admit(rec.req)
        except self.OutOfPages:
            return False
        except Exception as e:  # a failed request: counted, the loop serves on
            rec.error = f"{type(e).__name__}: {e}"
            return True
        t1 = self.clock()
        if math.isnan(rec.admit_start):
            rec.admit_start, rec.first = t0, t1
            rec.times.append(t1)
        self.admits.append(Call(t0, t1, (rec.prompt_len,), self._traced(), label))
        if rec.req.done:  # served whole by its admission
            self._finish(rec, t1)
        else:
            self._live[rec.index] = rec
        return True

    def _step(self) -> None:
        live = list(self._live.values())
        lens = tuple(r.prompt_len + len(r.times) for r in live)
        label = f"sb.step.{len(self.steps)}"
        t0 = self.clock()
        with self._span(label):
            finished = self.engine.step()
        t1 = self.clock()
        self.steps.append(Call(t0, t1, lens, self._traced(), label))
        done = {r.rid for r in finished}
        back = {r.rid for r in self.engine.take_preempted()}
        for rec in live:
            if rec.index in back:
                self._live.pop(rec.index)
                self._pending.appendleft(rec)
                continue
            rec.times.append(t1)
        for rid in done:
            rec = self._live.pop(rid, None)
            if rec is not None:
                self._finish(rec, t1)

    def _finish(self, rec: Record, t: float) -> None:
        rec.finished, rec.tokens = t, list(rec.req.out_tokens)
        if rec.client >= 0:
            self._send(t, rec.client)
