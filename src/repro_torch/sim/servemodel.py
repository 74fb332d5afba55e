"""Token-level serving model: a discrete, numpy-only twin of the Engine.

The simulator's fluid bin model (the JAX package's ``sim/simulator.py``)
serves at profile rates — it cannot represent queueing delay, TTFT/TPOT
latency, preemption storms, or
KV-pressure collapse, exactly the effects the paper's SLO story (§7 "largest
batch size possible, as far as the inference latency is smaller than what
required by SLOs", §8.3 measured-profile feedback) hinges on.  This module
is the drop-in alternative (``SimConfig.serving_model = "token"``): every
request is a discrete object with a per-token clock, and every simulated
instance is an :class:`InstanceModel` that mirrors the real
:class:`repro_torch.serving.engine.Engine` state machine —

  * a fixed number of batch *slots* (the §7 rule: the profile's best
    SLO-compliant batch),
  * paged-KV accounting through the *same* :class:`PagePool` /
    :func:`page_bytes` math the engine uses (a slice's HBM budget maps to
    ``num_pages``),
  * admission = reserve ``context + 1`` page-tokens, pay a prefill charge,
    emit the first output token (the engine samples it from the prefill
    logits); :class:`OutOfPages` *refuses* admission,
  * decode = one step advances every live slot by one token; a slot that
    cannot grow its pages mid-decode is *preempted* — pages released,
    request resumed later with its generated tokens folded into the context,
  * per-token step time comes from the profile:
    ``latency_ms(svc, size, b) / 1000 / profiled_decode_tokens`` — the
    profile's request latency at batch ``b`` is the time to decode the
    *profiled* token budget at that occupancy, so when the workload's drawn
    budgets match the profiled one, a full batch sustains the profile's
    throughput (and when they are longer, capacity falls short of the
    planner's rate math — the fidelity gap the fluid model hides).  Running
    the simulation on a
    :class:`repro_torch.core.online_profiles.MeasuredProfile` (fed by the real
    engine's ``run_closed_loop(measured=...)`` §8.3 loop) calibrates the
    per-token rates to *measured* throughput.

Everything is numpy-only (``repro_torch.sim`` imports neither torch nor jax) and
seed-deterministic: request shapes are drawn from the simulator's single
seeded rng, instances advance in sorted-uid order, and queues are FIFO with
preempted requests resumed first — same seed, byte-identical
:meth:`repro_torch.sim.report.SimReport.to_json`.

Overload resilience: when a :class:`repro_torch.sim.traffic.PriorityMix`
is active, requests carry a priority class and an SLO deadline, and the
model switches to the resilience path — per-class FIFO queues admitted
class-major (critical first, FIFO within class, preempted-resume-first
preserved), deadline-expired queued requests dropped instead of served
uselessly (goodput, not throughput), ``OutOfPages`` mid-decode growth
evicting the lowest-class/shortest victim instead of always preempting
self, and refused/crash-spilled requests retrying with capped exponential
backoff under a retry budget.  Without a mix, every request is standard
class with an infinite deadline and the legacy code paths run untouched —
the no-priority token reports stay byte-identical.

The port's copy of the JAX package's ``sim/servemodel.py``, op for op, on
the port's :class:`PagePool` and :func:`page_bytes`: the same call
sequences give the reference's metrics and summaries.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import percentile_summary
from repro_torch.serving.paged_cache import OutOfPages, PagePool, page_bytes
from repro_torch.sim.traffic import PRIORITY_CLASSES, STANDARD_CLASS, PriorityMix

# uid -> (service, size, throughput); mirrors the reoptimize driver's InstanceSet
InstanceSet = Dict[int, Tuple[str, int, float]]

# how many queued requests one admission pass may scan past a refusal: the
# engine's run_closed_loop scans its whole pending list (first-fit), but a
# simulated flash crowd can queue thousands of requests per instance — a
# bounded head-of-line window keeps the per-step cost O(slots)
ADMIT_SCAN = 4

# percentiles the latency summaries report (p50/p95/p99)
_PCTS = (50.0, 95.0, 99.0)


@dataclasses.dataclass
class TokenRequest:
    """One discrete request moving through the token-level model."""

    rid: int
    service: str
    arrival_s: float
    prompt_tokens: int
    decode_tokens: int  # output-token budget
    generated: int = 0  # survives preemption (engine folds them into ctx)
    admit_s: float = -1.0  # first successful admission
    first_token_s: float = -1.0
    finish_s: float = -1.0
    preemptions: int = 0
    priority: int = STANDARD_CLASS  # index into PRIORITY_CLASSES (0 = top)
    deadline_s: float = math.inf  # absolute SLO deadline; inf = deadline-less
    retries: int = 0  # backoff retries consumed (refusals + crash spills)
    next_try_s: float = 0.0  # not admittable before this clock (backoff)

    @property
    def context_len(self) -> int:
        return self.prompt_tokens + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.decode_tokens


@dataclasses.dataclass
class TokenKnobs:
    """Shape of the modeled requests and of the per-instance KV budget.

    The KV geometry (heads / head_dim / layers / page size) feeds the same
    :func:`page_bytes` math the engine's ``page_hbm_bytes`` uses, so an
    instance of MIG size ``s`` gets ``s * hbm_gb_per_unit`` GB of page pool.
    Defaults are sized so a flash crowd actually produces KV pressure
    (refusals/preemptions) at the curated ``micro`` scenario scale.

    Fields, by group:

    * request shape — ``prompt_tokens`` / ``decode_tokens`` are *means*;
      each request draws uniformly in ``[1, 2*mean)`` from the simulator's
      seeded rng.  ``max_len`` caps context like ``Engine.max_len``;
      ``prefill_chunk`` is prompt tokens prefilled per step-equivalent.
    * ``profiled_decode_tokens`` — the single most consequential knob: the
      decode budget the *profile's* latency numbers assumed.  Per-token
      step time is ``latency_ms(svc, size, b) / 1000 /
      profiled_decode_tokens``, so when drawn budgets exceed it, requests
      outlive the profiled request latency and real capacity falls short
      of the planner's rate math — the fidelity gap the token model exists
      to show (the curated token slice sets drawn budgets to 4x the
      profiled one).  ``None`` means "profile matches the workload".
    * KV budget — ``page_size`` / ``kv_heads`` / ``head_dim`` /
      ``n_layers`` / ``hbm_gb_per_unit`` determine ``num_pages(size)``.
    * retry policy (``retry_*``) — capped exponential backoff for refused /
      crash-spilled requests; consulted only when a
      :class:`repro_torch.sim.traffic.PriorityMix` is active.  A ``PriorityMix``
      assigns each request a priority class (by traffic ``weights``) and an
      absolute SLO deadline (``deadline_s`` per class, ``inf`` =
      deadline-less batch); admission is class-major, expiries are dropped
      for goodput, and KV-pressure eviction targets the lowest class first.
    """

    prompt_tokens: int = 24  # mean prompt length (uniform in [1, 2*mean))
    decode_tokens: int = 16  # mean output budget (uniform in [1, 2*mean))
    # decode budget the profile's latency numbers assumed: per-token step
    # time is latency_ms / 1000 / profiled_decode_tokens.  When the drawn
    # budgets (decode_tokens) exceed this, requests take longer than the
    # profile's request latency and real capacity falls short of the
    # planner's rate math — the fidelity gap the token model exists to show.
    # None -> equal to decode_tokens (profile matches the workload).
    profiled_decode_tokens: Optional[int] = None
    max_len: int = 96  # context cap, like Engine.max_len
    page_size: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    n_layers: int = 32
    hbm_gb_per_unit: float = 0.020  # page-pool GB per MIG size unit
    prefill_chunk: int = 32  # prompt tokens prefilled per step-equivalent
    # refused / crash-spilled requests retry with capped exponential backoff:
    # attempt k waits min(retry_base_s * retry_mult**(k-1), retry_cap_s); a
    # request past retry_budget attempts is dropped (counted retry_dropped).
    # Only consulted when a priority mix is active (the resilience path).
    retry_budget: int = 4
    retry_base_s: float = 0.25
    retry_mult: float = 2.0
    retry_cap_s: float = 4.0

    def retry_backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), capped exponential."""
        return min(
            self.retry_base_s * self.retry_mult ** max(attempt - 1, 0),
            self.retry_cap_s,
        )

    def num_pages(self, size: int) -> int:
        """A slice's HBM budget -> page count (engine's page_hbm_bytes math),
        floored so one max-context request always fits (no livelock)."""
        per_page = page_bytes(
            self.page_size, self.kv_heads, self.head_dim, self.n_layers
        )
        budget = int(size * self.hbm_gb_per_unit * 2**30)
        return max(budget // per_page, self.max_pages_per_req)

    @property
    def step_decode_tokens(self) -> int:
        """Decode budget behind the profile's latency numbers (the per-token
        step-time denominator)."""
        if self.profiled_decode_tokens is not None:
            return self.profiled_decode_tokens
        return self.decode_tokens

    @property
    def max_pages_per_req(self) -> int:
        # context cap + the one-ahead decode write the engine reserves
        return -(-(self.max_len + 1) // self.page_size)


class InstanceModel:
    """Twin of one Engine: slots + page pool + a per-token clock.

    ``step_time_s(b)`` is the seconds one ragged decode step takes with
    ``b`` live slots; admission charges ``ceil(context / prefill_chunk)``
    step-equivalents serially (the engine's jit'd batch-1 prefill blocks the
    decode loop the same way).
    """

    def __init__(
        self,
        uid: int,
        service: str,
        size: int,
        slots: int,
        knobs: TokenKnobs,
        step_time_s: Callable[[int], float],
        now: float,
        resilience: bool = False,
    ):
        self.uid = uid
        self.service = service
        self.size = size
        self.slots = max(int(slots), 1)
        self.knobs = knobs
        self.step_time_s = step_time_s
        self.clock = now
        self.resilience = resilience
        self.pool = PagePool(
            knobs.num_pages(size), knobs.page_size, knobs.max_pages_per_req
        )
        self.live: List[TokenRequest] = []
        # one FIFO per priority class; preempted requests resume first
        # within their class.  Without a mix every request is standard
        # class, so queues[STANDARD_CLASS] is the legacy single queue.
        self.queues: List[List[TokenRequest]] = [
            [] for _ in PRIORITY_CLASSES
        ]
        # (ready_s, seq, req) min-heap of backed-off refused/spilled requests
        self.backoff: List[Tuple[float, int, TokenRequest]] = []
        self._seq = 0

    @property
    def queue(self) -> List[TokenRequest]:
        """Legacy view: the standard-class FIFO (the only populated queue
        when no priority mix is active)."""
        return self.queues[STANDARD_CLASS]

    def enqueue(self, req: TokenRequest) -> None:
        self.queues[req.priority].append(req)

    # -- admission (mirrors Engine.admit) -------------------------------------
    def _try_admit(self, req: TokenRequest, metrics: "TokenMetrics") -> bool:
        L = req.context_len
        self.pool.admit(req.rid)
        try:
            # context + room for the first decode write, like the engine
            self.pool.append_tokens(req.rid, L + 1)
        except OutOfPages:
            self.pool.release(req.rid)
            metrics.refusals[req.service] += 1
            if metrics.recorder is not None:
                metrics.recorder.note(
                    req.rid, "refused", self.clock, uid=self.uid
                )
            return False
        if metrics.recorder is not None:
            metrics.recorder.note(
                req.rid,
                "resumed" if req.admit_s >= 0.0 else "admitted",
                self.clock,
                uid=self.uid,
            )
        if req.admit_s < 0.0:
            req.admit_s = self.clock
            metrics.queue_delay_s[req.service].append(
                self.clock - req.arrival_s
            )
        # serialized prefill charge, then the first token from its logits
        steps = -(-max(L, 1) // self.knobs.prefill_chunk)
        self.clock += steps * self.step_time_s(len(self.live) + 1)
        req.generated += 1
        if req.first_token_s < 0.0:
            req.first_token_s = self.clock
            metrics.ttft_s[req.service].append(self.clock - req.arrival_s)
            if metrics.recorder is not None:
                metrics.recorder.note(req.rid, "first_token", self.clock)
        if req.done or req.context_len >= self.knobs.max_len:
            self._finish(req, metrics)
        else:
            self.live.append(req)
        return True

    def _admit_pass(self, metrics: "TokenMetrics") -> None:
        """First-fit over the arrived head of the queue (bounded scan), like
        the engine's run_closed_loop: a request the pool cannot hold must
        not head-of-line block admittable requests right behind it."""
        scanned = 0
        i = 0
        while i < len(self.queue) and len(self.live) < self.slots:
            req = self.queue[i]
            if req.arrival_s > self.clock + 1e-12 or scanned >= ADMIT_SCAN:
                break
            if self._try_admit(req, metrics):
                self.queue.pop(i)
            else:
                scanned += 1
                i += 1

    def _admit_pass_priority(self, metrics: "TokenMetrics") -> None:
        """Resilience-path admission: class-major (higher class first), FIFO
        within class, preempted-resume-first preserved (preempted requests
        sit at their class's head).  Deadline-expired queued requests are
        dropped instead of served uselessly, and an ``OutOfPages`` refusal
        backs the request off with capped exponential backoff instead of
        letting it spin at the queue head every step."""
        # backed-off requests whose timer expired rejoin their class's head
        # (they are the oldest of their class — they were refused earlier)
        if self.backoff and self.backoff[0][0] <= self.clock + 1e-12:
            ready: List[List[TokenRequest]] = [[] for _ in PRIORITY_CLASSES]
            while self.backoff and self.backoff[0][0] <= self.clock + 1e-12:
                _, _, req = heapq.heappop(self.backoff)
                ready[req.priority].append(req)
            for cls, reqs in enumerate(ready):
                if reqs:
                    self.queues[cls][:0] = reqs
        scanned = 0
        for q in self.queues:
            i = 0
            while (
                i < len(q)
                and len(self.live) < self.slots
                and scanned < ADMIT_SCAN
            ):
                req = q[i]
                if req.arrival_s > self.clock + 1e-12:
                    break  # this class's tail has not arrived yet
                if req.deadline_s < self.clock:
                    # deadline already passed while queued: serving it is
                    # wasted work — drop for goodput, not throughput
                    q.pop(i)
                    metrics.deadline_dropped[req.service] += 1
                    metrics.class_deadline_dropped[req.priority] += 1
                    if metrics.recorder is not None:
                        metrics.recorder.close(
                            req.rid,
                            "deadline_dropped",
                            self.clock,
                            cause="deadline expired while queued",
                        )
                    continue
                if self._try_admit(req, metrics):
                    q.pop(i)
                    continue
                # refused (OutOfPages): back off under the retry budget
                q.pop(i)
                scanned += 1
                req.retries += 1
                metrics.class_retries[req.priority] += 1
                if req.retries > self.knobs.retry_budget:
                    metrics.retry_dropped[req.service] += 1
                    metrics.class_retry_dropped[req.priority] += 1
                    if metrics.recorder is not None:
                        metrics.recorder.close(
                            req.rid,
                            "retry_dropped",
                            self.clock,
                            cause="retry budget exhausted after refusals",
                        )
                else:
                    req.next_try_s = self.clock + self.knobs.retry_backoff_s(
                        req.retries
                    )
                    heapq.heappush(
                        self.backoff, (req.next_try_s, self._seq, req)
                    )
                    self._seq += 1
                    if metrics.recorder is not None:
                        metrics.recorder.note(
                            req.rid,
                            "backoff",
                            self.clock,
                            next_try_s=req.next_try_s,
                        )
            if len(self.live) >= self.slots or scanned >= ADMIT_SCAN:
                break

    # -- decode (mirrors Engine.step) ------------------------------------------
    def _decode_step(self, metrics: "TokenMetrics") -> None:
        dt = self.step_time_s(len(self.live))
        self.clock += dt
        still_live: List[TokenRequest] = []
        resumed: List[TokenRequest] = []
        evicted: set = set()  # rids evicted mid-step as preemption victims
        finished: set = set()  # rids finished this step (pages released)
        for req in self.live:
            if req.rid in evicted or req.rid in finished:
                continue
            # grow pages to cover this step's cache write (the engine keeps
            # pool length == written positions + the sampled-but-unwritten
            # token: exactly context_len), so the first post-admission step
            # needs no growth — the admission reserved one slot ahead
            need = req.context_len - self.pool.request(req.rid).length
            if need > 0 and not self._grow(
                req, need, still_live, resumed, evicted, finished, metrics
            ):
                continue
            req.generated += 1
            if req.done or req.context_len >= self.knobs.max_len:
                finished.add(req.rid)
                self._finish(req, metrics)
            else:
                still_live.append(req)
        self.live = still_live
        # preempted requests resume first, like run_closed_loop's re-queue
        # (within their own class on the resilience path)
        for cls in range(len(self.queues)):
            front = [r for r in resumed if r.priority == cls]
            if front:
                self.queues[cls][:0] = front

    def _grow(
        self,
        req: TokenRequest,
        need: int,
        still_live: List[TokenRequest],
        resumed: List[TokenRequest],
        evicted: set,
        finished: set,
        metrics: "TokenMetrics",
    ) -> bool:
        """Grow ``req``'s pages by ``need`` mid-decode.  On ``OutOfPages``
        the legacy path always preempts ``req`` itself; the resilience path
        evicts the lowest-class / shortest victim among the live batch
        (possibly ``req``) and retries.  Returns True when the pages were
        grown, False when ``req`` left the live batch."""
        while True:
            try:
                self.pool.append_tokens(req.rid, need)
                return True
            except OutOfPages:
                victim = req
                if self.resilience:
                    # lowest class first (largest priority index), then the
                    # shortest context (cheapest restart), then rid; a
                    # higher-class request is never evicted to grow a
                    # lower-class one
                    victim = min(
                        (
                            r
                            for r in self.live
                            if r.rid not in evicted
                            and r.rid not in finished
                            and (r is req or r.priority >= req.priority)
                        ),
                        key=lambda r: (-r.priority, r.context_len, r.rid),
                    )
                if victim is req:
                    # preempt self: pages released, resume later with
                    # generated tokens folded into the context (engine
                    # semantics); a resume needs context + 1 <= max_len to
                    # re-admit — at the cap there is no room, finish
                    # truncated like the engine's max_len path
                    if req.context_len + 1 > self.knobs.max_len:
                        finished.add(req.rid)
                        self._finish(req, metrics)
                        return False
                    self.pool.release(req.rid)
                    req.preemptions += 1
                    metrics.preemptions[req.service] += 1
                    if metrics.recorder is not None:
                        metrics.recorder.note(
                            req.rid,
                            "preempted",
                            self.clock,
                            uid=self.uid,
                            cause="kv_pressure",
                        )
                    resumed.append(req)
                    # mark it out of the live batch: a later request's
                    # victim search this same step must not pick it again
                    # (its pages are gone; a second resume would duplicate
                    # the request in its queue)
                    evicted.add(req.rid)
                    return False
                evicted.add(victim.rid)
                if victim in still_live:
                    still_live.remove(victim)
                if victim.context_len + 1 > self.knobs.max_len:
                    finished.add(victim.rid)
                    self._finish(victim, metrics)
                    continue
                self.pool.release(victim.rid)
                victim.preemptions += 1
                metrics.preemptions[victim.service] += 1
                if metrics.recorder is not None:
                    metrics.recorder.note(
                        victim.rid,
                        "preempted",
                        self.clock,
                        uid=self.uid,
                        cause="evicted_for_higher_class",
                    )
                resumed.append(victim)

    def _finish(self, req: TokenRequest, metrics: "TokenMetrics") -> None:
        req.finish_s = self.clock
        self.pool.release(req.rid)
        if req.generated > 1:
            metrics.tpot_s[req.service].append(
                (req.finish_s - req.first_token_s) / (req.generated - 1)
            )
        metrics.completed_at[req.service].append(req.finish_s)
        metrics.class_completed[req.priority] += 1
        if req.finish_s <= req.deadline_s:
            metrics.class_goodput[req.priority] += 1
        if metrics.recorder is not None:
            # a request that hit the context cap before its decode budget
            # finished truncated, like the engine's max_len path
            metrics.recorder.close(
                req.rid,
                "completed" if req.done else "truncated",
                self.clock,
                cause="" if req.done else "context cap",
            )

    # -- one traffic bin --------------------------------------------------------
    def run_until(self, t_end: float, metrics: "TokenMetrics") -> None:
        """Advance this instance's clock to ``t_end``, admitting and
        decoding.  The clock may overrun ``t_end`` by a fraction of a step —
        the remainder carries into the next bin, like a real engine whose
        step straddles a metrics-bin edge."""
        while self.clock < t_end - 1e-12:
            if self.resilience:
                self._admit_pass_priority(metrics)
            else:
                self._admit_pass(metrics)
            if not self.live:
                # idle: jump to the next queued arrival or backoff expiry
                # (an empty pool can always admit an arrived, non-backing-
                # off request, so nothing is admittable right now)
                nxt = [
                    r.arrival_s
                    for q in self.queues
                    for r in q
                    if r.arrival_s > self.clock + 1e-12
                ]
                if self.backoff:
                    nxt.append(self.backoff[0][0])
                self.clock = min(min(nxt), t_end) if nxt else t_end
                continue
            self._decode_step(metrics)

    def drain(self) -> List[TokenRequest]:
        """Evict everything (the instance vanished mid-transition): queued
        and in-flight requests spill back to the service level; in-flight
        ones resume elsewhere with their generated tokens (a migration is a
        preemption from the request's point of view)."""
        for req in self.live:
            self.pool.release(req.rid)
            req.preemptions += 1
        out = list(self.live)
        for q in self.queues:
            out.extend(q)
        for _, _, req in sorted(self.backoff):
            out.append(req)
        self.live = []
        self.queues = [[] for _ in PRIORITY_CLASSES]
        self.backoff = []
        return out

    def crash(
        self, now: float, metrics: "TokenMetrics"
    ) -> Tuple[List[TokenRequest], List[TokenRequest]]:
        """The instance's process died mid-decode (the serving-path fault
        family): every in-flight request loses its KV cache *and* its
        generated tokens (the sampled outputs lived in the dead process) and
        must restart from the prompt; queued and backing-off requests spill
        intact.  The replacement process starts with a cold, empty page
        pool.  Returns ``(inflight, queued)`` spill lists."""
        self.clock = max(self.clock, now)
        inflight: List[TokenRequest] = []
        for req in self.live:
            req.preemptions += 1
            metrics.preemptions[req.service] += 1
            req.generated = 0  # KV and sampled tokens are gone
            if metrics.recorder is not None:
                metrics.recorder.note(
                    req.rid,
                    "crashed",
                    self.clock,
                    uid=self.uid,
                    cause="instance process died mid-decode",
                )
            inflight.append(req)
        queued: List[TokenRequest] = []
        for q in self.queues:
            queued.extend(q)
        for _, _, req in sorted(self.backoff):
            queued.append(req)
        self.live = []
        self.queues = [[] for _ in PRIORITY_CLASSES]
        self.backoff = []
        self.pool = PagePool(
            self.knobs.num_pages(self.size),
            self.knobs.page_size,
            self.knobs.max_pages_per_req,
        )
        return inflight, queued

    @property
    def in_system(self) -> int:
        return (
            len(self.live)
            + sum(len(q) for q in self.queues)
            + len(self.backoff)
        )


@dataclasses.dataclass
class TokenMetrics:
    """Per-service observation streams the report's summaries derive from."""

    services: List[str]
    ttft_s: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    tpot_s: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    queue_delay_s: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict
    )
    completed_at: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict
    )
    # per-service running event counts (a refusal is one OutOfPages
    # admission attempt; the same request may be refused many times)
    preemptions: Dict[str, int] = dataclasses.field(default_factory=dict)
    refusals: Dict[str, int] = dataclasses.field(default_factory=dict)
    # resilience-path per-service drop counts (stay zero without a mix)
    deadline_dropped: Dict[str, int] = dataclasses.field(default_factory=dict)
    retry_dropped: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-priority-class conservation counters, indexed by PRIORITY_CLASSES;
    # goodput = completions that beat their deadline, retries = backoff
    # retry attempts charged (refusals + crash/migration spills)
    class_arrivals: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    class_completed: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    class_goodput: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    class_deadline_dropped: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    class_retry_dropped: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    class_shed: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    class_retries: List[int] = dataclasses.field(
        default_factory=lambda: [0] * len(PRIORITY_CLASSES)
    )
    # flight-recorder observability (SimConfig.observability=True only):
    # every lifecycle site guards on ``recorder is not None``, so the None
    # default keeps the hot path — and every token report — byte-identical
    recorder: Optional[FlightRecorder] = None

    def __post_init__(self):
        for svc in self.services:
            self.ttft_s.setdefault(svc, [])
            self.tpot_s.setdefault(svc, [])
            self.queue_delay_s.setdefault(svc, [])
            self.completed_at.setdefault(svc, [])
            self.preemptions.setdefault(svc, 0)
            self.refusals.setdefault(svc, 0)
            self.deadline_dropped.setdefault(svc, 0)
            self.retry_dropped.setdefault(svc, 0)


def _summary(vals: List[float], prefix: str) -> Dict[str, float]:
    # the shared repro_torch.obs helper computes the exact same bytes; the serve
    # CLI's --stats-json reuses it so the real engine emits this schema too
    return percentile_summary(vals, prefix, _PCTS)


class TokenServingState:
    """The simulator-side owner of the token model: one
    :class:`InstanceModel` per live instance, service-level spill queues,
    and the latency/preemption observation streams.

    ``step_time_for`` closes over the simulator's profile: per-token step
    time at occupancy ``b`` is ``latency_ms(svc, size, b) / 1000 /
    decode_tokens`` (corrected profiles — §8.3 ``MeasuredProfile`` — flow
    through unchanged, which is the calibration loop).
    """

    def __init__(
        self,
        services: List[str],
        profile,
        latency_slo_for: Callable[[str], float],
        knobs: Optional[TokenKnobs] = None,
        mix: Optional[PriorityMix] = None,
        recorder: Optional[FlightRecorder] = None,
    ):
        self.knobs = knobs or TokenKnobs()
        self.profile = profile
        self.latency_slo_for = latency_slo_for
        self.mix = mix
        self.metrics = TokenMetrics(list(services), recorder=recorder)
        self.instances: Dict[int, InstanceModel] = {}
        self.spill: Dict[str, List[TokenRequest]] = {s: [] for s in services}
        self._next_rid = 0

    @property
    def resilience(self) -> bool:
        """Priority/deadline/backoff semantics are active iff a mix is."""
        return self.mix is not None

    # -- construction helpers ---------------------------------------------------
    def step_time_for(
        self, svc: str, size: int, noise: float = 1.0
    ) -> Callable[[int], float]:
        knobs = self.knobs
        cache: Dict[int, float] = {}  # profile is fixed for the model's life

        def step_time_s(b: int) -> float:
            b = max(b, 1)
            v = cache.get(b)
            if v is None:
                lat = self.profile.latency_ms(svc, size, b)
                v = cache[b] = (
                    lat / 1000.0 / knobs.step_decode_tokens
                ) / noise
            return v

        return step_time_s

    def slots_for(self, svc: str, size: int) -> int:
        """§7: the largest SLO-compliant batch is the engine's slot count."""
        return max(
            self.profile.best_batch(svc, size, self.latency_slo_for(svc)), 1
        )

    def make_request(
        self, svc: str, arrival_s: float, rng: np.random.Generator
    ) -> TokenRequest:
        knobs = self.knobs
        prompt = int(rng.integers(1, 2 * knobs.prompt_tokens))
        decode = int(rng.integers(1, 2 * knobs.decode_tokens))
        # clamp so prompt + decode fits the context cap (no unservable reqs)
        prompt = min(prompt, knobs.max_len - 2)
        decode = min(decode, knobs.max_len - 1 - prompt)
        rid = self._next_rid
        self._next_rid += 1
        req = TokenRequest(rid, svc, arrival_s, prompt, max(decode, 1))
        if self.mix is not None:
            # the class draw comes AFTER the shape draws so the no-mix rng
            # stream (and its reports) stays byte-identical
            cls = self.mix.class_of(svc, rng)
            req.priority = cls
            req.deadline_s = arrival_s + self.mix.deadline_s[cls]
        self.metrics.class_arrivals[req.priority] += 1
        if self.metrics.recorder is not None:
            self.metrics.recorder.arrival(
                rid, svc, arrival_s,
                priority=req.priority, deadline_s=req.deadline_s,
            )
        return req

    def record_shed(self, req: TokenRequest) -> None:
        """Charge one admission-control shed against the request's class
        (the per-service shed series is charged by the simulator)."""
        self.metrics.class_shed[req.priority] += 1
        if self.metrics.recorder is not None:
            self.metrics.recorder.close(
                req.rid,
                "shed",
                req.arrival_s,
                cause="degraded-mode admission control",
            )

    def retry_or_drop(self, req: TokenRequest, now: float) -> bool:
        """Charge one backoff retry for a spilled in-flight request; False
        when the retry budget is exhausted (the request is dropped and
        counted ``retry_dropped``)."""
        m = self.metrics
        req.retries += 1
        m.class_retries[req.priority] += 1
        if req.retries > self.knobs.retry_budget:
            m.retry_dropped[req.service] += 1
            m.class_retry_dropped[req.priority] += 1
            if m.recorder is not None:
                m.recorder.close(
                    req.rid,
                    "retry_dropped",
                    now,
                    cause="retry budget exhausted after spill",
                )
            return False
        req.next_try_s = now + self.knobs.retry_backoff_s(req.retries)
        if m.recorder is not None:
            m.recorder.note(req.rid, "backoff", now, next_try_s=req.next_try_s)
        return True

    # -- instance-set sync -------------------------------------------------------
    def sync_instances(
        self, live: InstanceSet, noise_of: Callable[[int], float], now: float
    ) -> None:
        """Reconcile the per-uid models with this bin's instance set: new
        uids get fresh models, vanished uids spill their requests back to
        the service level (re-routed this bin)."""
        for uid in [u for u in self.instances if u not in live]:
            inst = self.instances.pop(uid)
            inflight = {id(r) for r in inst.live}
            for req in inst.live:
                self.metrics.preemptions[req.service] += 1
            for req in inst.drain():
                if self.metrics.recorder is not None and id(req) in inflight:
                    # a migration is a preemption from the request's view
                    self.metrics.recorder.note(
                        req.rid, "migrated", now, uid=uid
                    )
                if (
                    self.resilience
                    and id(req) in inflight
                    and not self.retry_or_drop(req, now)
                ):
                    continue  # migration-spill retry budget exhausted
                self.spill[req.service].append(req)
        for uid in sorted(live):
            if uid in self.instances:
                continue
            svc, size, _tput = live[uid]
            self.instances[uid] = InstanceModel(
                uid,
                svc,
                size,
                self.slots_for(svc, size),
                self.knobs,
                self.step_time_for(svc, size, noise_of(uid)),
                now,
                resilience=self.resilience,
            )

    def crash_instance(self, uid: int, now: float) -> int:
        """Apply an ``instance_crash`` fault: the uid's model loses its
        process (in-flight KV + outputs gone, cold page pool); spilled
        requests re-route this bin, in-flight ones under the retry budget.
        Returns the number of in-flight requests spilled."""
        inst = self.instances.get(uid)
        if inst is None:
            return 0
        inflight, queued = inst.crash(now, self.metrics)
        for req in inflight:
            if self.resilience and not self.retry_or_drop(req, now):
                continue  # crash-spill retry budget exhausted
            self.spill[req.service].append(req)
        for req in queued:
            self.spill[req.service].append(req)
        return len(inflight)

    # -- per-bin serving ---------------------------------------------------------
    def dispatch(
        self,
        svc: str,
        members: List[int],
        pick: Callable[[], int],
        new_requests: List[TokenRequest],
    ) -> None:
        """Route spilled + newly arrived requests over the service's
        instances (spill first: those arrived earlier).  ``pick`` is the
        service's smooth-WRR router returning a uid."""
        pending = self.spill[svc] + new_requests
        self.spill[svc] = []
        if not members:
            self.spill[svc] = pending
            return
        for req in pending:
            uid = pick()
            self.instances[uid].enqueue(req)
            if self.metrics.recorder is not None:
                self.metrics.recorder.note(
                    req.rid, "queued", req.arrival_s, uid=uid
                )

    def serve_bin(self, t_end: float) -> None:
        for uid in sorted(self.instances):
            self.instances[uid].run_until(t_end, self.metrics)

    # -- accounting ---------------------------------------------------------------
    def completed_in(self, svc: str, t0: float, t1: float) -> int:
        return sum(
            1 for t in self.metrics.completed_at[svc] if t0 <= t < t1
        )

    def in_system(self, svc: str) -> int:
        return len(self.spill[svc]) + sum(
            i.in_system for i in self.instances.values() if i.service == svc
        )

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-service TTFT/TPOT/queue-delay p50/p95/p99 plus conservation
        counts — the report extension serialized only in token mode."""
        m = self.metrics
        out: Dict[str, Dict[str, float]] = {}
        for svc in sorted(m.services):
            entry: Dict[str, float] = {}
            entry.update(_summary(m.ttft_s[svc], "ttft"))
            entry.update(_summary(m.tpot_s[svc], "tpot"))
            entry.update(_summary(m.queue_delay_s[svc], "queue_delay"))
            entry["completed"] = len(m.completed_at[svc])
            entry["in_system"] = self.in_system(svc)
            out[svc] = entry
        out["_totals"] = {
            "preemptions": sum(m.preemptions.values()),
            "refusals": sum(m.refusals.values()),
            "completed": sum(len(v) for v in m.completed_at.values()),
        }
        return out

    def _in_system_by_class(self) -> List[int]:
        counts = [0] * len(PRIORITY_CLASSES)
        for reqs in self.spill.values():
            for r in reqs:
                counts[r.priority] += 1
        for inst in self.instances.values():
            for r in inst.live:
                counts[r.priority] += 1
            for q in inst.queues:
                for r in q:
                    counts[r.priority] += 1
            for _, _, r in inst.backoff:
                counts[r.priority] += 1
        return counts

    def priority_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-priority-class goodput / SLO-attainment / drop / retry
        totals — the report extension serialized only when a mix is active.
        Conservation holds exactly per class:
        ``arrivals == completed + deadline_dropped + retry_dropped + shed +
        in_system``."""
        m = self.metrics
        in_sys = self._in_system_by_class()
        out: Dict[str, Dict[str, float]] = {}
        for c, name in enumerate(PRIORITY_CLASSES):
            arr = m.class_arrivals[c]
            good = m.class_goodput[c]
            out[name] = {
                "arrivals": arr,
                "completed": m.class_completed[c],
                "goodput": good,
                "deadline_dropped": m.class_deadline_dropped[c],
                "retry_dropped": m.class_retry_dropped[c],
                "shed": m.class_shed[c],
                "retries": m.class_retries[c],
                "in_system": in_sys[c],
                "slo_attainment": (good / arr) if arr else 1.0,
            }
        return out
