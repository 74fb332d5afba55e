"""Serving engine: ragged continuous batching on one GPU instance.

The port of the JAX package's ``serving/engine.py``.  An :class:`Engine`
is what MIG-Serving schedules onto a GPU instance: it owns the model
params, a fixed-capacity batch of request *slots*, and the ``prefill`` /
``decode`` steps.  Admission runs a batch-1 :meth:`Model.prefill` over the
prompt and scatters its cache into a free slot (other slots are never
touched); every decode step advances all live slots by one token at their
*own* positions.

Two KV backends:

* ``paged`` (default where supported) — attention KV lives in fixed-size
  pages from a shared :class:`~repro_torch.serving.paged_cache.PagePool`;
  the decode step runs the paged-attention CUDA kernel on a card.  Pool
  exhaustion is explicit: admission is *refused* (``OutOfPages``
  propagates) and a request that cannot grow mid-decode is *preempted* —
  its pages are released and it restarts later with its generated tokens
  folded into the prompt.
* ``flat`` — the dense per-slot ``(B, max_len, ...)`` cache; the decode
  step runs the flat decode-attention CUDA kernel on a card over each
  slot's prefix.  The tests hold the paged path against it.  A pure SSM
  model has no growing KV to page: it always takes this backend (its
  per-slot conv tail and state), ``paged`` included.  MLA's latent cache
  has no paged layout: ``auto`` takes this backend and ``paged`` raises,
  as in the reference.

A sliding window shorter than ``max_len`` (a ring cache) is refused, as
in the reference, which drives ring caches through ``Model.prefill`` and
``Model.decode_step`` directly (its ``long_500k`` shape).

The engine runs on the device its params live on.  Sampling happens on the
host and is identical to the reference: ``temperature == 0`` is argmax,
otherwise temperature/top-k sampling from the ``rng`` passed in.

On a CUDA device the paged decode step of the dense stack runs as one
CUDA graph (:class:`DecodeGraph`): it is captured at the first step and
replayed at every later one, so its thousands of launches leave the host
as one.  The graph reads its inputs by address: the step copies the
tokens and positions into static device buffers and the page tables into
the cache's, and admissions, which stay eager, write the same pools in
place.  Every decode step has fixed shapes and never waits for the card
(idle slots write the pools' sink page, or their own rows back), but only
the dense paged step is captured: the flat backend, and the MoE and hybrid
paged steps, run eagerly.  :meth:`Engine.close` frees the graph.

Each call names its phases for a torch profiler
(:func:`repro_torch.kernels.ops.span`; no-ops without one):
``engine.admit`` / ``engine.step`` around the call, and inside it
``.prepare`` (pages, page tables, the tokens' copy to the device),
``.model`` (the model call), ``.sync`` (the logits' copy back, which
waits for the device) and ``.sample``; ``engine.step.replay``, inside
``.model``, marks a step that replayed the graph.  The model's own
``model.*`` spans are recorded at capture, so replayed steps carry none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import span
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DENSE_TYPES, Model
from repro_torch.obs.metrics import percentile_summary
from repro_torch.serving.paged_cache import OutOfPages, PagePool, page_bytes


# Prompts of dense models are right-padded to a multiple of this (exact:
# masked-out attention rows, true-last-token logits), the reference's
# bucket; SSM and hybrid models pad to ``cfg.ssm_chunk`` instead, which
# the chunked scan needs (dt-masked padding keeps their states exact).
# MoE prompts are not padded: padding tokens would compete with the real
# ones for expert capacity.
PREFILL_BUCKET = 16


@dataclasses.dataclass(eq=False)
class Request:
    # eq=False: requests are identity-compared (a generated __eq__ would
    # compare the numpy prompt and make ``pending.remove(req)`` raise)
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    first_token_s: float = 0.0
    finished_s: float = 0.0

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


def attn_layer_count(cfg: ModelConfig) -> int:
    """Number of layers holding a growing attention KV cache."""
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def page_hbm_bytes(cfg: ModelConfig, page_size: int, dtype_bytes: int = 2) -> int:
    """Device-memory cost of ONE logical page for this architecture — the
    unit an instance's memory budget is divided by to get ``num_pages``."""
    return page_bytes(
        page_size, cfg.num_kv_heads, cfg.head_dim,
        attn_layer_count(cfg), dtype_bytes,
    )


class DecodeGraph:
    """A decode step captured as one CUDA graph at its first call and
    replayed at every later one.  The graph reads its arguments by address,
    so each call passes the same tensors (the engine's own), and returns
    the graph's logits buffer, which the next replay overwrites.  Each
    replay adds the captured step's kernel launches to
    :data:`repro_torch.kernels.ops.LAUNCHES`, so the counts a step are the
    eager step's."""

    def __init__(self, step):
        self.step = step  # (params, cache, tokens, positions) -> (logits, cache)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, params, cache, tokens, positions):
        if self.graph is None:
            self._capture(params, cache, tokens, positions)
        with span("engine.step.replay"):
            self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        self.replays += 1
        return self.logits, cache

    def _capture(self, params, cache, tokens, positions) -> None:
        """Warm the step up on a side stream (cuBLAS handles, workspaces),
        then capture it.  The warm-up writes the live slots' k/v rows that
        the first replay writes again, bit for bit.  Neither run counts as
        launches: the capture's are what each replay adds."""
        before = ops.launches()
        stream = torch.cuda.current_stream(tokens.device)
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.step(params, cache, tokens, positions)
        stream.wait_stream(side)
        warm = ops.launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits, _ = self.step(params, cache, tokens, positions)
        after = ops.launches()
        self.launches = {k: after[k] - warm[k] for k in after if after[k] != warm[k]}
        ops.LAUNCHES.update(before)
        self.graph = graph
        self.captures += 1

    def reset(self) -> None:
        """Free the graph and its memory pool once the device has run every
        replay; the next call captures anew."""
        if self.graph is not None:
            torch.cuda.synchronize(self.logits.device)
            self.graph.reset()
            self.graph = self.logits = None


class Engine:
    def __init__(
        self,
        model: Model,
        params: Any,
        batch: int,
        max_len: int,
        *,
        kv_backend: str = "auto",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        hbm_budget_bytes: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
    ):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = params["embed"].device
        self.batch = batch
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        self.steps = 0
        self.slots: List[Optional[Request]] = [None] * batch
        # per-slot context length; -1 marks an idle slot (the decode-side
        # convention: negative position => no cache writes)
        self.slot_pos = np.full(batch, -1, np.int32)
        self._finished: List[Request] = []
        self._preempted: List[Request] = []
        # the decode step's inputs, on the device at fixed addresses
        self._tokens = torch.zeros((batch, 1), dtype=torch.int64, device=self.device)
        self._positions = torch.full((batch,), -1, dtype=torch.int64, device=self.device)

        cfg = self.cfg
        if cfg.sliding_window and cfg.sliding_window < max_len:
            raise NotImplementedError(
                "Engine does not serve sliding-window ring caches; use the flat "
                "decode path directly (Model.prefill / Model.decode_step)"
            )
        if kv_backend == "auto":
            backend = "paged" if model.supports_paged_kv else "flat"
        elif kv_backend == "paged" and not model.supports_paged_kv:
            if cfg.arch_type == "ssm":
                backend = "flat"  # no growing KV to page: the state cache as is
            else:
                raise ValueError(
                    f"paged KV unsupported for {cfg.name}: "
                    f"attention_kind={cfg.attention_kind!r}"
                )
        elif kv_backend in ("paged", "flat"):
            backend = kv_backend
        else:
            raise ValueError(f"unknown kv_backend {kv_backend!r}")
        self.kv_backend = backend

        if backend == "paged":
            max_pages_per_req = -(-max_len // page_size)  # ceil
            if num_pages is None:
                if hbm_budget_bytes is not None:
                    num_pages = hbm_budget_bytes // max(1, page_hbm_bytes(cfg, page_size))
                else:
                    num_pages = batch * max_pages_per_req
            if num_pages < 1:
                raise ValueError(
                    f"HBM budget yields num_pages={num_pages}; need >= 1"
                )
            self.pool: Optional[PagePool] = PagePool(
                num_pages, page_size, max_pages_per_req
            )
            self.cache = model.init_paged_cache(
                batch, num_pages, page_size, max_pages_per_req, device=self.device
            )
            self._decode = model.decode_step_paged
        else:
            self.pool = None
            self.cache = model.init_cache(batch, max_len, device=self.device)
            self._decode = model.decode_step
        # on a card the dense stack's paged step runs as a CUDA graph (the
        # other steps have fixed shapes too, but were never checked under
        # capture: they stay eager)
        self._graph: Optional[DecodeGraph] = None
        if backend == "paged" and self.device.type == "cuda" and cfg.arch_type in DENSE_TYPES:
            self._graph = self._decode = DecodeGraph(self._decode)
        self._prefill = lambda p, toks, lens: model.prefill(p, toks, lengths=lens)
        if cfg.arch_type in ("ssm", "hybrid"):
            self.pad_to = cfg.ssm_chunk
        elif cfg.arch_type == "moe":
            self.pad_to = 1
        else:
            self.pad_to = PREFILL_BUCKET

    # -- introspection --------------------------------------------------------
    @property
    def graph_captures(self) -> int:
        """How often the decode step was captured as a CUDA graph."""
        return self._graph.captures if self._graph else 0

    @property
    def graph_replays(self) -> int:
        """How many decode steps replayed the captured graph."""
        return self._graph.replays if self._graph else 0

    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    @property
    def num_live(self) -> int:
        return sum(s is not None for s in self.slots)

    def take_preempted(self) -> List[Request]:
        """Requests evicted on pool exhaustion since the last call; re-admit
        them once capacity frees up."""
        out, self._preempted = self._preempted, []
        return out

    # -- admission ------------------------------------------------------------
    @torch.no_grad()
    def admit(self, req: Request, rng: Optional[np.random.Generator] = None) -> int:
        """Admit one request: batch-1 prefill over its context, cache
        scattered into a free slot, first output token sampled from the
        prefill logits.

        Raises :class:`OutOfPages` (paged backend) when the pool cannot hold
        the context plus one decode token; the request is left untouched
        for the caller to retry later."""
        with span("engine.admit"):
            t_admit = time.monotonic()
            with span("engine.admit.prepare"):
                ctx = np.asarray(req.prompt, np.int32)
                if req.out_tokens:  # resuming after preemption
                    ctx = np.concatenate([ctx, np.asarray(req.out_tokens, np.int32)])
                L = int(ctx.size)
                if L < 1:
                    raise ValueError("empty prompt")
                if L + 1 > self.max_len:
                    raise ValueError(
                        f"context length {L} does not fit max_len={self.max_len}"
                    )
                slot = self.slots.index(None)
                if self.pool is not None:
                    self.pool.admit(req.rid)
                    try:
                        # context + room for the first decode write
                        self.pool.append_tokens(req.rid, L + 1)
                    except OutOfPages:
                        self.pool.release(req.rid)
                        raise
                try:
                    toks = np.zeros((1, -(-L // self.pad_to) * self.pad_to), np.int32)
                    toks[0, :L] = ctx
                    tokens = torch.as_tensor(toks, dtype=torch.int64, device=self.device)
                    lengths = torch.tensor([L], dtype=torch.int64, device=self.device)
                except BaseException:
                    self._abort_admission(slot, req)
                    raise
            try:
                with span("engine.admit.model"):
                    logits, pcache = self._prefill(self.params, tokens, lengths)
                    page_ids = (
                        self.pool.request(req.rid).page_ids
                        if self.pool is not None
                        else None
                    )
                    self.cache = self.model.scatter_prefill(
                        self.cache, pcache, slot, L, page_ids
                    )
                self.slots[slot] = req
                self.slot_pos[slot] = L
                if req.submitted_s == 0.0:
                    # a caller that stamped none: TTFT from the start of
                    # admission, prefill included (the reference stamps it
                    # after the prefill)
                    req.submitted_s = t_admit
                with span("engine.admit.sync"):
                    row = logits.float().cpu().numpy()[0, 0]
                with span("engine.admit.sample"):
                    req.out_tokens.append(self._sample(row, rng))
                    if req.first_token_s == 0.0:
                        req.first_token_s = time.monotonic()
            except BaseException:
                # prefill/scatter/sampling failed after the pages were
                # reserved: undo the admission, then re-raise
                self._abort_admission(slot, req)
                raise
            if req.done:
                self._finish(slot)
            return slot

    # -- decode ---------------------------------------------------------------
    @torch.no_grad()
    def step(self, rng: Optional[np.random.Generator] = None) -> List[Request]:
        """One ragged decode step for all live slots; returns finished
        requests (including any that completed at admission since the last
        step).  Paged backend: slots that cannot allocate their next token's
        page are preempted first (see :meth:`take_preempted`)."""
        with span("engine.step"):
            finished, self._finished = self._finished, []
            live = [i for i, s in enumerate(self.slots) if s is not None]
            if not live:
                return finished
            with span("engine.step.prepare"):
                if self.pool is not None:
                    for i in list(live):
                        req = self.slots[i]
                        need = int(self.slot_pos[i]) + 1 - self.pool.request(req.rid).length
                        if need > 0:
                            try:
                                self.pool.append_tokens(req.rid, need)
                            except OutOfPages:
                                self._preempt(i)
                                live.remove(i)
                    if not live:
                        return finished
                    self._refresh_page_tables()
                toks = np.zeros((self.batch, 1), np.int64)
                pos = np.full(self.batch, -1, np.int64)
                for i in live:
                    toks[i, 0] = self.slots[i].out_tokens[-1]
                    pos[i] = self.slot_pos[i]
                self._tokens.copy_(torch.from_numpy(toks))
                self._positions.copy_(torch.from_numpy(pos))
            with span("engine.step.model"):
                logits, self.cache = self._decode(
                    self.params, self.cache, self._tokens, self._positions
                )
            with span("engine.step.sync"):
                lg = logits.float().cpu().numpy()
            with span("engine.step.sample"):
                for i in live:
                    req = self.slots[i]
                    self.slot_pos[i] += 1
                    req.out_tokens.append(self._sample(lg[i, 0], rng))
                    if req.done or self.slot_pos[i] >= self.max_len:
                        self._finish(i)
            self.steps += 1
            finished.extend(self._finished)
            self._finished = []
            return finished

    def close(self) -> None:
        """Free the captured decode graph and its memory pool now, not
        when the engine is dropped (a later step captures anew).  A graph
        freed while a torch profiler runs drops device operations from its
        trace."""
        if self._graph is not None:
            self._graph.reset()

    # -- internals ------------------------------------------------------------
    def _abort_admission(self, slot: int, req: Request) -> None:
        """Undo an admission that failed after its pages were reserved:
        the slot freed and the pages returned, so a failed admission leaves
        the engine as it was."""
        self.slots[slot] = None
        self.slot_pos[slot] = -1
        if self.pool is not None:
            self.pool.abort(req.rid)

    def _sample(
        self, logits_row: np.ndarray, rng: Optional[np.random.Generator]
    ) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits_row))
        if rng is None:
            raise ValueError("temperature > 0 requires an rng")
        z = logits_row.astype(np.float64) / self.temperature
        if self.top_k and self.top_k < z.size:
            # exactly k candidates; the stable sort makes ties deterministic
            # (lowest index wins), so seeded runs stay reproducible
            keep = np.argsort(-z, kind="stable")[: self.top_k]
            cut = np.full_like(z, -np.inf)
            cut[keep] = z[keep]
            z = cut
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(z.size, p=p))

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.finished_s = time.monotonic()
        self.slots[slot] = None
        self.slot_pos[slot] = -1
        if self.pool is not None:
            self.pool.release(req.rid)
        self._finished.append(req)

    def _preempt(self, slot: int) -> None:
        req = self.slots[slot]
        # re-admission prefills prompt + out_tokens and needs one more decode
        # position; a request already at the context cap finishes truncated
        if int(self.slot_pos[slot]) + 2 > self.max_len:
            self._finish(slot)
            return
        self.slots[slot] = None
        self.slot_pos[slot] = -1
        self.pool.release(req.rid)
        self._preempted.append(req)

    def _refresh_page_tables(self) -> None:
        rids = [s.rid if s is not None else None for s in self.slots]
        pt, _ = self.pool.tables(rids)
        self.cache["page_tables"].copy_(torch.from_numpy(pt))


@dataclasses.dataclass
class ServeStats:
    served: int = 0
    tokens: int = 0
    preempted: int = 0
    refused: int = 0  # OutOfPages admission refusals (request stays pending)
    wall_s: float = 0.0
    # per-request wall-clock latencies: time to first token and mean time
    # per output token
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    tpot_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def throughput(self) -> float:
        return self.served / self.wall_s if self.wall_s else 0.0

    def summary(self, service: str = "engine") -> Dict[str, Any]:
        """The engine-side stats in the reference's ``serving.*`` metrics
        schema (``launch/serve.py --stats-json`` writes exactly this)."""
        return {
            "service": service,
            "counters": {
                "serving.completed": float(self.served),
                "serving.preemptions": float(self.preempted),
                "serving.refusals": float(self.refused),
                "serving.tokens": float(self.tokens),
            },
            "latency": {
                **percentile_summary(self.ttft_s, "ttft"),
                **percentile_summary(self.tpot_s, "tpot"),
            },
            "throughput_rps": self.throughput,
            "wall_s": self.wall_s,
        }


def run_closed_loop(
    engine: Engine,
    requests: List[Request],
    seed: int = 0,
    measured: Optional[Any] = None,
    service: Optional[str] = None,
    size: Optional[int] = None,
) -> ServeStats:
    """Admit-and-decode until all requests finish.

    Preempted requests are re-queued at the front; admission refusals
    (``OutOfPages``) leave the request pending until capacity frees up.
    ``measured`` is duck-typed: any object with ``observe(service, size,
    batch, throughput)`` (the reference's ``MeasuredProfile``) receives the
    measured throughput when ``service`` and ``size`` are given too.

    Every request the caller has not stamped is submitted at the loop's
    start, so its TTFT includes its wait for a slot as well as its
    prefill."""
    rng = np.random.default_rng(seed)
    pending = list(requests)
    stats = ServeStats()
    t0 = time.monotonic()
    for req in requests:
        if req.submitted_s == 0.0:
            req.submitted_s = t0
    while stats.served < len(requests):
        admitted = False
        # first-fit admission: a request the pool cannot hold right now must
        # not block admittable requests queued behind it
        for req in list(pending):
            if not engine.has_free_slot():
                break
            try:
                engine.admit(req, rng)
            except OutOfPages:
                stats.refused += 1
                continue
            pending.remove(req)
            admitted = True
        finished = engine.step(rng)
        for req in finished:
            stats.served += 1
            stats.tokens += len(req.out_tokens)
            if req.first_token_s > 0.0:
                stats.ttft_s.append(req.first_token_s - req.submitted_s)
                if len(req.out_tokens) > 1:
                    stats.tpot_s.append(
                        (req.finished_s - req.first_token_s)
                        / (len(req.out_tokens) - 1)
                    )
        preempted = engine.take_preempted()
        stats.preempted += len(preempted)
        pending = preempted + pending
        # stuck only if this iteration made no progress of any kind
        if (not finished and not admitted and not preempted
                and engine.num_live == 0 and pending):
            raise RuntimeError(
                f"requests {[r.rid for r in pending]} cannot be admitted: "
                f"page pool too small for their contexts"
            )
    stats.wall_s = time.monotonic() - t0
    if measured is not None and service is not None and size is not None:
        if stats.wall_s > 0:
            measured.observe(service, size, engine.batch, stats.throughput)
    return stats
