"""Paged KV-cache pool management (the host side of paged attention).

A :class:`PagePool` owns a fixed page inventory; requests allocate pages as
their context grows and release them on completion (one logical page id
addresses a slab across every attention layer).  The pool is the serving
engine's KV accounting: :class:`~repro_torch.serving.engine.Engine` admits a
request's prompt into pages, grows it one token per decode step, and treats
:class:`OutOfPages` as its admission-refusal / preemption signal; ``tables``
produces the (page_tables, lengths) that ``repro_torch.kernels.paged_attention``
and ``Model.decode_step_paged`` consume.

Allocation is **atomic**: a grow that cannot complete rolls back any pages
it grabbed, so a refused request leaves the pool byte-identical.

This is deliberately simple (free-list, no copy-on-write/prefix sharing);
the point is that MIG-Serving's slice scheduler and a paged engine compose:
a slice's HBM budget translates directly to ``num_pages`` (see
``repro_torch.serving.engine.page_hbm_bytes``).

The port's own copy of the JAX package's ``serving/paged_cache.py``
(numpy only); keep the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    pass


def page_bytes(
    page_size: int, kv_heads: int, head_dim: int, n_layers: int,
    dtype_bytes: int = 2,
) -> int:
    """HBM cost of ONE logical page: its k+v slabs across every attention
    layer.  The single source of truth for paged-KV capacity math — both
    :meth:`PagePool.hbm_bytes` and the engine's HBM-budget → ``num_pages``
    mapping derive from it."""
    return 2 * page_size * kv_heads * head_dim * n_layers * dtype_bytes


@dataclasses.dataclass
class RequestPages:
    rid: int
    page_ids: List[int]
    length: int = 0


class PagePool:
    def __init__(self, num_pages: int, page_size: int, max_pages_per_req: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_req = max_pages_per_req
        self._free: List[int] = list(range(num_pages))
        self._requests: Dict[int, RequestPages] = {}

    # -- lifecycle ---------------------------------------------------------------
    def admit(self, rid: int) -> RequestPages:
        if rid in self._requests:
            raise ValueError(f"request {rid} is already admitted to the pool")
        r = RequestPages(rid, [])
        self._requests[rid] = r
        return r

    def release(self, rid: int) -> bool:
        """Return ``rid``'s pages to the free list.  Releasing a request the
        pool no longer holds (a preempt racing a finish/drain, or a release
        after a crash replaced the pool) is a deterministic no-op returning
        False — never a double free-list insertion, which would let two
        requests share a page and corrupt both caches."""
        r = self._requests.pop(rid, None)
        if r is None:
            return False
        self._free.extend(r.page_ids)
        return True

    def abort(self, rid: int) -> None:
        """Undo a *fresh* admission whose pages came from one
        :meth:`append_tokens` grab — the engine's cleanup path when prefill
        fails after the reservation succeeded.  Pages go back in reverse
        grab order, so the free list (hence every later allocation) is
        byte-identical to the pre-admission state."""
        r = self._requests.pop(rid)
        self._free.extend(reversed(r.page_ids))

    def request(self, rid: int) -> RequestPages:
        """The live allocation record for ``rid`` (page ids + token length)."""
        return self._requests[rid]

    def append_tokens(self, rid: int, n: int = 1) -> None:
        """Grow a request's context by ``n`` tokens, allocating pages on
        boundary crossings.  Raises :class:`OutOfPages` when the pool (or the
        per-request table) is exhausted — the engine's admission/preemption
        signal.  **Atomic**: on failure any pages grabbed mid-loop are rolled
        back to the free list and the request's record is unchanged, so a
        refused grow leaves the pool exactly as it found it."""
        r = self._requests[rid]
        new_len = r.length + n
        needed = -(-new_len // self.page_size)  # ceil
        grabbed: List[int] = []
        try:
            while len(r.page_ids) + len(grabbed) < needed:
                if len(r.page_ids) + len(grabbed) >= self.max_pages_per_req:
                    raise OutOfPages(f"request {rid} exceeds max context")
                if not self._free:
                    raise OutOfPages("page pool exhausted")
                grabbed.append(self._free.pop())
        except OutOfPages:
            # roll back in reverse so the free list is byte-identical to the
            # pre-call state (allocation order stays deterministic)
            self._free.extend(reversed(grabbed))
            raise
        r.page_ids.extend(grabbed)
        r.length = new_len

    # -- kernel inputs --------------------------------------------------------------
    def tables(
        self, rids: List[Optional[int]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(page_tables (B, max_pages), lengths (B,)) for the given batch.
        ``None`` entries are idle slots; they (and unused table tail cells)
        point at page 0 — a legal dummy the kernel masks by length 0."""
        B = len(rids)
        pt = np.zeros((B, self.max_pages_per_req), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            r = self._requests[rid]
            pt[i, : len(r.page_ids)] = r.page_ids
            lens[i] = r.length
        return pt, lens

    # -- accounting ---------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.num_pages

    def hbm_bytes(self, kv_heads: int, head_dim: int, n_layers: int,
                  dtype_bytes: int = 2) -> int:
        """Pool HBM footprint — what a slice's capacity check consumes."""
        return self.num_pages * page_bytes(
            self.page_size, kv_heads, head_dim, n_layers, dtype_bytes
        )
