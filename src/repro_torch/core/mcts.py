"""The slow algorithm: customized Monte Carlo Tree Search (§5.3, Appendix A.2).

Tree shape (Figure 7): nodes are completion-rate vectors, edges are GPU
configs, leaves are all-≥100% nodes; the objective is the *shortest* path
(fewest devices).  Vanilla MCTS fails here for the paper's two reasons,
addressed exactly as the paper does:

  1. **Child explosion** — each expansion samples 5 not-fully-satisfied
     services, scores only configs touching them, and keeps the top-K
     (K=10) as edges.
  2. **Slow/inaccurate rollout** — the classic random playout estimates a
     *random* path, not the shortest.  We use the paper's memoized
     randomized estimation: a pool of "good candidate" configs is
     pre-computed per *type* of completion rates (the frozenset of unmet
     services, needs bucketed); a rollout repeatedly applies a random
     pool member and the step count is memoized by the bucketed signature.

Selection is UCT adapted to minimization (lower estimated total depth is
better).  Every completed rollout yields a concrete deployment suffix, so the
search is *anytime*: we track the best full config-sequence seen.

Array-native hot path: edge generation unions the space's precomputed
per-service boolean masks (``ConfigSpace.service_masks``) instead of a
Python scan over every config, top-K cuts use ``np.argpartition`` (O(n)
instead of a full sort), rollout/expansion completion updates are two
indexed adds, and signatures are raw little-endian bytes of the bucketed
need vector.

The port's copy of the JAX package's ``core/mcts.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.deployment import ConfigSpace, GPUConfig, OptimizerProcedure

_BUCKETS = 8


def _bucket_signature(completion: np.ndarray, buckets: int = _BUCKETS) -> bytes:
    """The paper's "type of completion rates": unmet services with their
    residual need quantized to ``buckets`` levels (as hashable bytes)."""
    need = np.clip(1.0 - completion, 0.0, None)
    # ceil so that any strictly-positive residual lands in bucket >= 1:
    # met and nearly-met services must not share a signature, or cached
    # pools go stale and rollouts stall.
    q = np.minimum(np.ceil(need * buckets).astype(np.int64), buckets)
    return q.tobytes()


def _bucket_of(need: float) -> int:
    """Scalar twin of :func:`_bucket_signature`'s quantization (rollouts
    maintain the bucketed vector incrementally, one touched service at a
    time, instead of re-deriving the whole signature per step)."""
    if need <= 0.0:
        return 0
    b = int(math.ceil(need * _BUCKETS))
    return b if b < _BUCKETS else _BUCKETS


def _top_k_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` largest scores, sorted descending with ascending
    index as the deterministic tie-break (argpartition cut, O(n))."""
    if k >= len(scores):
        part = np.arange(len(scores))
    else:
        cut = len(scores) - k
        part = np.argpartition(scores, cut)[cut:]
    # argpartition's order is not defined: the lexsort makes it so, and the
    # port keeps the reference's calls to keep its ties
    return part[np.lexsort((part, -scores[part]))]


@dataclasses.dataclass
class _Node:
    completion: np.ndarray
    depth: int
    children: Dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    edges: Optional[List[int]] = None  # config indices (top-K cut)
    visits: int = 0
    total: float = 0.0  # sum of estimated total path lengths
    _done: Optional[bool] = None
    # edges with no child yet, in edge order (maintained by _make_child so
    # the selection loop need not rebuild the list every visit)
    unvisited: Optional[List[int]] = None

    def q(self) -> float:
        return self.total / self.visits if self.visits else math.inf

    def done(self) -> bool:
        # completion is fixed at construction, so compute once
        if self._done is None:
            self._done = bool(np.all(self.completion >= 1.0 - 1e-9))
        return self._done


class MCTSSlow(OptimizerProcedure):
    def __init__(
        self,
        space: ConfigSpace,
        iterations: int = 300,
        top_k: int = 10,
        sample_services: int = 5,
        ucb_c: float = 0.8,
        pool_size: int = 12,
        seed: int = 0,
    ):
        super().__init__(space)
        self.iterations = iterations
        self.top_k = top_k
        self.sample_services = sample_services
        self.ucb_c = ucb_c
        self.pool_size = pool_size
        self.rng = np.random.default_rng(seed)
        self._pool_cache: Dict[bytes, np.ndarray] = {}
        self._rollout_memo: Dict[bytes, Tuple[float, List[int]]] = {}
        # scratch for pool scoring and rollout state (single-threaded hot
        # loops; nothing here escapes the method that fills it)
        self._score_buf = np.empty(len(space))
        self._score_buf2 = np.empty(len(space))
        n = space.workload.n
        self._need_buf = np.empty(n)
        self._scaled_buf = np.empty(n)
        self._q_buf = np.empty(n, dtype=np.int64)
        self._c_buf = np.empty(n)
        self._unmet_buf = np.empty(n, dtype=bool)

    def _pick(self, seq) -> int:
        """Uniform draw from ``seq`` — same stream as ``rng.choice(seq)``
        (which reduces to ``integers(0, len)``) minus its array-conversion
        and shape-handling overhead on this per-step hot path."""
        return seq[int(self.rng.integers(0, len(seq)))]

    def _scores_into_scratch(self, need: np.ndarray) -> np.ndarray:
        """``score_all`` for a residual-need vector, gathered into the
        shared scratch buffers (valid until the next call; ia/ib are always
        in-bounds, so clip mode just skips the bounds check)."""
        space = self.space
        scores = np.take(need, space.ia, out=self._score_buf, mode="clip")
        scores *= space.ua
        sb = np.take(need, space.ib, out=self._score_buf2, mode="clip")
        sb *= space.ub
        scores += sb
        return scores

    # -- edge generation: the paper's top-K child cut ---------------------------
    def _edges(self, completion: np.ndarray) -> List[int]:
        space = self.space
        unmet = np.where(completion < 1.0 - 1e-9)[0]
        if len(unmet) == 0:
            return []
        k = min(self.sample_services, len(unmet))
        picked = self.rng.choice(unmet, size=k, replace=False)
        mask = np.logical_or.reduce(space.service_masks[picked])
        scores = self._scores_into_scratch(np.maximum(1.0 - completion, 0.0))
        # zero out configs missing the sampled services: scores are >= 0, so
        # every positive survivor is in-mask and the filtered edge list (and
        # its order) is identical to masking with -1
        scores *= mask
        order = _top_k_desc(scores, self.top_k)
        return [int(i) for i in order if scores[i] > 0.0]

    # -- memoized randomized estimation (Appendix A.2) ---------------------------
    def _pool_for(self, sig: bytes, need: np.ndarray) -> np.ndarray:
        """Pool of good candidate configs for one completion *type*.

        ``need`` must equal ``max(1 - completion, 0)`` for the completion the
        signature was taken from; scoring gathers directly from it, skipping
        the re-derivation ``score_all`` would do.
        """
        pool = self._pool_cache.get(sig)
        if pool is None:
            scores = self._scores_into_scratch(need)
            order = _top_k_desc(scores, self.pool_size)
            pool = order[scores[order] > 0.0]
            self._pool_cache[sig] = pool
        return pool

    def _pool(self, completion: np.ndarray) -> np.ndarray:
        return self._pool_for(
            _bucket_signature(completion), np.maximum(1.0 - completion, 0.0)
        )

    def _apply(self, c: np.ndarray, idx: int) -> None:
        """``c += utility_of(idx)`` as two indexed adds (no allocation)."""
        space = self.space
        c[space.ia[idx]] += space.ua[idx]
        c[space.ib[idx]] += space.ub[idx]

    def _rollout(self, completion: np.ndarray) -> Tuple[float, List[int]]:
        """Estimated #devices to finish from here, plus the config sequence."""
        # incremental rollout state: residual need, its bucketed signature,
        # and the unmet count — a step touches <= 2 services, so each update
        # is two scalar refreshes instead of three full-vector passes.  The
        # entry signature is the bucketed vector's bytes, so the memo key
        # falls out of the state initialization for free.
        need, scaled, q = self._need_buf, self._scaled_buf, self._q_buf
        np.subtract(1.0, completion, out=need)
        np.maximum(need, 0.0, out=need)
        np.multiply(need, float(_BUCKETS), out=scaled)
        np.ceil(scaled, out=scaled)
        np.minimum(scaled, float(_BUCKETS), out=scaled)
        q[...] = scaled  # integral floats in [0, 8]: cast is exact
        sig = q.tobytes()
        memo_map = self._rollout_memo
        memo = memo_map.get(sig)
        if memo is not None:
            return memo
        space = self.space
        ia, ib, ua, ub = space.ia, space.ib, space.ua, space.ub
        c = self._c_buf
        np.copyto(c, completion)
        unmet = self._unmet_buf
        np.less(c, 1.0 - 1e-9, out=unmet)
        n_unmet = int(np.count_nonzero(unmet))
        path: List[int] = []
        append = path.append
        pool_for = self._pool_for
        draw = self.rng.integers
        bucket_of = _bucket_of
        thr = 1.0 - 1e-9
        steps = 0.0
        pool = None  # invariant: valid for the current q whenever not None
        while n_unmet:
            if pool is None:
                pool = pool_for(q.tobytes(), need)
                if not len(pool):
                    # residual unsatisfiable via the pools: bail with +inf
                    memo_map[sig] = (math.inf, [])
                    return math.inf, []
            idx = pool[draw(0, len(pool))]
            i1 = ia[idx]
            i2 = ib[idx]
            c[i1] += ua[idx]
            c[i2] += ub[idx]
            ci = c[i1]
            v = 1.0 - ci
            nv = v if v > 0.0 else 0.0
            need[i1] = nv
            b = bucket_of(nv)
            if b != q[i1]:
                q[i1] = b
                pool = None  # signature moved: next step re-resolves
            now = ci < thr
            if unmet[i1] != now:
                unmet[i1] = now
                n_unmet += 1 if now else -1
            if i1 != i2:
                ci = c[i2]
                v = 1.0 - ci
                nv = v if v > 0.0 else 0.0
                need[i2] = nv
                b = bucket_of(nv)
                if b != q[i2]:
                    q[i2] = b
                    pool = None
                now = ci < thr
                if unmet[i2] != now:
                    unmet[i2] = now
                    n_unmet += 1 if now else -1
            append(int(idx))
            steps += 1.0
            if steps > 10_000:
                return math.inf, []
        memo_map[sig] = (steps, path)
        return steps, path

    # -- UCT for minimization -----------------------------------------------------
    def _select_child(self, node: _Node) -> Tuple[int, _Node]:
        if not node.edges:
            raise RuntimeError(
                "_select_child on a node without edges — expansion must "
                "populate edges before UCT selection"
            )
        best, best_val = None, math.inf
        log_visits = math.log(node.visits) if node.visits else 0.0
        for e in node.edges:
            child = node.children.get(e)
            if child is None or child.visits == 0:
                return e, child if child else self._make_child(node, e)
            explore = self.ucb_c * math.sqrt(log_visits / child.visits)
            q = child.q()
            val = (q if math.isfinite(q) else 1e18) - explore
            if val < best_val:
                best_val, best = val, (e, child)
        return best

    def _make_child(self, node: _Node, edge: int) -> _Node:
        c = node.completion.copy()
        self._apply(c, edge)
        child = _Node(completion=c, depth=node.depth + 1)
        node.children[edge] = child
        if node.unvisited is not None:
            node.unvisited.remove(edge)
        return child

    # -- main loop ------------------------------------------------------------------
    def produce(self, completion: np.ndarray) -> List[GPUConfig]:
        space = self.space
        root = _Node(completion=completion.astype(np.float64).copy(), depth=0)
        best_len = math.inf
        best_path: List[int] = []

        for _ in range(self.iterations):
            node = root
            path: List[int] = []
            # selection / expansion
            while not node.done():
                if node.edges is None:
                    node.edges = self._edges(node.completion)
                    node.unvisited = list(node.edges)
                if not node.edges:
                    break
                if node.unvisited:
                    e = int(self._pick(node.unvisited))
                    node = self._make_child(node, e)
                    path.append(e)
                    break
                e, node = self._select_child(node)
                path.append(e)
            # estimation
            est, suffix = self._rollout(node.completion)
            total = node.depth - root.depth + est
            if total < best_len and math.isfinite(total):
                best_len = total
                best_path = path + suffix
            # backpropagation
            back = root
            back.visits += 1
            back.total += total
            for e in path:
                back = back.children[e]
                back.visits += 1
                back.total += total

        if not best_path and not root.done():
            raise RuntimeError("MCTS found no completing path")
        # Repair: memoized rollouts are keyed by *bucketed* signatures, so a
        # reused suffix may undershoot the exact residual.  Greedily top up.
        c = completion.astype(np.float64).copy()
        out: List[int] = []
        for i in best_path:
            if not np.any(c < 1.0 - 1e-9):
                break  # drop superfluous tail configs
            self._apply(c, i)
            out.append(i)
        guard = 0
        while np.any(c < 1.0 - 1e-9):
            guard += 1
            if guard > 10_000:
                raise RuntimeError("MCTS repair failed to converge")
            scores = space.score_all(c)
            idx = int(np.argmax(scores))
            if scores[idx] <= 0.0:
                raise RuntimeError("MCTS repair: residual unsatisfiable")
            self._apply(c, idx)
            out.append(idx)
        return [space.configs[i] for i in out]
