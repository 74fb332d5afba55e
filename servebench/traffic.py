"""The one traffic generator: arrivals and lengths from a workload file.

Every seed gets the same set of sizes and arrivals, in another order, so
that two seeds load the engine alike and differ only in how the requests
fall together:

* Arrivals (open loop) repeat a period made of ``phases``, each
  ``{"seconds": s, "rate": r}``: a phase holds ``round(s * r)`` arrivals
  whose gaps are the quantiles of an exponential law (a Poisson process's
  gaps), scaled to fill the phase exactly and shuffled by the seed.  This
  is a stratified Poisson stream, not a Poisson process: the count in a
  phase does not vary (a Poisson count would, by about its square root),
  only the order of the gaps does.  One phase gives steady chat; an 8 s
  phase at r then a 2 s phase at 3r are BurstGPT-style on/off bursts.
* Lengths come in blocks (one period of arrivals, or ``block`` requests of
  a closed loop): each block holds the lognormal quantiles of its
  ``prompt`` and ``output`` laws (``median``, ``sigma``, clipped to
  ``[min, max]``), each shuffled by the seed on its own.
* Token ids are uniform over the vocabulary, drawn per request from
  ``(seed, request index)``.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np


def lognormal_quantiles(law: Dict, n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of a clipped lognormal length law, as ints."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(law["median"] * np.exp(law["sigma"] * z))
    return np.clip(x, law["min"], law["max"]).astype(np.int64)


def exponential_gaps(n: int, span: float) -> np.ndarray:
    """``n`` gaps at the mid-quantiles of an exponential law, summing to ``span``."""
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    return q / q.sum() * span


def phase_counts(arrivals: Dict) -> List[Tuple[float, int]]:
    """(seconds, arrivals) of each phase of one period."""
    return [(float(p["seconds"]), int(round(p["seconds"] * p["rate"]))) for p in arrivals["phases"]]


def period_s(arrivals: Dict) -> float:
    return sum(s for s, _ in phase_counts(arrivals))


def mean_rate(arrivals: Dict) -> float:
    return sum(n for _, n in phase_counts(arrivals)) / period_s(arrivals)


def scaled(arrivals: Dict, factor: float) -> Dict:
    """The same phases with every rate times ``factor`` (the knee sweep)."""
    return {**arrivals, "phases": [{**p, "rate": p["rate"] * factor} for p in arrivals["phases"]]}


class Lengths:
    """(prompt, output) lengths in blocks of ``block``: block ``b`` is a
    seed-shuffled copy of the laws' quantiles, drawn when first needed."""

    def __init__(self, workload: Dict, seed: int, block: int):
        self.seed, self.block = seed, block
        self.prompts = lognormal_quantiles(workload["prompt"], block)
        self.outputs = lognormal_quantiles(workload["output"], block)
        self._blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __getitem__(self, i: int) -> Tuple[int, int]:
        b, j = divmod(i, self.block)
        if b not in self._blocks:
            rng = np.random.default_rng([self.seed, 1, b])
            self._blocks[b] = (rng.permutation(self.prompts), rng.permutation(self.outputs))
        p, o = self._blocks[b]
        return int(p[j]), int(o[j])


def open_schedule(workload: Dict, seed: int, horizon_s: float,
                  arrivals: Dict = None) -> List[Tuple[float, int, int]]:
    """(due offset in s, prompt length, output length) of every arrival in
    ``[0, horizon_s)``, in due order."""
    arrivals = arrivals or workload["arrivals"]
    phases = phase_counts(arrivals)
    per_period = sum(n for _, n in phases)
    if per_period < 1:
        raise ValueError("arrival phases hold no request")
    lengths = Lengths(workload, seed, per_period)
    period = period_s(arrivals)
    out: List[Tuple[float, int, int]] = []
    k = 0
    while True:
        start = k * period
        if start >= horizon_s:
            return out
        t = start
        for ph, (secs, n) in enumerate(phases):
            if n:
                rng = np.random.default_rng([seed, 2, k, ph])
                gaps = rng.permutation(exponential_gaps(n, secs))
                for g in gaps:
                    if t < horizon_s:
                        out.append((t, *lengths[len(out)]))
                    t += g
            t = start + sum(s for s, _ in phases[:ph + 1])
        k += 1


def prompt_tokens(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: ids uniform over the vocabulary."""
    return np.random.default_rng([seed, 3, index]).integers(0, vocab, size=length).astype(np.int32)
