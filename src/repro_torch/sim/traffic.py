"""Traffic traces: per-service arrival rates over time.

The paper's live experiments (§8.2, Figures 13-14) replay real day/night
traffic against the serving cluster; the related MIG-scheduling literature
(arXiv:2606.25082, arXiv:2512.16099) evaluates against time-varying arrival
traces more generally.  This module is the trace vocabulary for the
closed-loop simulator (the JAX package's ``sim/simulator.py``): a
:class:`Trace` is a binned per-service arrival-rate function, and the
generators below produce the canonical shapes —

  * :func:`diurnal_trace`          — smooth day/night cycle (Figure 13's scenario)
  * :func:`poisson_burst_trace`    — background rate with seeded burst episodes
  * :func:`flash_crowd_trace`      — a sudden flash crowd with ramp up/decay
  * :func:`correlated_surge_trace` — surges hitting *all* services at once
  * :func:`replay_trace`           — replay externally recorded rate arrays

All randomness flows from explicit seeds so a trace (and every simulation
run on it) is reproducible bit-for-bit.

The port's copy of the JAX package's ``sim/traffic.py``, op for op: each
generator draws the same numbers in the same order (services in sorted
order), so its arrays equal the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

# request importance classes, highest first.  The index IS the priority
# (0 = most important): the token serving model admits lower indices first,
# prefers higher indices as preemption victims, and degraded-mode admission
# control sheds higher indices first.
PRIORITY_CLASSES: Tuple[str, ...] = ("critical", "standard", "batch")
STANDARD_CLASS: int = PRIORITY_CLASSES.index("standard")


@dataclasses.dataclass(frozen=True)
class PriorityMix:
    """How requests acquire a priority class and an SLO deadline.

    Every request drawn under a mix gets a class (index into
    :data:`PRIORITY_CLASSES`) and an *absolute* deadline
    ``arrival + deadline_s[class]`` — the SLO the request is worth serving
    against; a request still queued past its deadline is dropped (goodput,
    not throughput).  Classes are assigned either per-service
    (``per_service`` pins a service's every request to one class, consuming
    no randomness) or by a seeded per-request draw over ``weights``.  All
    draws flow from the simulator's single rng, so a mix keeps the
    byte-identical-report contract.
    """

    # per-class draw weights (critical, standard, batch); normalized
    weights: Tuple[float, ...] = (0.2, 0.6, 0.2)
    # per-class relative SLO deadline in seconds; inf = deadline-less
    deadline_s: Tuple[float, ...] = (3.0, 12.0, math.inf)
    # svc -> class name: pin a whole service to one class (no rng draw)
    per_service: Optional[Mapping[str, str]] = None

    def __post_init__(self):
        # fail fast with actionable messages, not a mid-run IndexError
        n = len(PRIORITY_CLASSES)
        if len(self.weights) != n or len(self.deadline_s) != n:
            raise ValueError(
                f"weights and deadline_s need one entry per class "
                f"{PRIORITY_CLASSES}, got {len(self.weights)} and "
                f"{len(self.deadline_s)}"
            )
        if any(w < 0.0 for w in self.weights) or sum(self.weights) <= 0.0:
            raise ValueError(
                f"weights must be non-negative with a positive sum, "
                f"got {self.weights}"
            )
        if any(d <= 0.0 for d in self.deadline_s):
            raise ValueError(
                f"deadlines must be positive (inf = deadline-less), "
                f"got {self.deadline_s}"
            )
        for svc, name in (self.per_service or {}).items():
            if name not in PRIORITY_CLASSES:
                raise ValueError(
                    f"per_service[{svc!r}] = {name!r} is not a priority "
                    f"class; valid: {list(PRIORITY_CLASSES)}"
                )

    def class_of(self, svc: str, rng: np.random.Generator) -> int:
        """The class index of one request of ``svc``.  Pinned services
        consume no randomness; everything else is one seeded draw."""
        if self.per_service:
            pinned = self.per_service.get(svc)
            if pinned is not None:
                return PRIORITY_CLASSES.index(pinned)
        total = float(sum(self.weights))
        u = float(rng.random()) * total
        acc = 0.0
        for c, w in enumerate(self.weights):
            acc += w
            if u < acc:
                return c
        return len(PRIORITY_CLASSES) - 1


@dataclasses.dataclass(frozen=True)
class Trace:
    """Per-service arrival rates (req/s), piecewise-constant over fixed bins.

    ``rates[svc][k]`` is the arrival rate of ``svc`` during
    ``[k * bin_s, (k+1) * bin_s)``.
    """

    bin_s: float
    rates: Dict[str, np.ndarray]

    def __post_init__(self):
        # input validation as real exceptions, not asserts: these must fire
        # even under ``python -O``, where asserts are compiled away
        if self.bin_s <= 0:
            raise ValueError(f"bin width must be positive, got {self.bin_s}")
        if not self.rates:
            raise ValueError("trace needs at least one service")
        n = {len(r) for r in self.rates.values()}
        if len(n) != 1:
            raise ValueError(
                f"all services must cover the same bins, got lengths {sorted(n)}"
            )

    @property
    def services(self) -> list:
        return sorted(self.rates)

    @property
    def num_bins(self) -> int:
        return len(next(iter(self.rates.values())))

    @property
    def duration_s(self) -> float:
        return self.num_bins * self.bin_s

    def bin_of(self, t: float) -> int:
        """Bin index of time ``t``, clamped to the trace's ends."""
        return max(0, min(int(t // self.bin_s), self.num_bins - 1))

    def rate_at(self, svc: str, t: float) -> float:
        return float(self.rates[svc][self.bin_of(t)])

    def rates_at(self, t: float) -> Dict[str, float]:
        k = self.bin_of(t)
        return {svc: float(r[k]) for svc, r in self.rates.items()}

    def mean_rates(self, t0: float, t1: float) -> Dict[str, float]:
        """Mean per-service rate over the window [t0, t1) — what a
        re-optimizer observes from its metrics backend.

        The mean is time-weighted: a bin only partially covered by the
        window contributes in proportion to the overlap, so a window that is
        not a bin multiple no longer over-weights its edge bins (the bias
        the reoptimizer would otherwise observe whenever
        ``reoptimize_every_s`` is not a multiple of ``bin_s``).  Bin-aligned
        windows take the unweighted path, bit-identical to the historical
        behavior (the simulator's report bytes depend on them)."""
        k0, k1 = self.bin_of(t0), self.bin_of(max(t1 - 1e-9, t0))
        edges = np.arange(k0, k1 + 2, dtype=np.float64) * self.bin_s
        w = np.clip(
            np.minimum(edges[1:], t1) - np.maximum(edges[:-1], t0), 0.0, None
        )
        total = float(w.sum())
        if total <= 0.0 or np.all(w == self.bin_s):
            return {
                svc: float(np.mean(r[k0 : k1 + 1]))
                for svc, r in self.rates.items()
            }
        return {
            svc: float(np.sum(r[k0 : k1 + 1] * w) / total)
            for svc, r in self.rates.items()
        }


def _bins(duration_s: float, bin_s: float) -> int:
    n = int(round(duration_s / bin_s))
    if n < 1:
        raise ValueError(
            f"trace must span at least one bin "
            f"(duration_s={duration_s}, bin_s={bin_s})"
        )
    return n


def diurnal_trace(
    peak_rates: Mapping[str, float],
    duration_s: float,
    bin_s: float = 60.0,
    night_frac: float = 0.3,
    phase_s: float = 0.0,
    period_s: Optional[float] = None,
    jitter: float = 0.0,
    seed: int = 0,
) -> Trace:
    """Day/night cycle: a raised cosine between ``night_frac * peak`` at the
    trough and ``peak`` at midday, with optional multiplicative jitter."""
    if not 0.0 <= night_frac <= 1.0:
        raise ValueError(f"night_frac must be in [0, 1], got {night_frac}")
    n = _bins(duration_s, bin_s)
    period = period_s if period_s is not None else duration_s
    t = (np.arange(n) + 0.5) * bin_s + phase_s
    # cos phase 0 at midday; shift so the trace starts at midday
    wave = 0.5 * (1.0 + np.cos(2.0 * np.pi * t / period))
    shape = night_frac + (1.0 - night_frac) * wave
    rng = np.random.default_rng(seed)
    rates = {}
    for svc in sorted(peak_rates):
        noise = rng.normal(1.0, jitter, size=n) if jitter > 0 else 1.0
        rates[svc] = np.maximum(peak_rates[svc] * shape * noise, 0.0)
    return Trace(bin_s, rates)


def poisson_burst_trace(
    base_rates: Mapping[str, float],
    duration_s: float,
    bin_s: float = 60.0,
    burst_mult: float = 3.0,
    burst_prob: float = 0.05,
    burst_len_bins: int = 3,
    seed: int = 0,
) -> Trace:
    """Background rate with seeded burst episodes: each bin opens a burst
    with probability ``burst_prob``; a burst multiplies the rate by
    ``burst_mult`` for ``burst_len_bins`` bins (bursts may overlap-extend)."""
    n = _bins(duration_s, bin_s)
    rng = np.random.default_rng(seed)
    rates = {}
    for svc in sorted(base_rates):
        mult = np.ones(n)
        starts = np.nonzero(rng.random(n) < burst_prob)[0]
        for s in starts:
            mult[s : s + burst_len_bins] = burst_mult
        rates[svc] = base_rates[svc] * mult
    return Trace(bin_s, rates)


def flash_crowd_trace(
    base_rates: Mapping[str, float],
    duration_s: float,
    at_s: float,
    bin_s: float = 60.0,
    mult: float = 5.0,
    ramp_s: float = 120.0,
    decay_s: float = 600.0,
) -> Trace:
    """A flash crowd arriving at ``at_s``: linear ramp to ``mult`` times the
    base over ``ramp_s``, then exponential decay back with scale ``decay_s``."""
    n = _bins(duration_s, bin_s)
    t = (np.arange(n) + 0.5) * bin_s
    shape = np.ones(n)
    ramping = (t >= at_s) & (t < at_s + ramp_s)
    shape[ramping] = 1.0 + (mult - 1.0) * (t[ramping] - at_s) / ramp_s
    after = t >= at_s + ramp_s
    shape[after] = 1.0 + (mult - 1.0) * np.exp(-(t[after] - at_s - ramp_s) / decay_s)
    return Trace(bin_s, {svc: base_rates[svc] * shape for svc in sorted(base_rates)})


def correlated_surge_trace(
    base_rates: Mapping[str, float],
    duration_s: float,
    bin_s: float = 60.0,
    surge_mult: float = 4.0,
    n_surges: int = 2,
    surge_len_bins: int = 10,
    ramp_bins: int = 2,
    correlation: float = 0.8,
    seed: int = 0,
) -> Trace:
    """Correlated multi-service surges: one shared seeded surge envelope hits
    every service *simultaneously* (a front-page event, a regional failover).

    The envelope is 0 outside surges and ramps linearly to 1 over
    ``ramp_bins`` at each surge's edges; service ``s`` follows it with
    coupling strength drawn uniformly from ``[correlation, 1]``, so

        rate_s(t) = base_s * (1 + (surge_mult - 1) * k_s * envelope(t)).

    Unlike :func:`poisson_burst_trace` (independent per-service episodes),
    the aggregate demand spike is what stresses a scheduler: every service
    needs capacity in the same bins, so there is no slack to steal.
    """
    if not 0.0 <= correlation <= 1.0:
        raise ValueError(f"correlation must be in [0, 1], got {correlation}")
    if surge_len_bins < 1 or n_surges < 1:
        raise ValueError(
            f"surge_len_bins and n_surges must be >= 1, got "
            f"{surge_len_bins} and {n_surges}"
        )
    n = _bins(duration_s, bin_s)
    rng = np.random.default_rng(seed)
    envelope = np.zeros(n)
    span = min(surge_len_bins, n)
    latest = max(n - span, 0)
    starts = sorted(
        int(s) for s in rng.integers(0, latest + 1, size=n_surges)
    )
    ramp = np.minimum(
        np.minimum(np.arange(1, span + 1), np.arange(span, 0, -1))
        / max(ramp_bins, 1),
        1.0,
    )
    for s in starts:
        seg = slice(s, s + span)
        envelope[seg] = np.maximum(envelope[seg], ramp[: n - s])
    rates = {}
    for svc in sorted(base_rates):
        k = correlation + (1.0 - correlation) * float(rng.random())
        rates[svc] = base_rates[svc] * (1.0 + (surge_mult - 1.0) * k * envelope)
    return Trace(bin_s, rates)


def replay_trace(
    rate_arrays: Mapping[str, "np.ndarray"], bin_s: float = 60.0
) -> Trace:
    """Replay externally recorded per-bin rate arrays (e.g. a production
    metrics export) as a trace."""
    return Trace(
        bin_s,
        {svc: np.asarray(arr, dtype=np.float64) for svc, arr in rate_arrays.items()},
    )
