"""Constraint-free GPU lower bound (§8 "lower-bound" baseline).

The paper computes "a lower bound of GPU usage by ignoring MIG's hardware
constraints": assume any instance combination is possible and every service
always runs on its most cost-efficient instance size.  Then

    slices_needed(service) = required_tput / (best per-slice tput)
    GPUs_lb = ceil( Σ_s slices_needed(s) / device_size )

This is likely unachievable (it ignores partition legality and instance
granularity) — MIG-Serving lands within 3% of it (§8.1).

The port's copy of the JAX package's ``core/lower_bound.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import math

from repro_torch.core.deployment import Workload
from repro_torch.core.profiles import PerfProfile
from repro_torch.core.rms import ReconfigRules


def lower_bound_gpus(
    rules: ReconfigRules, profile: PerfProfile, workload: Workload
) -> int:
    total_slices = 0.0
    for svc in workload.services:
        best_eff = 0.0
        for size in rules.instance_sizes:
            t = profile.throughput(svc.name, size, svc.slo.latency_ms)
            if t > 0:
                best_eff = max(best_eff, t / size)
        if best_eff <= 0:
            raise ValueError(f"service {svc.name} infeasible on all sizes")
        total_slices += svc.slo.throughput / best_eff
    return math.ceil(total_slices / rules.device_size - 1e-9)


def baseline_homogeneous(
    rules: ReconfigRules,
    profile: PerfProfile,
    workload: Workload,
    size: int,
) -> int:
    """Static homogeneous partition baselines (§2.3): every device is carved
    into ``device_size // size`` instances of one size (A100-7×1/7 uses
    size=1; A100-7/7 uses size=device_size).  Greedy assignment is exact here
    because instances are identical (Identical Parallel Machine Scheduling
    with long-running jobs = per-service ceiling)."""
    per_dev = rules.device_size // size
    total_instances = 0
    for svc in workload.services:
        t = profile.throughput(svc.name, size, svc.slo.latency_ms)
        if t <= 0:
            return -1  # some service cannot run at this size at all
        total_instances += math.ceil(svc.slo.throughput / t - 1e-9)
    return math.ceil(total_instances / per_dev - 1e-9)


def baseline_static_mix(
    rules: ReconfigRules,
    profile: PerfProfile,
    workload: Workload,
    partition=None,
) -> int:
    """A100-MIX baseline (§8): every device uses one fixed heterogeneous
    partition (default "4-2-1") and runs a single service per device."""
    if partition is None:
        # the paper's 4-2-1 mix; any other device size takes the reference's
        # 8-4-2-1-1 (its TPU-domain mix), kept so both packages agree
        partition = (4, 2, 1) if rules.device_size == 7 else (8, 4, 2, 1, 1)
    gpus = 0
    for svc in workload.services:
        per_gpu = 0.0
        for size in partition:
            per_gpu += profile.throughput(svc.name, size, svc.slo.latency_ms)
        if per_gpu <= 0:
            return -1
        gpus += math.ceil(svc.slo.throughput / per_gpu - 1e-9)
    return gpus
