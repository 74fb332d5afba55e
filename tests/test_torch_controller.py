"""The port's §6 controller and simulated cluster (``repro_torch.core``)
against the JAX package's ``repro.core`` run live: the same deployments,
placed and transitioned on the same cluster, give the same actions, the
same throughput trace and the same final content, exactly."""

import dataclasses
import os
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.controller import _config_content, _gpu_content  # noqa: E402
from test_torch_optimizer import synthetic, workload  # noqa: E402

PROBLEMS = [(5, 9), (5, 7), (8, 3)]


def day_night(n, seed):
    """Day and night rates drawn as the reference's benchmarks draw them
    (``benchmarks/common.py:day_night_workloads``)."""
    names = R.SyntheticPaperProfiles(n_models=n, seed=seed).services()
    rng = np.random.default_rng(seed + 42)
    day = {m: float(rng.lognormal(7.0, 0.5)) for m in names}
    night = {m: day[m] * float(rng.uniform(0.2, 0.45)) for m in names}
    return day, night


def plans(pkg, n, seed):
    """Greedy deployments for the day and the night workloads."""
    prof = pkg.SyntheticPaperProfiles(n_models=n, seed=seed)
    day, night = day_night(n, seed)
    deps = [pkg.GreedyFast(pkg.ConfigSpace(pkg.a100_rules(), prof, workload(pkg, r))).solve()
            for r in (day, night)]
    return prof, deps


def action_data(actions):
    return [dataclasses.astuple(a) for a in actions]


def report_data(rep):
    return (action_data(rep.actions), rep.serial_seconds, rep.parallel_seconds,
            rep.peak_gpus_busy, rep.final_gpus_busy, rep.action_counts)


def cluster_data(c):
    gpus = {gid: sorted(dataclasses.astuple(r) for r in g.instances.values())
            for gid, g in c.gpus.items()}
    return (gpus, sorted(c.failed), sorted(c.draining), sorted(c.cordoned), c.clock,
            c.applied_seconds, [(t, sorted(tp.items())) for t, tp in c.trace],
            sorted(c.uid_gpu.items()), action_data(c.actions_applied))


def day_to_night(pkg, n, seed, extra=2, services_per_round=None):
    prof, (dep_day, dep_night) = plans(pkg, n, seed)
    ctrl = pkg.Controller(pkg.a100_rules(), prof)
    cluster = pkg.SimulatedCluster(pkg.a100_rules(), dep_day.num_gpus + extra)
    ctrl.deploy_fresh(cluster, dep_day)
    to_night = ctrl.transition(cluster, dep_night, services_per_round=services_per_round)
    to_day = ctrl.transition(cluster, dep_day, services_per_round=services_per_round)
    return cluster, to_night, to_day, dep_day


def content(configs):
    out = Counter()
    for c in configs:
        out += _config_content(c)
    return out


@pytest.mark.parametrize("n,seed", PROBLEMS)
@pytest.mark.parametrize("services_per_round", [None, 2])
def test_transitions_match_the_reference(n, seed, services_per_round):
    rcl, rnight, rday, _ = day_to_night(R, n, seed, services_per_round=services_per_round)
    pcl, pnight, pday, dep_day = day_to_night(T, n, seed,
                                              services_per_round=services_per_round)
    assert report_data(pnight) == report_data(rnight)
    assert report_data(pday) == report_data(rday)
    assert cluster_data(pcl) == cluster_data(rcl)
    have = Counter()
    for g in pcl.gpus.values():
        have += _gpu_content(g)
    assert have == content(dep_day.configs)
    assert pnight.parallel_seconds <= pnight.serial_seconds


@pytest.mark.parametrize("n,seed", PROBLEMS)
def test_transitions_keep_every_service_served(n, seed):
    """§6 transparency on the port: through the whole day→night trace each
    service keeps at least min(day, night) of its required rate."""
    prof, (dep_day, dep_night) = plans(T, n, seed)
    day, night = day_night(n, seed)
    ctrl = T.Controller(T.a100_rules(), prof)
    cluster = T.SimulatedCluster(T.a100_rules(), dep_day.num_gpus + 2)
    ctrl.deploy_fresh(cluster, dep_day)
    n0 = len(cluster.trace)
    ctrl.transition(cluster, dep_night)
    for _, tp in cluster.trace[n0:]:
        for svc in prof.services():
            assert tp.get(svc, 0.0) >= min(day[svc], night[svc]) - 1e-6


def incremental(pkg):
    side = [s for s in synthetic(12, 1, 8.0) if s.pkg is pkg][0]
    space = side.space()
    cold = pkg.TwoPhaseOptimizer(side.rules, side.prof, side.wl, space=space,
                                 ga_rounds=2, ga_population=3, mcts_iterations=40).run()
    mult = np.random.default_rng(5).uniform(0.8, 1.25, size=side.wl.n)
    new_wl = workload(pkg, {s.name: s.slo.throughput * float(k)
                            for s, k in zip(side.wl.services, mult)})
    rebound = space.rebind(new_wl)
    inc = pkg.IndexedDeployment.from_deployment(rebound, cold.best_deployment)
    warm = pkg.TwoPhaseOptimizer(side.rules, side.prof, new_wl, space=rebound,
                                 incumbent=inc, incumbent_workload=side.wl,
                                 ga_rounds=2, ga_population=3, mcts_iterations=40).run()
    ctrl = pkg.Controller(side.rules, side.prof)
    cluster = pkg.SimulatedCluster(side.rules, cold.best_deployment.num_gpus)
    ctrl.deploy_fresh(cluster, cold.best_deployment)
    rep = ctrl.transition_incremental(cluster, warm.best_deployment)
    return cluster, rep, warm.best_deployment


def test_incremental_transition_matches_the_reference():
    rcl, rrep, _ = incremental(R)
    pcl, prep, target = incremental(T)
    assert report_data(prep) == report_data(rrep)
    assert cluster_data(pcl) == cluster_data(rcl)
    have = Counter()
    for g in pcl.gpus.values():
        have += _gpu_content(g)
    assert have == content(target.configs)
    kinds = [a.kind for a in prep.actions]
    if "create" in kinds and "delete" in kinds:  # creates strictly first
        assert max(i for i, k in enumerate(kinds) if k == "create") < kinds.index("delete")


def faults(pkg, n=8, seed=3):
    """A failed card and a drained machine, then a transition around them."""
    prof, (dep_day, dep_night) = plans(pkg, n, seed)
    ctrl = pkg.Controller(pkg.a100_rules(), prof)
    cluster = pkg.SimulatedCluster(pkg.a100_rules(), 12)
    ctrl.deploy_fresh(cluster, dep_day)
    killed = cluster.fail_gpu(1)
    drained = cluster.drain_machine(1)
    grown = cluster.grow(3)
    rep = ctrl.transition(cluster, dep_night)
    room = [cluster.find_room(s) for s in (1, 3, 4, 7)]
    return cluster, rep, (killed, drained, grown, room)


def test_failures_and_drains_match_the_reference():
    rcl, rrep, rextra = faults(R)
    pcl, prep, pextra = faults(T)
    assert pextra == rextra
    assert pextra[0] and pextra[1]
    assert report_data(prep) == report_data(rrep)
    assert cluster_data(pcl) == cluster_data(rcl)
    assert all(g not in pcl.failed for g in pextra[2])
    for a in prep.actions:
        assert not set(a.gpus_touched()) & pcl.failed


def test_fault_hook_and_makespan_match_the_reference():
    def run(pkg):
        prof, (dep_day, dep_night) = plans(pkg, 5, 9)
        cluster = pkg.SimulatedCluster(pkg.a100_rules(), dep_day.num_gpus + 2)
        pkg.Controller(pkg.a100_rules(), prof).deploy_fresh(cluster, dep_day)
        calls = []

        def hook(a):
            calls.append(a.kind)
            if len(calls) == 2:
                raise pkg.cluster.ActionFault(a, "injected", 5.0)
            return 1.5 if a.kind == "create" else 1.0

        cluster.fault_hook = hook
        act = pkg.Action("create", dep_day.num_gpus, size=3, service=prof.services()[0],
                         throughput=1.0)
        cluster.apply(act)
        with pytest.raises(pkg.cluster.ActionFault, match="injected"):
            cluster.apply(pkg.Action("delete", dep_day.num_gpus, uid=max(cluster.uid_gpu)))
        acts = cluster.actions_applied
        spans = [pkg.parallel_makespan(acts),
                 pkg.parallel_makespan(acts, seconds=cluster.applied_seconds),
                 pkg.parallel_makespan(acts, max_concurrent=2)]
        return cluster_data(cluster), spans

    assert run(T) == run(R)
