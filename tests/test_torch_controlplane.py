"""The port's control plane (``repro_torch.controlplane``: specs and the
level trigger, seeded fault injection, degraded-mode admission and the
reconciler) against the JAX package's ``repro.controlplane``, run live on
the same seeded inputs.

Both packages are the same numpy/stdlib operations on the same draws, so
every comparison is exact: fault schedules, picks and action verdicts,
admission splits to the bit, reconcile stats, the actions applied and the
partitions left.  ``chip_smoke.py`` phase 9 drives the port's control plane
through ``control_run``, which these tests run on both packages.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.controlplane as RC
import repro.core as R
import repro.obs as RO
import repro_torch.controlplane as TC
import repro_torch.core as T
import repro_torch.obs as TO
from repro.core import cluster as ref_cluster
from repro_torch.core import cluster as port_cluster

ROOT = Path(__file__).resolve().parent.parent
PROFILES = sorted(RC.FAULT_PROFILES)
SEEDS = [0, 1, 2]
# (n_models, profile seed) of the synthetic day/night problems
PROBLEM = (6, 9)


def chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    return cs


def day_night(pkg, n, seed):
    """The greedy day and night deployments of a seeded synthetic problem on
    the paper's A100 rules, and the day's required rates."""
    prof = pkg.SyntheticPaperProfiles(n_models=n, seed=seed)
    rng = np.random.default_rng(seed + 42)
    day = {m: float(rng.lognormal(7.0, 0.5)) for m in prof.services()}
    night = {m: day[m] * float(rng.uniform(0.2, 0.45)) for m in prof.services()}
    deps = []
    for rates in (day, night):
        wl = pkg.Workload.make({m: pkg.SLO(r, 100.0) for m, r in rates.items()})
        deps.append(pkg.GreedyFast(pkg.ConfigSpace(pkg.a100_rules(), prof, wl)).solve())
    return prof, deps, day


def test_package_exports_equal_the_reference():
    assert TC.__all__ == RC.__all__
    assert sorted(TC.FAULT_PROFILES) == PROFILES
    for name in PROFILES:
        assert dataclasses.asdict(TC.FAULT_PROFILES[name]) == dataclasses.asdict(
            RC.FAULT_PROFILES[name])


def test_register_fault_profile_refuses_a_taken_name():
    for pkg in (RC, TC):
        with pytest.raises(ValueError, match="already registered"):
            pkg.register_fault_profile(pkg.FaultProfile("none"))


# -- specs and the level trigger -----------------------------------------------------


def observed_data(o):
    return (o.time_s, sorted(o.instances.items()), sorted(o.partitions.items()),
            sorted(o.instance_gpu.items()), sorted(o.failed), sorted(o.draining),
            sorted(o.content().items()), sorted(o.provided().items()), o.misplaced_uids())


def diff_data(d):
    return (sorted(d.missing.items()), sorted(d.surplus.items()), d.misplaced,
            sorted(d.shortfall.items()), d.converged, d.summary())


def spec_walk(core, cp):
    """Deploy the day plan, diff it against the night plan, then fail a
    card and drain a machine and diff again; every observation recorded."""
    prof, (dep_day, dep_night), day = day_night(core, *PROBLEM)
    rules = core.a100_rules()
    cluster = core.SimulatedCluster(rules, dep_day.num_gpus + 9)
    core.Controller(rules, prof).deploy_fresh(cluster, dep_day)
    want_day = cp.DesiredState(dep_day, day)
    want_night = cp.DesiredState(dep_night, {m: r / 3 for m, r in day.items()})
    spec = cp.ClusterSpec.from_cluster(cluster, domain_of={0: "east"})
    out = [spec.machines, [spec.fault_domain_of(m) for m in (*spec.machines, 99)],
           sorted(want_day.content().items()), want_night.num_gpus]
    busy = sorted(g for g, s in cluster.gpus.items() if s.busy())
    for step in range(3):
        o = cp.ObservedState.observe(cluster, now=10.0 * step)
        out += [observed_data(o), diff_data(cp.diff(o, want_day)),
                diff_data(cp.diff(o, want_night))]
        if step == 0:
            cluster.fail_gpu(busy[0])
        elif step == 1:
            cluster.drain_machine(cluster.gpus[busy[-1]].machine)
    return out


def test_observe_and_diff_equal_the_reference():
    ref, port = spec_walk(R, RC), spec_walk(T, TC)
    assert port == ref
    assert ref[5][4] is True  # the deployed day plan is converged at first
    assert ref[-2][2]  # the drain leaves instances misplaced


# -- fault injection ---------------------------------------------------------------------


def injector_walk(cluster, cp, name, seed):
    """A profile's schedule, target picks and the verdicts of its action
    hook over a seeded sequence of actions, with the action log."""
    inj = cp.FaultInjector(cp.FAULT_PROFILES[name], seed, 3600.0)
    out = [[(f.time_s, f.kind) for f in inj.device_faults()]]
    rng = np.random.default_rng(seed)
    kinds = ["create", "delete", "repartition", "migrate"]
    for i in range(60):
        cands = sorted(set(int(x) for x in rng.integers(0, 40, size=int(rng.integers(0, 6)))))
        out.append((inj.pick_gpu(cands), inj.pick_machine(cands), inj.pick_instance(cands)))
        a = cluster.Action(kinds[i % 4], gpu=int(rng.integers(0, 8)),
                           dst_gpu=int(rng.integers(0, 16)))
        try:
            out.append(("ok", inj.action_hook(a)))
        except cluster.ActionFault as fault:
            out.append(("fault", fault.reason, fault.wasted_s, fault.action.kind, str(fault)))
    out.append([inj.backoff_s(k) for k in range(0, 6)])
    out.append(inj.action_log)
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", PROFILES)
def test_fault_injector_equals_the_reference(name, seed):
    ref = injector_walk(ref_cluster, RC, name, seed)
    port = injector_walk(port_cluster, TC, name, seed)
    assert port == ref
    profile = TC.FAULT_PROFILES[name]
    expect = profile.gpu_failures + profile.node_drains + profile.instance_crashes
    assert len(port[0]) == expect
    assert port[0] == sorted(port[0], key=lambda f: f[0])


# -- degraded-mode admission --------------------------------------------------------------


def admission_walk(cp, seed, floor):
    """``admit`` and ``admit_by_class`` on seeded demands, capacities and
    class/weight mixes (zero weights, zero and negative demands included)."""
    rng = np.random.default_rng(seed)
    ac = cp.AdmissionController(min_admit_frac=floor)
    out = []
    for _ in range(300):
        demand = float(rng.choice([0.0, -1.0, rng.exponential(50.0)], p=[0.1, 0.05, 0.85]))
        out.append(ac.admit(demand, float(rng.exponential(50.0))))
        n = int(rng.integers(1, 7))
        demands = [(int(rng.integers(0, 3)),
                    float(rng.choice([0.0, rng.uniform(0.1, 3.0)], p=[0.2, 0.8])),
                    float(rng.choice([0.0, rng.exponential(40.0)], p=[0.1, 0.9])))
                   for _ in range(n)]
        out.append(ac.admit_by_class(demands, float(rng.exponential(60.0))))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("floor", [0.0, 0.15])
def test_admission_equals_the_reference_bit_for_bit(seed, floor):
    ref, port = admission_walk(RC, seed, floor), admission_walk(TC, seed, floor)
    # repr is exact for floats and tells -0.0 from 0.0: equal bits
    assert [repr(x) for x in port] == [repr(x) for x in ref]
    assert port == ref
    # nothing admitted is negative, nothing shed is below float rounding
    for row in port[1::2]:
        for admitted, shed in row:
            assert admitted >= 0.0 and shed >= -1e-9


# -- the reconciler ------------------------------------------------------------------------


def reconcile_walk(core, cp, obs, name, seed):
    cs = chip_smoke()
    prof, (dep_day, _), day = day_night(core, *PROBLEM)
    return cs.control_run(core, cp, obs, core.a100_rules(), prof, dep_day, day, name, seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", PROFILES)
def test_reconcile_under_each_fault_profile_equals_the_reference(name, seed):
    """Deploy, fire the profile's device faults and repair, through the
    reconciler (retries, backoff and stragglers included): stats, actions
    applied, partitions, metrics and trace bytes equal the reference's."""
    ref = reconcile_walk(R, RC, RO, name, seed)
    port = reconcile_walk(T, TC, TO, name, seed)
    assert port["passes"] == ref["passes"]
    assert port["actions"] == ref["actions"]
    assert port["partitions"] == ref["partitions"]
    assert port == ref
    assert port["converged"]


def test_reconcile_without_an_injector_is_the_direct_transition():
    """The ``none`` path: one clean pass returns the controller's own
    report, so it equals a direct ``Controller.transition`` in both
    packages, and the level trigger then reads converged."""
    out = []
    for core, cp in ((R, RC), (T, TC)):
        prof, (dep_day, dep_night), day = day_night(core, *PROBLEM)
        rules = core.a100_rules()
        runs = []
        for reconcile in (True, False):
            cluster = core.SimulatedCluster(rules, dep_day.num_gpus)
            ctrl = core.Controller(rules, prof)
            ctrl.deploy_fresh(cluster, dep_day)
            if reconcile:
                rec = cp.Reconciler(ctrl)
                desired = cp.DesiredState(dep_night, day)
                rep, stats = rec.reconcile(cluster, desired)
                assert stats.to_dict()["iterations"] == 1 and not rec.diverged(cluster, desired)
            else:
                rep = ctrl.transition(cluster, dep_night)
            runs.append(([dataclasses.astuple(a) for a in rep.actions], rep.serial_seconds,
                         rep.parallel_seconds, rep.peak_gpus_busy, rep.final_gpus_busy))
        assert runs[0] == runs[1]
        out.append(runs[0])
    assert out[0] == out[1]


# -- the port on the H100's rules ----------------------------------------------------------


@pytest.mark.parametrize("name", ["gpu_loss", "drain", "chaos"])
def test_reconcile_on_h100_mig_rules_converges_with_legal_partitions(name):
    """Port only: the day plan of the one-card architectures on the H100
    MIG profile, reconciled under faults, converges and leaves every card
    legal under h100_mig_rules() (no 1+3+3: it overfills the card's memory)."""
    from repro_torch.core.arch_bridge import h100_arch_profiles

    cs = chip_smoke()
    archs = list(cs.PLAN_ARCHS)
    prof = T.MeasuredProfile(h100_arch_profiles(archs))
    rng = np.random.default_rng(3)
    rates = {a: prof.throughput(a, 7, 100.0) * float(rng.uniform(1.0, 6.0)) for a in archs}
    wl = T.Workload.make({a: T.SLO(r, 100.0) for a, r in rates.items()})
    rules = T.h100_mig_rules()
    dep = T.GreedyFast(T.ConfigSpace(rules, prof, wl)).solve()
    res = cs.control_run(T, TC, TO, rules, prof, dep, rates, name, 0)
    assert res["converged"]
    assert all(rules.is_legal_partition(p) for p in res["partitions"].values())
    assert (1, 3, 3) not in res["partitions"].values()
    assert res["faults"] and res["spans"]["events"] == len(res["faults"]) + 2


def test_chip_smoke_control_phase_runs_on_the_cpu(capsys):
    """Phase 9 is host code: its routers, reconcile passes and token model
    run here on phase 8's plan from recorded observations."""
    from repro_torch import obs, sim
    from repro_torch.configs import get_config
    from repro_torch.core.arch_bridge import h100_arch_profiles
    from repro_torch.serving import router

    cs = chip_smoke()
    archs = list(cs.PLAN_ARCHS)
    seen = []
    make = cs.recording_profiles(T.MeasuredProfile, h100_arch_profiles, seen)
    for arch, rps in zip(archs, [1.1, 1.4, 1.2, 1.1, 1.7, 2.3, 0.9]):
        make(arch).observe(arch, 7, 8, rps)
    plan = cs.plan_mig(T, h100_arch_profiles, seen, 0)
    capsys.readouterr()
    cs.control_phase(T, TC, obs, router, sim, h100_arch_profiles, get_config, plan, seen, 0)
    out = capsys.readouterr().out
    services = {a.service for c in plan["deployment"].configs for a in c.assignments
                if a.service}
    assert out.count("[route] ") == len(services)
    for fault in cs.CONTROL_FAULTS:
        assert f"[control] fault={fault} step=deploy" in out
        assert f"[control] fault={fault} step=repair" in out
    assert out.count("converged=True cards=") == len(cs.CONTROL_FAULTS)
    assert "illegal=0" in out and "illegal=1" not in out
    assert "[token] config=qwen3-8b size=7 batch=8 requests=16" in out
