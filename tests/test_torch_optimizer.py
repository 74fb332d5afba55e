"""The port's MIG-Serving optimizer (``repro_torch.core``: config space,
greedy, beam, MCTS, GA, the scheduler zoo, the exact pair-space search,
bounds and the two-phase pipeline) against the JAX package's ``repro.core``
run live on the same seeded inputs.

Both packages run the same numpy operations on the same draws, so every
comparison is exact: float64 arrays with ``np.array_equal``, deployments
config by config with their throughputs, and the GA history.  The wall
clock enters only the reports' seconds, which are left out.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import ga as ref_ga  # noqa: E402
from repro.core import greedy as ref_greedy  # noqa: E402
from repro.core import mcts as ref_mcts  # noqa: E402
from repro_torch.core import ga as port_ga  # noqa: E402
from repro_torch.core import greedy as port_greedy  # noqa: E402
from repro_torch.core import mcts as port_mcts  # noqa: E402
from repro.core.mig import A100Rules as RefA100Rules  # noqa: E402
from repro_torch.core.arch_bridge import arch_perf_specs, h100_arch_profiles  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

# (n_models, seed, lognormal mean of the required rates)
PROBLEMS = [(5, 9, 7.0), (12, 1, 8.0), (24, 0, 7.4)]
IDS = [f"n{n}-seed{s}" for n, s, _ in PROBLEMS]
# the seven architectures chip_smoke.py serves on one card
ONE_CARD_ARCHS = ["qwen3-8b", "mamba2-370m", "zamba2-1.2b", "granite-20b",
                  "phi4-mini-3.8b", "internvl2-1b", "musicgen-large"]


class RefH100MigRules(RefA100Rules):
    """The reference's A100 rules under the H100's memory slices: the rule
    set of the port's ``h100_mig_rules()``, built on the reference's
    engine, so that the reference's optimizer plans on the same legality."""

    def is_legal_partition(self, partition):
        return (sum(hw.MIG_MEMORY_SLICES[s] for s in partition) <= hw.MEMORY_SLICES
                and super().is_legal_partition(partition))


# one shared instance: the optimizer checks rules by identity
REF_H100 = RefH100MigRules()


@dataclasses.dataclass
class Side:
    """One package's view of a problem."""

    pkg: object
    rules: object
    prof: object
    wl: object

    def space(self):
        return self.pkg.ConfigSpace(self.rules, self.prof, self.wl)


def workload(pkg, rates, latency_ms=100.0):
    return pkg.Workload.make({m: pkg.SLO(float(r), latency_ms) for m, r in rates.items()})


def synthetic(n, seed, scale):
    """The same seeded problem in both packages."""
    names = R.SyntheticPaperProfiles(n_models=n, seed=seed).services()
    rng = np.random.default_rng(seed)
    rates = {m: rng.lognormal(scale, 0.7) for m in names}
    return tuple(
        Side(pkg, pkg.a100_rules(), pkg.SyntheticPaperProfiles(n_models=n, seed=seed),
             workload(pkg, rates))
        for pkg in (R, T)
    )


def dep_data(configs):
    """A deployment as plain data, in config and instance order."""
    if hasattr(configs, "configs"):
        configs = configs.configs
    return [
        (tuple(c.partition),
         tuple((a.size, a.service, a.batch, a.throughput) for a in c.assignments))
        for c in configs
    ]


def report_data(rep):
    """Everything in an OptimizeReport except its wall-clock seconds."""
    return (dep_data(rep.fast_deployment), dep_data(rep.best_deployment),
            list(rep.ga_history), rep.warm, rep.warm_edits, rep.warm_fallback)


def partial_completion(n, seed):
    return np.random.default_rng(seed + 1000).uniform(0.0, 0.9, size=n)


# -- the config space -------------------------------------------------------------


SPACE_ARRAYS = ("ia", "ib", "ua", "ub", "ta", "tb", "req", "service_masks")
PACKED_ARRAYS = ("M", "row_to_orig", "orig_to_row", "step_slot", "step_size",
                 "row_len", "active", "arange")


def assert_spaces_equal(a, b):
    assert dep_data(a.configs) == dep_data(b.configs)
    assert a.partitions == b.partitions
    for name in SPACE_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert len(a.service_configs) == len(b.service_configs)
    for x, y in zip(a.service_configs, b.service_configs):
        assert np.array_equal(x, y)
    assert np.array_equal(a.util_matrix, b.util_matrix)
    ta, tb = a.packed_tables, b.packed_tables
    for name in PACKED_ARRAYS:
        assert np.array_equal(getattr(ta, name), getattr(tb, name)), name
    assert (ta.P, ta.max_len) == (tb.P, tb.max_len)
    assert all(np.array_equal(x, y) for x, y in zip(ta.M_step, tb.M_step))


@pytest.mark.parametrize("n,seed,scale", PROBLEMS, ids=IDS)
def test_config_space_matches_the_reference(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    rs, ps = ref.space(), port.space()
    assert_spaces_equal(rs, ps)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        c = rng.uniform(0.0, 1.3, size=n)
        assert np.array_equal(ps.score_all(c), rs.score_all(c))
        counts = rng.integers(0, 3, size=len(ps))
        assert np.array_equal(ps.completion_of_counts(counts), rs.completion_of_counts(counts))
    mat = rng.integers(0, 2, size=(3, len(ps)))
    assert np.array_equal(ps.completion_of_count_matrix(mat), rs.completion_of_count_matrix(mat))
    for i in rng.integers(0, len(ps), size=8):
        assert np.array_equal(ps.utility_of(int(i)), rs.utility_of(int(i)))
        assert ps.index_of(ps.configs[int(i)]) == rs.index_of(rs.configs[int(i)]) == int(i)
        assert np.array_equal(ps.utility_cached(ps.configs[int(i)]),
                              rs.utility_cached(rs.configs[int(i)]))


@pytest.mark.parametrize("n,seed,scale", PROBLEMS, ids=IDS)
def test_rebound_space_matches_the_reference_and_a_cold_build(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    mult = np.random.default_rng(seed + 7).uniform(0.5, 1.5, size=n)
    drifted = {s.name: s.slo.throughput * float(k) for s, k in zip(ref.wl.services, mult)}
    rs = ref.space().rebind(workload(R, drifted))
    ps = port.space().rebind(workload(T, drifted))
    assert ps.compatible(workload(T, drifted))
    assert_spaces_equal(rs, ps)
    assert_spaces_equal(ps, T.ConfigSpace(port.rules, port.prof, workload(T, drifted)))
    with pytest.raises(ValueError, match="rebind"):
        ps.rebind(workload(T, drifted, latency_ms=50.0))


# -- the algorithms --------------------------------------------------------------


@pytest.mark.parametrize("n,seed,scale", PROBLEMS, ids=IDS)
def test_greedy_and_beam_match_the_reference(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    rs, ps = ref.space(), port.space()
    rg, pg = R.GreedyFast(rs), T.GreedyFast(ps)
    assert dep_data(pg.solve()) == dep_data(rg.solve())
    c0 = partial_completion(n, seed)
    assert dep_data(pg.produce(c0)) == dep_data(rg.produce(c0))
    ri, pi = rg.produce_indexed(c0), pg.produce_indexed(c0)
    assert np.array_equal(pi.counts, ri.counts)
    assert dep_data(pi.extras) == dep_data(ri.extras)
    assert np.array_equal(pi.completion_rates(), ri.completion_rates())
    # the scalar packed candidate the vectorized scan is pinned to
    assert dep_data([pg._packed_candidate(c0)]) == dep_data([rg._packed_candidate(c0)])
    assert dep_data(T.BeamGreedy(ps).solve()) == dep_data(R.BeamGreedy(rs).solve())
    assert dep_data(T.BeamGreedy(ps, beam=2, branch=3).produce(c0)) == dep_data(
        R.BeamGreedy(rs, beam=2, branch=3).produce(c0))


@pytest.mark.parametrize("n,seed,scale", PROBLEMS, ids=IDS)
def test_zoo_policies_match_the_reference(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    rs, ps = ref.space(), port.space()
    weights = np.random.default_rng(seed).uniform(0.5, 2.0, size=len(ps))
    c0 = partial_completion(n, seed)
    for name in ("FragAwarePacker", "EnergyAwareRepartitioner"):
        r, p = getattr(R, name)(rs), getattr(T, name)(ps)
        assert np.array_equal(p.weights, r.weights), name
        assert dep_data(p.solve()) == dep_data(r.solve()), name
        assert np.array_equal(p.produce_indexed(c0).counts, r.produce_indexed(c0).counts)
    r, p = R.WeightedScoreGreedy(rs, weights), T.WeightedScoreGreedy(ps, weights)
    assert dep_data(p.solve()) == dep_data(r.solve())
    dep = T.GreedyFast(ps).solve()
    rdep = R.GreedyFast(rs).solve()
    assert [T.stranded_slices_of(c, port.rules) for c in dep.configs] == [
        R.stranded_slices_of(c, ref.rules) for c in rdep.configs]
    assert T.deployment_power(dep.configs) == R.deployment_power(rdep.configs)
    live = [("a", 3, 1.0), ("b", 1, 2.0)]
    assert T.PowerModel().instances_power(live, 2) == R.PowerModel().instances_power(live, 2)


@pytest.mark.parametrize("n,seed,scale", PROBLEMS, ids=IDS)
def test_mcts_matches_the_reference(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    rs, ps = ref.space(), port.space()
    c0 = partial_completion(n, seed)
    for mseed in (0, 3):
        r = R.MCTSSlow(rs, iterations=60, seed=mseed)
        p = T.MCTSSlow(ps, iterations=60, seed=mseed)
        assert dep_data(p.solve()) == dep_data(r.solve())
        assert dep_data(p.produce(c0)) == dep_data(r.produce(c0))
    need = np.random.default_rng(seed).uniform(0.0, 1.0, size=n)
    assert port_mcts._bucket_signature(need) == ref_mcts._bucket_signature(need)
    scores = np.round(np.random.default_rng(seed).uniform(0, 1, size=50), 1)  # ties
    for k in (1, 10, 60):
        assert np.array_equal(port_mcts._top_k_desc(scores, k), ref_mcts._top_k_desc(scores, k))


def test_exact_search_and_bounds_match_the_reference():
    ref, port = synthetic(4, 5, 6.5)
    rs, ps = ref.space(), port.space()
    rx, px = R.PairSpaceExact(rs), T.PairSpaceExact(ps)
    assert px.cand == rx.cand
    rdep, rdone = rx.solve(R.GreedyFast(rs).solve())
    pdep, pdone = px.solve(T.GreedyFast(ps).solve())
    assert (dep_data(pdep), pdone, px.nodes) == (dep_data(rdep), rdone, rx.nodes)
    assert pdone and pdep.is_valid(port.wl)
    assert T.per_service_lower_bound(ps) == R.per_service_lower_bound(rs)


@pytest.mark.parametrize("n,seed,scale", PROBLEMS, ids=IDS)
def test_lower_bound_and_baselines_match_the_reference(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    assert T.lower_bound_gpus(port.rules, port.prof, port.wl) == R.lower_bound_gpus(
        ref.rules, ref.prof, ref.wl)
    for size in (1, 2, 3, 4, 7):
        assert T.baseline_homogeneous(port.rules, port.prof, port.wl, size) == (
            R.baseline_homogeneous(ref.rules, ref.prof, ref.wl, size))
    for part in (None, (3, 3, 1), (2, 2, 2, 1)):
        assert T.baseline_static_mix(port.rules, port.prof, port.wl, part) == (
            R.baseline_static_mix(ref.rules, ref.prof, ref.wl, part))


@pytest.mark.parametrize("n,seed,scale", PROBLEMS[:2], ids=IDS[:2])
def test_ga_operators_match_the_reference(n, seed, scale):
    ref, port = synthetic(n, seed, scale)
    rs, ps = ref.space(), port.space()
    rdep, pdep = R.GreedyFast(rs).solve(), T.GreedyFast(ps).solve()
    rrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    rpop, ppop = [rdep], [pdep]
    for _ in range(3):
        rpop.append(R.mutate_swap(rpop[-1], rrng))
        ppop.append(T.mutate_swap(ppop[-1], prng))
    rslow = R.MCTSSlow(rs, iterations=30, seed=seed)
    pslow = T.MCTSSlow(ps, iterations=30, seed=seed)
    rpop.append(R.crossover(rpop[1], rs, rslow, rrng))
    ppop.append(T.crossover(ppop[1], ps, pslow, prng))
    assert [dep_data(d) for d in ppop] == [dep_data(d) for d in rpop]
    assert T.fitness_batch(ppop, ps) == R.fitness_batch(rpop, rs)
    assert T.fitness_batch(ppop, ps) == [port_ga._fitness(d, ps) for d in ppop]
    assert port_ga.deployment_edit_distance(ppop[0], ppop[-1]) == (
        ref_ga.deployment_edit_distance(rpop[0], rpop[-1]))
    rres = R.GeneticOptimizer(rs, rslow, population=4, rounds=3, seed=seed).run(rdep)
    pres = T.GeneticOptimizer(ps, pslow, population=4, rounds=3, seed=seed).run(pdep)
    assert (dep_data(pres.best), pres.history) == (dep_data(rres.best), rres.history)


# -- the two-phase pipeline --------------------------------------------------------


def quickstart(pkg):
    """The reference quickstart's calls (examples/quickstart.py)."""
    rules = pkg.a100_rules()
    prof = pkg.SyntheticPaperProfiles(n_models=12, seed=1)
    rng = np.random.default_rng(0)
    wl = pkg.Workload.make(
        {m: pkg.SLO(float(rng.lognormal(8.0, 0.7)), 100.0) for m in prof.services()}
    )
    classes = [prof.classify(m, 100.0) for m in prof.services()]
    opt = pkg.TwoPhaseOptimizer(rules, prof, wl, ga_rounds=3, ga_population=4,
                                mcts_iterations=60, seed=0)
    rep = opt.run()
    counts = (pkg.baseline_homogeneous(rules, prof, wl, 7),
              pkg.baseline_static_mix(rules, prof, wl),
              pkg.lower_bound_gpus(rules, prof, wl))
    return opt, rep, classes, counts


def test_quickstart_matches_the_reference():
    ropt, rrep, rcls, rcounts = quickstart(R)
    popt, prep, pcls, pcounts = quickstart(T)
    assert pcls == rcls and pcounts == rcounts
    assert report_data(prep) == report_data(rrep)
    assert prep.best_deployment.is_valid(popt.space.workload)
    assert pcounts[2] <= prep.best_deployment.num_gpus <= prep.fast_deployment.num_gpus
    assert np.array_equal(prep.best_indexed(popt.space).counts,
                          rrep.best_indexed(ropt.space).counts)


@pytest.mark.parametrize("fast,slow", [("beam", "greedy"), ("frag", "energy"),
                                       ("energy", "frag")])
def test_registry_pairs_match_the_reference(fast, slow):
    ref, port = synthetic(12, 1, 8.0)
    kw = dict(fast=fast, slow=slow, ga_rounds=2, ga_population=3, seed=2)
    rrep = R.TwoPhaseOptimizer(ref.rules, ref.prof, ref.wl, **kw).run()
    prep = T.TwoPhaseOptimizer(port.rules, port.prof, port.wl, **kw).run()
    assert report_data(prep) == report_data(rrep)
    rrep = R.TwoPhaseOptimizer(ref.rules, ref.prof, ref.wl, **kw).run(skip_phase2=True)
    prep = T.TwoPhaseOptimizer(port.rules, port.prof, port.wl, **kw).run(skip_phase2=True)
    assert report_data(prep) == report_data(rrep)


def warm_start(side, mult):
    """Solve cold, then warm-start on rates scaled per service by ``mult``."""
    space = side.space()
    cold = side.pkg.TwoPhaseOptimizer(side.rules, side.prof, side.wl, space=space,
                                      ga_rounds=2, ga_population=3,
                                      mcts_iterations=40, seed=0).run()
    new_wl = workload(side.pkg, {s.name: s.slo.throughput * float(k)
                                 for s, k in zip(side.wl.services, mult)})
    rebound = space.rebind(new_wl)
    inc = side.pkg.IndexedDeployment.from_deployment(rebound, cold.best_deployment)
    warm = side.pkg.TwoPhaseOptimizer(side.rules, side.prof, new_wl, space=rebound,
                                      incumbent=inc, incumbent_workload=side.wl,
                                      ga_rounds=2, ga_population=3,
                                      mcts_iterations=40, seed=1).run()
    return cold, warm, rebound, inc


@pytest.mark.parametrize("lo,hi,fallback", [(0.8, 1.25, None), (0.5, 0.7, None),
                                            (1.0, 3.0, "divergence")])
def test_warm_started_optimizer_matches_the_reference(lo, hi, fallback):
    ref, port = synthetic(12, 1, 8.0)
    mult = np.random.default_rng(5).uniform(lo, hi, size=ref.wl.n)
    rcold, rwarm, rspace, rinc = warm_start(ref, mult)
    pcold, pwarm, pspace, pinc = warm_start(port, mult)
    assert report_data(pcold) == report_data(rcold)
    assert report_data(pwarm) == report_data(rwarm)
    assert pwarm.warm_fallback == fallback
    assert pwarm.warm == (fallback is None)
    assert pwarm.best_deployment.is_valid(pspace.workload)
    for budget in (None, 1, 4):
        rr = ref_greedy.warm_repair(rspace, R.GreedyFast(rspace), rinc, edit_budget=budget)
        pr = port_greedy.warm_repair(pspace, T.GreedyFast(pspace), pinc, edit_budget=budget)
        if rr is None:
            assert pr is None
            continue
        assert pr[1] == rr[1]
        assert np.array_equal(pr[0].counts, rr[0].counts)
        assert dep_data(pr[0].extras) == dep_data(rr[0].extras)


def test_optimizer_refuses_a_space_built_for_other_rules():
    ref, port = synthetic(5, 9, 7.0)
    space = T.ConfigSpace(T.h100_mig_rules(), port.prof, port.wl)
    with pytest.raises(ValueError, match="different rules"):
        T.TwoPhaseOptimizer(T.a100_rules(), port.prof, port.wl, space=space)
    T.TwoPhaseOptimizer(T.h100_mig_rules(), port.prof, port.wl, space=space)


# -- the port's H100 profile in both optimizers ---------------------------------------


def h100_problem(seed):
    """The one-card architectures on the port's H100 MIG profile, one
    observation of each at size 7, rates of 1-6 times the size-7 rate."""
    prof = T.MeasuredProfile(h100_arch_profiles(ONE_CARD_ARCHS))
    rng = np.random.default_rng(seed)
    for arch in ONE_CARD_ARCHS:
        b = prof.best_batch(arch, 7, 100.0)
        prof.observe(arch, 7, b, prof.predicted(arch, 7, b) * float(rng.uniform(0.5, 0.9)))
    rates = {a: prof.throughput(a, 7, 100.0) * float(rng.uniform(1.0, 6.0))
             for a in ONE_CARD_ARCHS}
    return prof, rates


@pytest.mark.parametrize("seed", [0, 1])
def test_h100_profile_gives_the_same_plan_in_both_optimizers(seed):
    prof, rates = h100_problem(seed)
    kw = dict(ga_rounds=4, ga_population=4, mcts_iterations=60, seed=seed)
    rwl, pwl = workload(R, rates), workload(T, rates)
    assert REF_H100.legal_partitions() == T.h100_mig_rules().legal_partitions()
    rrep = R.TwoPhaseOptimizer(REF_H100, prof, rwl, **kw).run()
    prep = T.TwoPhaseOptimizer(T.h100_mig_rules(), prof, pwl, **kw).run()
    assert report_data(prep) == report_data(rrep)
    best = prep.best_deployment
    assert best.is_valid(pwl)
    assert all(T.h100_mig_rules().is_legal_partition(c.partition) for c in best.configs)
    lb = T.lower_bound_gpus(T.h100_mig_rules(), prof, pwl)
    as_is = T.baseline_homogeneous(T.h100_mig_rules(), prof, pwl, 7)
    assert lb == R.lower_bound_gpus(REF_H100, prof, rwl)
    assert lb <= best.num_gpus <= prep.fast_deployment.num_gpus
    assert best.num_gpus <= as_is


# -- chip_smoke.py's plan phase, on the CPU ---------------------------------------------


def test_chip_smoke_plan_phase_runs_on_the_cpu(capsys, monkeypatch):
    """Phase 8 is host code: its plan, checks and transition run here on
    recorded observations (rates of the order phase 5 measures)."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    from repro_torch.configs import get_config
    from repro_torch.core.arch_bridge import h100_node_profiles

    seen = []
    make = chip_smoke.recording_profiles(T.MeasuredProfile, h100_arch_profiles, seen)
    for arch, rps in zip(ONE_CARD_ARCHS + ["granite-20b"], [1.1, 1.4, 1.2, 1.1, 1.7, 2.3, 0.9, 1.0]):
        make(arch).observe(arch, 7, 8, rps)
    assert [s[0] for s in seen] == ONE_CARD_ARCHS + ["granite-20b"]
    chip_smoke.plan_mig(T, h100_arch_profiles, seen, 0)
    chip_smoke.plan_node(T, h100_node_profiles, get_config, 0)
    out = capsys.readouterr().out
    assert out.count("[plan] workload=") == 2 and "transition=day->night" in out
    assert "config=deepseek-v2-236b weights_gb=471.5 min_size=56" in out
    assert out.count("min_size=infeasible on one node") == 2
    with pytest.raises(SystemExit):  # a model phase 5 did not measure
        chip_smoke.plan_mig(T, h100_arch_profiles, seen[1:7], 0)


def test_chip_smoke_plan_gives_every_size_the_size7_correction(capsys, monkeypatch):
    """Phase 8's headline profile: every size where a model fits carries
    the correction phase 5 measured on the whole card, which also prices
    the as-is baseline; the plans corrected at size 7 only and uncorrected
    are printed beside it."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    seen = []
    make = chip_smoke.recording_profiles(T.MeasuredProfile, h100_arch_profiles, seen)
    for arch, rps in zip(ONE_CARD_ARCHS, [1.1, 1.4, 1.2, 1.1, 1.7, 2.3, 0.9]):
        make(arch).observe(arch, 7, 8, rps)
    plan = chip_smoke.plan_mig(T, h100_arch_profiles, seen, 0)
    prof = plan["profile"]
    for arch in ONE_CARD_ARCHS:
        whole = prof.correction(arch, 7)
        assert whole < 0.71  # phase 5's observation landed (§8.3's units give ~0.700)
        sizes = [s for s in prof.sizes() if prof.feasible(arch, s)]
        assert sizes and sizes[-1] == 7
        for s in sizes:
            assert prof.correction(arch, s) == pytest.approx(whole, rel=1e-12), (arch, s)
    out = capsys.readouterr().out
    for label in ("size 7 only", "none"):
        for name in ("day", "night"):
            assert f'[plan] compare="{label}" plan={name} as_is=' in out
    assert plan["deployment"].num_gpus >= 1 and set(plan["day_rates"]) == set(ONE_CARD_ARCHS)


def test_beam_breaks_score_ties_as_the_reference():
    """Six clones of one architecture at equal rates tie on every score:
    the beam's unstable ``np.argsort(-scores)`` must order them as the
    reference's does."""
    base = arch_perf_specs(["phi4-mini-3.8b"])[0]
    prof = T.RooflineProfiles([dataclasses.replace(base, name=f"clone{i}") for i in range(6)])
    rates = {f"clone{i}": 3.0 * prof.throughput("clone0", 7, 100.0) for i in range(6)}
    rs = R.ConfigSpace(REF_H100, prof, workload(R, rates))
    ps = T.ConfigSpace(T.h100_mig_rules(), prof, workload(T, rates))
    for beam, branch in ((4, 4), (2, 8), (3, 20)):
        assert dep_data(T.BeamGreedy(ps, beam, branch).solve()) == dep_data(
            R.BeamGreedy(rs, beam, branch).solve())
    c0 = np.zeros(6)
    assert len(set(ps.score_all(c0).tolist())) < len(ps)  # ties are there
