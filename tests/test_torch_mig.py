"""The port's rule-sets and synthetic profiles against the JAX package's
``repro.core``, run live on the same inputs (exact equality: both are the
same numpy/stdlib operations), and the H100 rule-sets that replace its TPU
slice rules."""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import mig as ref_mig  # noqa: E402
from repro.core.rms import validate_partition_universe as ref_validate  # noqa: E402
from repro_torch.core import mig as port_mig  # noqa: E402
from repro_torch.core.arch_bridge import h100_arch_profiles, h100_node_profiles  # noqa: E402
from repro_torch.core.rms import validate_partition_universe  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

MIG_SIZES = (1, 2, 3, 4, 7)
NODE_SIZES = (7, 14, 28, 56)
SYNTHETIC_CASES = [(5, 9), (12, 1), (24, 0), (49, 0)]


def multisets(sizes, total):
    """Every sorted multiset of ``sizes`` summing to at most ``total``."""
    out = [()]
    for k in range(1, total // min(sizes) + 1):
        for combo in itertools.combinations_with_replacement(sizes, k):
            if sum(combo) <= total:
                out.append(tuple(sorted(combo)))
    return out


# -- rule-sets ---------------------------------------------------------------


def test_a100_rules_legal_and_full_partitions_match_the_reference():
    ref, port = R.a100_rules(), T.a100_rules()
    assert port.legal_partitions() == ref.legal_partitions()
    assert port.full_partitions() == ref.full_partitions()
    assert (port.device_size, tuple(port.instance_sizes)) == (7, MIG_SIZES)
    assert port.max_instances() == ref.max_instances()
    assert port_mig.PLACEMENTS == ref_mig.PLACEMENTS
    assert port_mig.FORBIDDEN_PAIRS == ref_mig.FORBIDDEN_PAIRS
    validate_partition_universe(port)
    ref_validate(ref)


@pytest.mark.parametrize("partition", multisets(MIG_SIZES, 7), ids=str)
def test_a100_is_legal_partition_matches_the_reference(partition):
    ref, port = R.a100_rules(), T.a100_rules()
    assert port.is_legal_partition(partition) == ref.is_legal_partition(partition)
    assert port.partition_slack(partition) == ref.partition_slack(partition)


def test_a100_rule_reconf_matches_the_reference():
    ref, port = R.a100_rules(), T.a100_rules()
    parts = ref.legal_partitions()
    subs = multisets(MIG_SIZES, 7)[:12]
    for p in parts:
        for mset in subs:
            for new in subs:
                assert port.rule_reconf(mset, new, p) == ref.rule_reconf(mset, new, p)


def test_a100_rules_is_a_module_singleton():
    """TwoPhaseOptimizer checks ``space.rules is rules``: every call must
    hand out the same object, as the reference's lru_cache does."""
    assert T.a100_rules() is T.a100_rules()
    assert T.h100_mig_rules() is T.h100_mig_rules()
    assert T.h100_node_rules() is T.h100_node_rules()


def test_h100_mig_rules_equal_the_a100_rules():
    """The H100's rules are the A100's placements and 4+3 exception, less
    the partitions whose profiles overfill the card's 8 memory slices."""
    a100, h100 = R.a100_rules(), T.h100_mig_rules()
    assert isinstance(h100, T.H100MigRules)
    assert (h100.device_size, tuple(h100.instance_sizes)) == (7, MIG_SIZES)

    def fits_memory(p):
        return sum(hw.MIG_MEMORY_SLICES[s] for s in p) <= hw.MEMORY_SLICES

    want = [p for p in a100.legal_partitions() if fits_memory(p)]
    assert h100.legal_partitions() == want
    assert sorted(set(a100.legal_partitions()) - set(want)) == [(1, 3, 3)]
    for p in multisets(MIG_SIZES, 7):
        assert h100.is_legal_partition(p) == (a100.is_legal_partition(p) and fits_memory(p))
    # 1g + 3g + 3g needs 9 memory slices (90 GB of an 80 GB card); the
    # paper's A100 keeps it
    assert not h100.is_legal_partition((1, 3, 3))
    assert a100.is_legal_partition((1, 3, 3))
    # the paper's exception is carried over: 4+3 is out, 3+3 and 1+2+4 are in
    assert not h100.is_legal_partition((3, 4))
    assert h100.is_legal_partition((3, 3))
    assert h100.is_legal_partition((1, 2, 4))
    validate_partition_universe(h100)


def test_h100_node_rules_accept_exactly_the_multisets_up_to_a_node():
    rules = T.h100_node_rules()
    assert (rules.device_size, tuple(rules.instance_sizes)) == (56, NODE_SIZES)
    want = sorted(p for p in multisets(NODE_SIZES, 56) if p)
    assert rules.legal_partitions() == want
    for p in multisets((7, 14, 21, 28, 35, 56), 63):
        legal = all(s in NODE_SIZES for s in p) and sum(p) <= 56
        assert rules.is_legal_partition(p) == legal, p
    # full: no group of one more card fits, i.e. all eight cards are used
    assert rules.full_partitions() == sorted(p for p in want if sum(p) == 56)
    assert len(rules.full_partitions()) == 10
    validate_partition_universe(rules)


# -- synthetic profiles -------------------------------------------------------


def _profile_tables(prof):
    names = prof.services()
    lat = np.array([[[prof.latency_ms(m, s, b) for b in R.profiles.BATCH_CANDIDATES]
                     for s in prof.sizes()] for m in names])
    tput = np.array([[[prof.throughput(m, s, slo) for slo in (5.0, 20.0, 100.0, 1e9)]
                      for s in prof.sizes()] for m in names])
    classes = [(prof.classify(m), prof.classify(m, 100.0)) for m in names]
    return names, tuple(prof.sizes()), lat, tput, classes, [prof.min_size(m) for m in names]


@pytest.mark.parametrize("n,seed", SYNTHETIC_CASES)
def test_synthetic_paper_profiles_match_the_reference(n, seed):
    ref = _profile_tables(R.SyntheticPaperProfiles(n_models=n, seed=seed))
    port = _profile_tables(T.SyntheticPaperProfiles(n_models=n, seed=seed))
    assert port[0] == ref[0] and port[1] == ref[1]
    assert np.array_equal(port[2], ref[2])
    assert np.array_equal(port[3], ref[3])
    assert port[4] == ref[4] and port[5] == ref[5]
    assert set(c for c, _ in port[4]) <= {"sub-linear", "linear", "super-linear"}


# -- the H100 chip and the node profiles --------------------------------------


def test_h100_chip_takes_multiples_of_seven_as_whole_cards():
    chip = hw.H100MigChip()
    for n in (1, 2, 4, 8, 3):
        size = 7 * n
        assert chip.flops(size) == hw.PEAK_FLOPS_BF16 * n
        assert chip.hbm_bw(size) == hw.HBM_BW * n
        assert chip.hbm_bytes(size) == hw.HBM_BYTES * n
    for bad in (0, -7, 5, 6, 8, 13, 16, 57):
        with pytest.raises(ValueError, match="MIG"):
            chip.hbm_bw(bad)


def test_node_profiles_hold_deepseek_v2_on_eight_cards_and_no_larger_model():
    prof = h100_node_profiles(["deepseek-v2-236b", "llama3-405b", "deepseek-v3-671b"])
    assert tuple(prof.sizes()) == NODE_SIZES
    assert prof.min_size("deepseek-v2-236b") == 56
    assert not any(prof.feasible("deepseek-v2-236b", s) for s in (7, 14, 28))
    for arch in ("llama3-405b", "deepseek-v3-671b"):
        assert not any(prof.feasible(arch, s) for s in NODE_SIZES)
        with pytest.raises(ValueError, match="fits on no instance size"):
            prof.min_size(arch)
    # one service that needs the whole node: one-config deployments only
    wl = T.Workload.make({"deepseek-v2-236b": T.SLO(
        prof.throughput("deepseek-v2-236b", 56, 100.0) * 2.5, 100.0)})
    rep = T.TwoPhaseOptimizer(T.h100_node_rules(), prof, wl, ga_rounds=2,
                              ga_population=2, mcts_iterations=20, seed=0).run()
    assert rep.best_deployment.is_valid(wl)
    assert rep.best_deployment.num_gpus == 3
    assert all(c.partition == (56,) for c in rep.best_deployment.configs)
    assert T.lower_bound_gpus(T.h100_node_rules(), prof, wl) == 3


def test_node_profiles_agree_with_the_mig_profiles_on_one_card():
    """Size 7 is one card under both granularities."""
    archs = ["qwen3-8b", "mamba2-370m", "granite-20b"]
    mig, node = h100_arch_profiles(archs), h100_node_profiles(archs)
    for a in archs:
        for b in R.profiles.BATCH_CANDIDATES:
            assert node.latency_ms(a, 7, b) == mig.latency_ms(a, 7, b)
        assert math.isfinite(node.latency_ms(a, 56, 1))
