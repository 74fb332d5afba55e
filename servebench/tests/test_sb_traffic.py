"""The traffic generator: deterministic per seed, the same sizes and
arrivals for every seed in another order, within the clips, bursts where
the file puts them."""

import json

import numpy as np
import pytest
from conftest import SB

from servebench import traffic

CHAT = json.loads((SB / "workloads" / "granite-20b.chat.json").read_text())
BURST = json.loads((SB / "workloads" / "mamba2-370m.burst.json").read_text())
CODE = json.loads((SB / "workloads" / "granite-20b.code.json").read_text())
BIG = 2**31 + 12345


@pytest.mark.parametrize("w", [CHAT, BURST], ids=["chat", "burst"])
def test_schedule_is_deterministic_per_seed(w):
    a = traffic.open_schedule(w, BIG, 60.0)
    assert a == traffic.open_schedule(w, BIG, 60.0)
    assert a != traffic.open_schedule(w, BIG + 1, 60.0)


@pytest.mark.parametrize("w", [CHAT, BURST], ids=["chat", "burst"])
def test_every_seed_gets_the_same_sizes_and_arrivals_in_another_order(w):
    period = traffic.period_s(w["arrivals"])
    horizon = 4 * period
    runs = [traffic.open_schedule(w, s, horizon) for s in (1, 2, BIG)]
    assert len({len(r) for r in runs}) == 1
    for key in (1, 2):
        assert len({tuple(sorted(x[key] for x in r)) for r in runs}) == 1
    # each period holds the same number of arrivals
    for r in runs:
        per = np.bincount([int(t // period) for t, _, _ in r], minlength=4)
        assert len(set(per.tolist())) == 1


@pytest.mark.parametrize("w", [CHAT, BURST, CODE], ids=["chat", "burst", "code"])
def test_lengths_stay_within_their_clips(w):
    n = 200
    lengths = traffic.Lengths(w, BIG, 16)
    ps, os_ = zip(*(lengths[i] for i in range(n)))
    assert w["prompt"]["min"] <= min(ps) and max(ps) <= w["prompt"]["max"]
    assert w["output"]["min"] <= min(os_) and max(os_) <= w["output"]["max"]
    # the quantiles' median is the law's median
    q = traffic.lognormal_quantiles(w["prompt"], 15)
    assert q[7] == w["prompt"]["median"]


def test_bursts_fall_in_their_phase():
    sched = traffic.open_schedule(BURST, 7, 40.0)
    (s_off, n_off), (s_on, n_on) = traffic.phase_counts(BURST["arrivals"])
    in_burst = [t for t, _, _ in sched if t % 10.0 >= s_off]
    assert len(in_burst) == 4 * n_on
    assert len(sched) == 4 * (n_off + n_on)
    rate_on = n_on / s_on
    rate_off = n_off / s_off
    assert rate_on == pytest.approx(3 * rate_off)
    assert traffic.mean_rate(BURST["arrivals"]) == pytest.approx((n_off + n_on) / 10.0)


def test_gaps_fill_each_phase_exactly():
    g = traffic.exponential_gaps(16, 12.5)
    assert g.sum() == pytest.approx(12.5)
    assert np.all(np.diff(g) > 0)


def test_closed_loop_blocks_repeat_the_quantiles():
    lengths = traffic.Lengths(CODE, BIG, CODE["block"])
    b = CODE["block"]
    blocks = [sorted(lengths[i][0] for i in range(k * b, (k + 1) * b)) for k in range(3)]
    assert blocks[0] == blocks[1] == blocks[2]
    assert [lengths[i] for i in range(b)] != [lengths[i] for i in range(b, 2 * b)]


def test_prompt_ids_are_in_the_vocabulary_and_seeded():
    a = traffic.prompt_tokens(BIG, 3, 500, 49152)
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 49152
    assert np.array_equal(a, traffic.prompt_tokens(BIG, 3, 500, 49152))
    assert not np.array_equal(a, traffic.prompt_tokens(BIG, 4, 500, 49152))


def test_scaled_arrivals_scale_the_mean_rate():
    assert traffic.mean_rate(traffic.scaled(BURST["arrivals"], 2.0)) == pytest.approx(
        2 * traffic.mean_rate(BURST["arrivals"]), rel=0.05)
