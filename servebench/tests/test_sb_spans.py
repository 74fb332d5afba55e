"""The card's idle time split by the program's spans (``spans.py`` and the
``engine.idle_*`` / ``model.idle_attention_share`` readers), on
synthetic traces with hand-worked numbers, and on the card, where the
spans and the device operations share the profiler's clock."""

import types

import numpy as np
import pytest

from servebench import harness, profiling, spans

# the device: busy 0-100, 300-400, 700-800 of a 1,000 ns slice (idle 70%)
OPS = [("k1", 0, 100), ("k2", 300, 400), ("k3", 700, 800)]
CPU = [
    (50, 750, "engine.step"),
    (60, 150, "engine.step.prepare"),     # idle 100-150 (host)
    (150, 450, "engine.step.model"),      # idle 150-300, 400-450 (dispatch)
    (155, 450, "aten::mm"),
    (200, 260, "model.attention"),        # idle 60
    (260, 280, "model.mlp"),
    (280, 320, "model.attention"),        # straddles the gap's end at 300: idle 20
    (450, 650, "engine.step.sync"),       # idle 450-650 (host)
    (650, 740, "engine.step.sample"),     # idle 650-700 (host), busy 700-740
    (850, 980, "engine.admit"),           # idle 850-870, 950-980 (host)
    (870, 950, "engine.admit.model"),     # idle 80 (dispatch)
    (890, 900, "model.attention"),        # idle 10
]
# idle outside every engine span: 800-850 and 980-1000


def trace(ops=OPS, cpu=CPU, window=(0, 1000)):
    return profiling.TraceData(window, list(ops), {}, {}, sorted(cpu))


def read(name, t):
    return harness.reader(name)(types.SimpleNamespace(trace=t))


def test_the_idle_slice_splits_by_the_spans():
    t = trace()
    assert read("device.idle_share", t) == pytest.approx(70.0)
    assert read("engine.idle_dispatch_share", t) == pytest.approx(15 + 5 + 8)
    assert read("engine.idle_host_share", t) == pytest.approx(5 + 20 + 5 + 2 + 3)
    assert read("model.idle_attention_share", t) == pytest.approx(6 + 2 + 1)


def test_a_gap_outside_every_span_counts_nowhere():
    # one more idle stretch, 1000-1400, with the host in no span
    t = trace(window=(0, 1400))
    assert read("device.idle_share", t) == pytest.approx(100 * 1100 / 1400)
    assert read("engine.idle_dispatch_share", t) == pytest.approx(100 * 280 / 1400)
    assert read("engine.idle_host_share", t) == pytest.approx(100 * 350 / 1400)


def test_spans_are_clipped_to_the_traced_slice():
    # the slice opens at 500: the step's host phases before it are cut off
    t = trace(window=(500, 1000))
    assert read("engine.idle_dispatch_share", t) == pytest.approx(100 * 80 / 500)
    assert read("engine.idle_host_share", t) == pytest.approx(100 * (150 + 50 + 50) / 500)


@pytest.mark.parametrize("t", [None, trace(cpu=[(c[0], c[1], "aten::mm") for c in CPU]),
                               trace(ops=[])],
                         ids=["untraced", "no-program-spans", "no-device-operations"])
def test_without_program_spans_the_readers_return_nothing(t):
    for name in ("engine.idle_dispatch_share", "engine.idle_host_share",
                 "model.idle_attention_share"):
        assert read(name, t) is None


def brute(a, b, op):
    """Interval arithmetic on integer points, the slow way."""
    pts = lambda ivs: {x for s, e in ivs for x in range(s, e)}  # noqa: E731
    p = op(pts(a), pts(b))
    out = []
    for x in sorted(p):
        if out and out[-1][1] == x:
            out[-1][1] = x + 1
        else:
            out.append([x, x + 1])
    return [tuple(iv) for iv in out]


def random_intervals(rng, n, hi=200):
    s = rng.integers(0, hi, n)
    return [(int(a), int(a + b)) for a, b in zip(s, rng.integers(0, 30, n))]


@pytest.mark.parametrize("seed", range(20))
def test_interval_arithmetic_matches_points(seed):
    rng = np.random.default_rng(seed)
    a = spans.union(random_intervals(rng, 8))
    b = spans.union(random_intervals(rng, 8))
    assert spans.union(a + b) == brute(a, b, set.union)
    assert spans.intersect(a, b) == brute(a, b, set.intersection)
    assert spans.subtract(a, b) == brute(a, b, set.difference)


@pytest.mark.parametrize("seed", range(20))
def test_the_shares_never_sum_above_the_idle_share(seed):
    rng = np.random.default_rng(seed)
    ops = [("k", s, e) for s, e in random_intervals(rng, 40, 1000)]
    cpu = []
    for name in ("engine.step", "engine.admit"):
        for s, e in random_intervals(rng, 4, 1000):
            e = s + 4 * (e - s)
            cpu.append((s, e, name))
            m = rng.integers(s, e + 1, 2)
            cpu.append((int(m.min()), int(m.max()), name + ".model"))
            cpu.append((int(m.min()), int(m.max()), "model.attention"))
    t = trace(ops, cpu)
    idle = read("device.idle_share", t)
    d, h = read("engine.idle_dispatch_share", t), read("engine.idle_host_share", t)
    a = read("model.idle_attention_share", t)
    assert 0 <= d and 0 <= h and 0 <= a <= d + 1e-9
    assert d + h <= idle + 1e-9


@pytest.mark.card
def test_a_sleep_while_sampling_is_the_engines_host_time(cuda):
    """A 5 ms sleep in ``engine.step.sample``, between two kernels, reads
    as the engine's host time: the spans and the device operations share
    one clock.  The loop's ``sb.step.<n>`` ranges around the steps keep
    their kernels.  The profiler places the card's operations up to some
    0.4 ms off the host's spans (``PERF.md`` §6), so the sleep sits a
    millisecond from its span's start."""
    import time

    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from conftest import tiny_cfg
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import Engine, Request

    model = Model(ModelConfig(**tiny_cfg("granite-20b")["model"]))
    eng = Engine(model, model.init(3, device=cuda), batch=4, max_len=128, kv_backend="paged")
    eng.admit(Request(rid=0, prompt=np.arange(1, 40, dtype=np.int32), max_new_tokens=8))
    eng.step()  # builds the kernels
    torch.cuda.synchronize()
    sample, slept, x = eng._sample, [], torch.zeros(1, device=cuda)

    def slow(row, rng):
        if not slept:
            time.sleep(0.001)
            x.add_(1)
            t0 = time.perf_counter()
            time.sleep(0.005)
            slept.append(time.perf_counter() - t0)
            x.add_(1)
        return sample(row, rng)

    eng._sample = slow
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("sb.trace"):
            for i in range(2):
                with record_function(f"sb.step.{i}"):
                    eng.step()
            torch.cuda.synchronize()
    t = profiling.parse(prof)
    assert all(t.ops_in(f"sb.step.{i}") for i in range(2))
    s, e = max(spans.idle(t), key=lambda iv: iv[1] - iv[0])
    assert e - s >= 0.9 * slept[0] * 1e9
    host = spans.subtract(spans.host(t, spans.CALLS), spans.host(t, spans.MODEL_CALLS))
    inside = sum(b - a for a, b in spans.intersect([(s, e)], host))
    print(f"sleep {slept[0] * 1e9:.0f} ns, idle gap {e - s} ns, in the engine's host "
          f"time {inside} ns ({inside / (e - s):.4f})")
    assert inside >= 0.95 * (e - s), (inside, e - s)
    assert read("engine.idle_host_share", t) >= 0.95 * 100 * (e - s) / (t.window[1] - t.window[0])
