"""The end-to-end and per-layer arithmetic on synthetic event logs."""

import math

import pytest

from servebench import counts, harness, profiling
from servebench.counts import kernels
from servebench.loop import Call, Record

NAN = math.nan
CFG = {"arch_type": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 1,
       "head_dim": 16, "d_ff": 128, "vocab_size": 256, "mlp_gated": False}
WORK = {"engine": {"kv_backend": "paged", "page_size": 16}}


def rec(i, due, admit, times, finished=NAN, prompt_len=10):
    r = Record(i, due, prompt_len, len(times) or 1)
    r.admit_start = admit
    r.first = times[0] if times else NAN
    r.times = list(times)
    r.finished = finished
    return r


def run(records, admits=(), steps=(), trace=None, window=(10.0, 20.0), quiet=None):
    return harness.Run(CFG, WORK, window, list(records), list(admits), list(steps), 7.5, trace,
                       quiet)


def read(name, r):
    return harness.reader(name)(r)


LOG = [
    rec(0, 5.0, 5.5, [6.0, 10.5, 11.0]),       # due before the window: not in ttft
    rec(1, 12.0, 12.2, [12.5, 13.0, 14.0]),    # ttft 0.5
    rec(2, 15.0, 16.0, [17.0]),                # ttft 2.0
    rec(3, 18.0, NAN, []),                     # unanswered: counts at its wait, 2.0
    rec(4, 19.0, 19.5, [21.0, 21.5]),          # first token after the close: 1.0
    rec(5, 25.0, NAN, []),                     # due after the window
]


def test_ttft_from_due_time_with_the_unanswered_at_their_wait():
    r = run(LOG)
    from servebench import stats

    assert sorted(stats.ttfts(r)) == pytest.approx([0.5, 1.0, 2.0, 2.0])
    assert read("ttft_p90_s", r) == pytest.approx(2.0)
    # the profiler started at 16.5: rec 3 and 4 fall due after it
    assert sorted(stats.ttfts(r, (10.0, 16.5))) == pytest.approx([0.5, 1.5])
    assert sorted(stats.queue_waits(r)) == pytest.approx([0.2, 0.5, 1.0, 2.0])
    assert read("engine.queue_wait_p90_s", r) == pytest.approx(1.0 + 0.7 * 1.0)


def test_every_gap_ending_in_the_window_counts():
    from servebench import stats

    r = run(LOG)
    # rec 0: 6.0->10.5 (ends in window), 10.5->11.0; rec 1: 0.5, 1.0; rec 4 ends after
    assert sorted(stats.gaps(r)) == pytest.approx([0.5, 0.5, 1.0, 4.5])
    assert stats.percentile(stats.gaps(r), 95) == pytest.approx(1.0 + 0.85 * 3.5)
    # with a profiler from 13.5 on, only the gaps ending before it
    assert stats.percentile(stats.gaps(r, (10.0, 13.5)), 95) == pytest.approx(0.5 + 0.9 * 4.0)


def test_tokens_over_the_window():
    r = run(LOG)
    # 10.5, 11.0, 12.5, 13.0, 14.0, 17.0 inside [10, 20)
    assert read("tokens_per_s", r) == pytest.approx(6 / 10.0)
    assert read("setup_s", r) == 7.5


def test_decode_step_ms_and_mfu_take_the_calls_inside_the_window():
    steps = [Call(9.9, 10.1, (20, 30), False), Call(11.0, 11.1, (21, 31), False),
             Call(12.0, 12.3, (22,), False), Call(19.95, 20.05, (5,), False)]
    admits = [Call(12.5, 12.7, (100,), False), Call(9.0, 9.5, (50,), False)]
    r = run(LOG, admits, steps)
    assert read("engine.decode_step_ms", r) == pytest.approx(1e3 * 0.4 / 2)
    fam = counts.family(CFG)
    want = 100 * (counts.seconds(*fam.decode(CFG, (21, 31)))
                  + counts.seconds(*fam.decode(CFG, (22,)))) / 0.4
    assert read("mfu.decode", r) == pytest.approx(want)
    assert read("mfu.prefill", r) == pytest.approx(
        100 * counts.seconds(*fam.prefill(CFG, 100)) / 0.2)


def trace_data():
    # window 0..1000 ns; ops: two steps' kernels and an admission's flash
    ops = [("flash_wgmma_kernel<128>", 100, 300), ("gemm", 300, 400),
           ("paged_split_mma_kernel", 500, 550), ("paged_merge_kernel", 550, 560),
           ("gemm", 560, 600), ("Memcpy HtoD", 700, 710), ("paged_split_mma_kernel", 720, 760)]
    dev = {"sb.admit.0": (100, 400), "sb.step.0": (500, 600), "sb.step.1": (700, 760)}
    host = {"sb.admit.0": (50, 420), "sb.step.0": (450, 610), "sb.step.1": (660, 770)}
    cpu = [(0, 1000, "python"), (610, 690, "aten::item")]
    return profiling.TraceData((0, 1000), ops, dev, host, cpu)


def test_device_metrics_from_the_trace():
    t = trace_data()
    assert t.busy_s() == pytest.approx(450e-9)
    steps = [Call(1.0, 1.1, (40, 17), True, "sb.step.0"), Call(1.2, 1.3, (41, 18), True, "sb.step.1"),
             Call(1.4, 1.5, (42, 19), False, "sb.step.2")]
    admits = [Call(0.5, 0.9, (300,), True, "sb.admit.0")]
    r = run([], admits, steps, t)
    assert read("device.idle_share", r) == pytest.approx(100 * (1 - 450 / 1000))
    assert read("device.kernels_per_decode_step", r) == pytest.approx((3 + 2) / 2)
    flash = kernels.flash_attention(300, 4, 1, 16)
    assert read("flash_attention_roofline", r) == pytest.approx(
        100 * 2 * counts.seconds(*flash) / 200e-9)
    paged = [kernels.paged_attention(c.lens, 4, 1, 16, 16) for c in steps[:2]]
    assert read("paged_attention_roofline", r) == pytest.approx(
        100 * 2 * sum(counts.seconds(*w) for w in paged) / 100e-9)
    assert read("ssm_scan_roofline", r) is None  # a dense model runs no scan


def test_idle_gaps_are_put_under_what_the_host_was_doing():
    gaps = dict(profiling.idle_gaps(trace_data()))
    assert gaps["loop: aten::item"] == pytest.approx((700 - 600) * 1e-9)
    assert sum(gaps.values()) == pytest.approx((1000 - 450) * 1e-9)
    top = profiling.top_ops(trace_data())
    assert top[0] == ["flash_wgmma_kernel<128>", pytest.approx(200e-9)]


def test_readers_without_their_input_return_nothing():
    r = run([])
    for name in ("ttft_p90_s", "engine.queue_wait_p90_s", "engine.decode_step_ms", "mfu.prefill", "mfu.decode",
                 "flash_attention_roofline", "device.idle_share",
                 "device.kernels_per_decode_step"):
        assert read(name, r) is None, name


def test_a_cell_asks_for_the_metrics_that_list_it_or_list_no_cells():
    bench = {
        "end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "b"}],
        "per_layer": [{"name": "p", "moves": "a", "workloads": ["x"]}, {"name": "q", "moves": "b"},
                      {"name": "r", "moves": "b", "workloads": ["y"]}],
    }
    names = lambda ms: [m["name"] for m in ms]  # noqa: E731
    assert names(harness.wanted(bench, "x", False)) == ["a", "b"]
    assert names(harness.wanted(bench, "y", False)) == ["b"]
    assert names(harness.wanted(bench, "x", True)) == ["p", "q"]
    assert names(harness.wanted(bench, "y", True)) == ["q", "r"]


def test_a_metric_whose_reader_finds_nothing_is_left_out_of_the_line():
    bench = {"end_to_end": [{"name": "tokens_per_s", "unit": "tokens/s"}],
             "per_layer": [{"name": "ssm_scan_roofline", "unit": "%", "moves": "tokens_per_s"}]}
    # a dense cell's trace holds no scan kernel: the reader returns None
    assert harness.reader("ssm_scan_roofline")(run([], trace=trace_data())) is None
    assert [m["name"] for m in harness.wanted(bench, "any.cell", True)] == ["ssm_scan_roofline"]
