"""``engine.graph_step_share``: the decode steps that replayed a captured
CUDA graph, read from the program's spans on hand-built traces, and on the
card, where a replayed step's kernels stay on its loop range's device
side."""

import types

import numpy as np
import pytest

from servebench import harness, profiling

STEP = [(0, 100, "engine.step"), (10, 80, "engine.step.model")]


def trace(cpu, window=(0, 1000)):
    return profiling.TraceData(window, [("k", 0, 10)], {}, {}, sorted(cpu))


def read(t):
    return harness.reader("engine.graph_step_share")(types.SimpleNamespace(trace=t))


def shifted(spans, by):
    return [(s + by, e + by, n) for s, e, n in spans]


def test_the_share_counts_model_calls_that_hold_a_replay():
    replayed = STEP + [(20, 70, "engine.step.replay")]
    cpu = (shifted(replayed, 0) + shifted(STEP, 200) + shifted(replayed, 400)
           + shifted(replayed, 600)
           # an admission's model call is no decode step
           + [(800, 900, "engine.admit"), (810, 890, "engine.admit.model")])
    assert read(trace(cpu)) == pytest.approx(75.0)


def test_a_replay_at_a_model_calls_edges_is_held_and_one_outside_is_not():
    cpu = (STEP + [(10, 10, "engine.step.replay")] + shifted(STEP, 200)
           + [(90, 95, "engine.step.replay")])
    assert read(trace(cpu)) == pytest.approx(50.0)


@pytest.mark.parametrize("cpu", [None, STEP, [(20, 70, "engine.step.replay")]],
                         ids=["untraced", "no-replay-spans", "no-model-calls"])
def test_without_replays_or_steps_the_reader_returns_nothing(cpu):
    assert read(None if cpu is None else trace(cpu)) is None


@pytest.mark.card
def test_replayed_steps_read_in_full_and_keep_their_kernels(cuda):
    """A tiny granite engine on the card captures at its first step; the
    traced steps after it are all replays, and each loop range around a
    step keeps the graph's kernels on its device side, as
    ``device.kernels_per_decode_step`` reads them."""
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
    eng.step()  # builds the kernels, captures the step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("sb.trace"):
            for i in range(3):
                with record_function(f"sb.step.{i}"):
                    eng.step()
            torch.cuda.synchronize()
    t = profiling.parse(prof)
    assert eng.graph_captures == 1 and eng.graph_replays == 4
    assert read(t) == pytest.approx(100.0)
    counts = [len(t.ops_in(f"sb.step.{i}") or ()) for i in range(3)]
    print(f"device operations a replayed step: {counts}")
    assert min(counts) > 2 * model.cfg.num_layers
    assert not [n for _, _, n in t.cpu_ops if n.startswith("model.")]
