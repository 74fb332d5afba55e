"""The engine's and the model's profiler spans (``kernels/ops.py:span``):
under a torch profiler, one admission and one decode step record every
engine phase inside its call and one model span a layer and call; with
no profiler no range is opened; the spans change no token."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import dataclasses  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

ARCH = "qwen3-8b"
MAX_LEN = 64
PHASES = ("prepare", "model", "sync", "sample")


@pytest.fixture(scope="module")
def model():
    m = Model(get_smoke_config(ARCH))
    return m, m.init(0, device="cpu")


def prompts(cfg, n):
    rng = np.random.default_rng(7)
    return [rng.integers(1, cfg.vocab_size, 5 + 3 * i).astype(np.int32) for i in range(n)]


def spans(prof):
    """Each engine or model span: (name, name of the nearest engine span
    around it, or None)."""
    out = []
    for e in prof.events():
        if not e.name.startswith(("engine.", "model.")):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("engine."):
            up = up.cpu_parent
        out.append((e.name, None if up is None else up.name))
    return out


def family_model(arch):
    """The smoke model of ``arch``; ``+gqa`` swaps MLA for GQA (the MoE
    family on the paged backend)."""
    cfg = get_smoke_config(arch.removesuffix("+gqa"))
    if arch.endswith("+gqa"):
        cfg = dataclasses.replace(cfg, attention_kind="gqa")
    m = Model(cfg)
    return m, m.init(0, device="cpu")


def model_spans(cfg):
    """How often each model span opens in one prefill or decode step: one
    ``model.attention`` an attention block or hybrid superblock, one
    ``model.mlp`` an MLP or MoE block, one ``model.ssm`` a Mamba2 layer."""
    L = cfg.num_layers
    if cfg.arch_type == "ssm":
        return {"model.attention": 0, "model.mlp": 0, "model.ssm": L}
    if cfg.arch_type == "hybrid":
        return {"model.attention": L // cfg.shared_attn_every, "model.mlp": 0, "model.ssm": L}
    return {"model.attention": L, "model.mlp": L, "model.ssm": 0}


# (arch, backend): qwen3-8b's cases keep their first ids
SPAN_CASES = [pytest.param(ARCH, b, id=b) for b in ("paged", "flat")] + [
    pytest.param(a, b, id=f"{a}-{b}")
    for a in ("mamba2-370m", "zamba2-1.2b", "deepseek-v2-236b+gqa") for b in ("paged", "flat")]


@pytest.mark.parametrize("arch,backend", SPAN_CASES)
def test_one_admission_and_one_step_record_every_span_nested(model, arch, backend):
    m, params = model if arch == ARCH else family_model(arch)
    eng = Engine(m, params, batch=2, max_len=MAX_LEN, kv_backend=backend)
    req = Request(rid=0, prompt=prompts(m.cfg, 1)[0], max_new_tokens=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.admit(req)
        eng.step()
    got = spans(prof)
    engine = sorted(s for s in got if s[0].startswith("engine."))
    want = [("engine.admit", None), ("engine.step", None)]
    want += [(f"engine.{call}.{p}", f"engine.{call}") for call in ("admit", "step")
             for p in PHASES]
    assert engine == sorted(want)
    want = {**model_spans(m.cfg), "model.embed": 1, "model.head": 1}
    for call in ("admit", "step"):
        inside = [name for name, up in got if up == f"engine.{call}.model"]
        for name, n in want.items():
            assert inside.count(name) == n, (call, name)
        assert inside.count("model.scatter") == (call == "admit")
    assert all(up is not None for name, up in got if name.startswith("model."))


def test_no_profiler_opens_no_range(model, monkeypatch):
    m, params = model
    calls = []
    real = ops._Range

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(ops, "_Range", counting)
    eng = Engine(m, params, batch=2, max_len=MAX_LEN)
    eng.admit(Request(rid=0, prompt=prompts(m.cfg, 1)[0], max_new_tokens=4))
    eng.step()
    assert calls == []
    # the same calls under a profiler go through the patched range
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    assert "engine.step" in calls and "model.attention" in calls


def test_spans_are_not_user_annotations(model):
    """The profiler gives a kernel to its innermost user annotation only:
    a span that were one would empty a caller's range around the engine
    (a benchmark's step range) of its kernels."""
    m, params = model
    eng = Engine(m, params, batch=2, max_len=MAX_LEN)
    eng.admit(Request(rid=0, prompt=prompts(m.cfg, 1)[0], max_new_tokens=4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("caller.step"):
            eng.step()
    kinds = {e.name(): e.is_user_annotation() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("caller.", "engine.", "model."))}
    assert kinds.pop("caller.step") is True
    assert {"engine.step", "model.attention"} <= set(kinds) and not any(kinds.values())


def test_greedy_tokens_are_the_same_with_the_profiler_on(model):
    m, params = model

    def serve():
        eng = Engine(m, params, batch=2, max_len=MAX_LEN)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts(m.cfg, 3))]
        for r in reqs[:2]:
            eng.admit(r)
        while eng.num_live:
            for r in eng.step():
                if not reqs[2].out_tokens:
                    eng.admit(reqs[2])
        return [r.out_tokens for r in reqs]

    off = serve()
    with profile(activities=[ProfilerActivity.CPU]):
        on = serve()
    assert on == off
    assert all(len(t) == 5 for t in off)
