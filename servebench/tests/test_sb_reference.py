"""The plain reference against the port's Model on the CPU at a test's
widths: admission (prefill, the cache handed over) then decode steps
through the engine, with servebench's weights.  The tests import both;
the reference imports nothing of the program."""

import numpy as np
import pytest
import torch
from conftest import tiny_cfg

from servebench import check, reference, weights


def serve(cfg, params, backend, prompts, steps):
    """Admit every prompt, run ``steps`` decode steps; the logits each
    request's tokens were sampled from, in order, and its tokens."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import Engine, Request

    eng = Engine(Model(ModelConfig(**cfg)), params, batch=len(prompts), max_len=128,
                 kv_backend=backend, page_size=16)
    seen = {i: [] for i in range(len(prompts))}
    prefill, decode = eng._prefill, eng._decode
    current = []

    def pre(*a):
        lg, c = prefill(*a)
        seen[current[0]].append(lg[0, 0].float())
        return lg, c

    def dec(*a):
        lg, c = decode(*a)
        for slot, req in enumerate(eng.slots):
            if req is not None:
                seen[req.rid].append(lg[slot, 0].float())
        return lg, c

    eng._prefill, eng._decode = pre, dec
    reqs = [Request(rid=i, prompt=p, max_new_tokens=steps + 1) for i, p in enumerate(prompts)]
    for r in reqs:
        current[:] = [r.rid]
        eng.admit(r)
    for _ in range(steps):
        eng.step()
    return [torch.stack(seen[i]) for i in range(len(prompts))], [r.out_tokens for r in reqs]


@pytest.mark.parametrize("config,backend", [("granite-20b", "paged"), ("granite-20b", "flat"),
                                            ("mamba2-370m", "flat")])
def test_reference_matches_the_port_in_float32(config, backend):
    cfg = {**tiny_cfg(config)["model"], "dtype": "float32"}
    seed = 2**31 + 99
    params = weights.make_params(cfg, seed, "cpu")
    f32 = lambda t: {k: f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()  # noqa: E731
    params = f32(params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg["vocab_size"], n).astype(np.int32) for n in (37, 20, 50)]
    got, toks = serve(cfg, params, backend, prompts, steps=6)
    seqs, starts = check.sequences([type("R", (), {"tokens": t})() for t in toks], prompts)
    want = reference.logits(cfg, seed, seqs, starts, "cpu")["fp32"]
    for g, w in zip(got, want):
        assert g.shape[0] == w.shape[0] == 7
        assert torch.allclose(g[:, :cfg["vocab_size"]], w, atol=2e-4, rtol=1e-4), \
            (g[:, :cfg["vocab_size"]] - w).abs().max()


@pytest.mark.parametrize("config,backend", [("granite-20b", "paged"), ("mamba2-370m", "flat")])
def test_bfloat16_port_serves_the_reference_best_token_up_to_rounding(config, backend):
    cfg = tiny_cfg(config)["model"]
    seed = 7
    params = weights.make_params(cfg, seed, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg["vocab_size"], n).astype(np.int32) for n in (40, 17)]
    _, toks = serve(cfg, params, backend, prompts, steps=8)
    reqs = [type("R", (), {"tokens": t})() for t in toks]
    seqs, starts = check.sequences(reqs, prompts)
    out = reference.logits(cfg, seed, seqs, starts, "cpu", ("fp32", "fp8"))
    gap = check.widest_gap(out["fp32"], toks)
    assert 0.0 <= gap < 0.05
    # the control puts other tokens first
    assert check.control_gap(out["fp32"], out["fp8"]) > gap


def test_weights_follow_the_ports_layout():
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import Model

    for config in ("granite-20b", "mamba2-370m"):
        cfg = tiny_cfg(config)["model"]
        specs = Model(ModelConfig(**cfg)).param_specs()
        flat = {}

        def walk(t, pre=""):
            for k, v in t.items():
                walk(v, f"{pre}{k}/") if isinstance(v, dict) else flat.__setitem__(pre + k, v)

        walk(weights.make_params(cfg, 1, "cpu"))
        assert {k: tuple(v.shape) for k, v in flat.items()} == {k: s[0] for k, s in specs.items()}
        assert all(v.dtype == torch.bfloat16 for v in flat.values())
        assert weights.nbytes(cfg) == sum(2 * v.numel() for v in flat.values())


def test_a_layer_made_again_is_bit_equal():
    cfg = tiny_cfg("granite-20b")["model"]
    params = weights.make_params(cfg, 5, "cpu")
    again = weights.leaf(cfg, 5, "mlp/w_up", layer=1)
    assert torch.equal(params["layers"]["mlp"]["w_up"][1], again)
    assert not torch.equal(params["layers"]["mlp"]["w_up"][0], again)
    assert torch.equal(params["head"], weights.leaf(cfg, 5, "head"))


def test_widest_gap_reads_the_served_tokens():
    lg = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 0.0]])
    assert check.widest_gap([lg], [[1, 0]]) == 0.0
    assert check.widest_gap([lg], [[2, 0]]) == pytest.approx(1.0)
    assert check.widest_gap([lg], [[1, 2]]) == pytest.approx(3.0)
    assert check.widest_gap([lg], [[1, 7]]) == float("inf")
