"""The serving paths' RMSNorm and rotary wrappers on the CPU: their plain
route is the model's plain ops bit for bit, they refuse grad, the dry
run's fake route books their work, and the serving paths reach them (the
training paths do not) with the logits and caches the model gave before
its loop added each sublayer's output inside the next norm."""

import dataclasses
import hashlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import norm_rope as nr_mod  # noqa: E402
from repro_torch.launch.mesh import make_slice_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import apply_rope, flatten, rmsnorm  # noqa: E402
from repro_torch.roofline.analysis import StepCounter  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randn(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32).to(DTYPES[dtype])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 1, 64), (2, 5, 96), (3, 7, 4, 16), (4, 33)])
def test_rmsnorm_plain_route_is_the_models_norm_bit_for_bit(dtype, shape):
    x = _randn(shape, dtype, 0) * 3
    w = _randn(shape[-1:], dtype, 1)
    r = _randn(shape, dtype, 2)
    assert torch.equal(_bits(ops.rmsnorm(x, w, 1e-5)), _bits(rmsnorm(x, w, 1e-5)))
    normed, s = ops.rmsnorm(x, w, 1e-5, residual=r)
    assert torch.equal(_bits(s), _bits(r + x))
    assert torch.equal(_bits(normed), _bits(rmsnorm(r + x, w, 1e-5)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,hd,theta", [(1, 9, 4, 2, 16, 10_000.0),
                                               (2, 3, 6, 1, 32, 1e6),
                                               (3, 1, 2, 2, 8, 500.0)])
def test_rope_plain_route_is_apply_rope_bit_for_bit(dtype, B, S, H, KV, hd, theta):
    q = _randn((B, S, H, hd), dtype, 0)
    k = _randn((B, S, KV, hd), dtype, 1)
    positions = torch.tensor([[-1] + list(range(S - 1)), list(range(5, 5 + S)),
                              [8191] * S])[:B]
    q0, k0 = q.clone(), k.clone()
    got_q, got_k = ops.rope(q, k, positions, theta)
    assert torch.equal(_bits(got_q), _bits(apply_rope(q0, positions, theta)))
    assert torch.equal(_bits(got_k), _bits(apply_rope(k0, positions, theta)))
    assert torch.equal(q, q0) and torch.equal(k, k0)  # the plain route makes new tensors


@pytest.mark.parametrize("call", ["rmsnorm", "rmsnorm_residual", "rope"])
def test_norm_and_rope_wrappers_refuse_grad(call):
    x = torch.randn(2, 3, 4, 8, requires_grad=True)
    w = torch.ones(8)
    with pytest.raises(RuntimeError, match="no gradient"):
        if call == "rmsnorm":
            ops.rmsnorm(x, w)
        elif call == "rmsnorm_residual":
            ops.rmsnorm(x.detach(), w, residual=x)
        else:
            ops.rope(x, x.detach(), torch.zeros(2, 3, dtype=torch.int64), 10_000.0)
    with torch.no_grad():  # without grad they run
        ops.rmsnorm(x, w, residual=x)
        ops.rope(x, x, torch.zeros(2, 3, dtype=torch.int64), 10_000.0)


def fake(counter, *shape, dtype=torch.bfloat16):
    with counter:
        return torch.empty(shape, dtype=dtype)


def test_fake_route_books_norm_and_rope_work_without_a_build_or_a_launch(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    ops.reset_launches()
    c = StepCounter(kernels=True)
    B, S, H, KV, hd, d = 2, 64, 8, 2, 32, 96
    x, r, w = fake(c, B, S, d), fake(c, B, S, d), fake(c, d)
    q, k = fake(c, B, S, H, hd), fake(c, B, S, KV, hd)
    qn = fake(c, hd)
    pos = fake(c, B, S, dtype=torch.int64)
    with c:
        c.start(())
        out = ops.rmsnorm(x, w, 1e-6)
        normed, s = ops.rmsnorm(x, w, 1e-6, residual=r)
        qq = ops.rmsnorm(q, qn, 1e-6)
        rq, rk = ops.rope(q, k, pos, 10_000.0)
    assert out.shape == normed.shape == s.shape == x.shape and qq.shape == q.shape
    assert rq is q and rk is k  # rotated in place, as the kernel does
    assert ops.launches() == {name: 0 for name in ops.launches()}
    norms = [nr_mod.work_rmsnorm(B * S, d, 2, False), nr_mod.work_rmsnorm(B * S, d, 2, True),
             nr_mod.work_rmsnorm(B * S * H, hd, 2, False)]
    want = {"rmsnorm": (3, sum(f for f, _ in norms), sum(b for _, b in norms)),
            "rope": (1, *nr_mod.work_rope(B * S, H, KV, hd, 2))}
    assert {n: (v["calls"], v["flops"], v["bytes"]) for n, v in c.kernels.items()} == want
    # bytes: x and the output (and the residual and the sum) moved once, w once
    assert norms[1][1] == 2 * (4 * B * S * d + d)
    assert want["rope"][2] == 2 * 2 * B * S * (H + KV) * hd + 8 * B * S


def test_fake_route_books_the_local_shards_of_dtensors():
    """A DTensor runs the wrapper on rank 0's shards: batch over "data"
    and heads over "model" cut the booked rotary by 8; the norm's rows
    split over "data" only, its features whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_slice_mesh(2, 4)
    c = StepCounter(kernels=True)
    B, S, H, KV, hd, d = 4, 16, 8, 4, 32, 64
    with c:
        q, k = (distribute_tensor(torch.empty((B, S, n, hd), dtype=torch.bfloat16), mesh,
                                  [Shard(0), Shard(2)], src_data_rank=None) for n in (H, KV))
        x = distribute_tensor(torch.empty((B, S, d), dtype=torch.bfloat16), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty((d,), dtype=torch.bfloat16), mesh,
                              [Replicate(), Replicate()], src_data_rank=None)
        pos = torch.zeros((B, S), dtype=torch.int64)
        c.start(())
        rq, rk = ops.rope(q, k, pos, 10_000.0)
        out = ops.rmsnorm(x, w, 1e-6)
    assert tuple(rq.placements) == tuple(rk.placements) == (Shard(0), Shard(2))
    assert out.shape == x.shape and tuple(out.placements) == (Shard(0), Replicate())
    assert c.kernels["rope"]["bytes"] == nr_mod.work_rope(B * S // 2, H // 4, KV // 4, hd, 2)[1]
    assert c.kernels["rmsnorm"]["bytes"] == nr_mod.work_rmsnorm(B * S // 2, d, 2, False)[1]
    assert c.collectives_by_axis == {}  # already placed as the kernels want


def _smoke(arch):
    if arch == "gqa-moe":  # the MoE family with GQA: MoE blocks behind GQA attention
        return dataclasses.replace(get_smoke_config("deepseek-v2-236b"), attention_kind="gqa")
    return get_smoke_config(arch)


def _digest(tree) -> str:
    h = hashlib.sha256()
    items = sorted(flatten(tree).items()) if isinstance(tree, dict) else [("", tree)]
    for key, t in items:
        h.update(key.encode())
        h.update(_bits(t.contiguous()).numpy().tobytes() if t.is_floating_point()
                 else t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# each smoke config's bf16 prefill (logits, caches) and decode step (logits,
# caches) as the parent commit gave them, before the serving loop moved each
# residual add into the next norm (paged decode where the model has it)
PINNED = {
    "granite-20b": ("e6c6f981446abcbd", "ddb0f9d073d02007", "d76d9188e846813a",
                    "7156f3baa510782e"),
    "qwen3-8b": ("dd39c9123622cb01", "873f68a5f1190e6f", "d2f4a1c32a3d9675",
                 "6bec671a715305b1"),
    "zamba2-1.2b": ("12b05b3e36c3792d", "7584576ede83e548", "bce4cbc421622f61",
                    "576c252fba61206c"),
    "mamba2-370m": ("93a25fd062618e90", "b117b0802b2d3534", "76ea9c2c70313c37",
                    "eadb14aa6ecb0983"),
    "deepseek-v2-236b": ("279fa5730112970f", "5a6ae7f9e6b204b3", "36f471af1b71ab41",
                         "36563710cdf2e856"),
    "gqa-moe": ("328978fda85532bd", "fa6df97065d21578", "44323b19d7b28755",
                "9267f8c2b2d2211e"),
}


@pytest.mark.parametrize("arch", list(PINNED))
def test_serving_logits_and_caches_are_the_parents_bit_for_bit(arch):
    cfg = _smoke(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, cfg.vocab_size, (2, 11), generator=g)
    lengths = None if arch == "deepseek-v2-236b" else torch.tensor([11, 7])
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens, lengths=lengths)
        got = [_digest(logits), _digest(cache)]
        tok = torch.randint(1, cfg.vocab_size, (3, 1), generator=g)
        pos = torch.tensor([5, -1, 9])
        if model.supports_paged_kv:
            cache = model.init_paged_cache(3, 12, 4, 4, device="cpu")
            cache["page_tables"][:] = torch.arange(12, dtype=torch.int32).reshape(3, 4)
            logits, cache = model.decode_step_paged(params, cache, tok, pos)
        else:
            cache = model.init_cache(3, 16, device="cpu")
            logits, cache = model.decode_step(params, cache, tok, pos)
        got += [_digest(logits), _digest(cache)]
    assert tuple(got) == PINNED[arch]


def _norms_and_ropes(cfg):
    """(norms, rotary calls) of one serving pass (a prefill or a decode
    step): the blocks' pre-norms (the qk-norm's two per GQA attention
    besides) and the final norm; one rotary call per GQA attention."""
    gqa = cfg.attention_kind == "gqa" and cfg.arch_type != "ssm"
    per_attn = 2 if gqa and cfg.qk_norm else 0
    if cfg.arch_type == "ssm":
        return cfg.num_layers + 1, 0
    if cfg.arch_type == "hybrid":
        n_attn = cfg.num_layers // cfg.shared_attn_every
        return cfg.num_layers + n_attn * (1 + per_attn) + 1, n_attn * gqa
    return cfg.num_layers * (2 + per_attn) + 1, cfg.num_layers * gqa


@pytest.mark.parametrize("arch", ["granite-20b", "qwen3-8b", "zamba2-1.2b", "mamba2-370m",
                                  "deepseek-v2-236b", "gqa-moe"])
def test_serving_paths_call_the_wrappers_and_training_does_not(arch, monkeypatch):
    cfg = _smoke(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    calls = {"rmsnorm": 0, "rope": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    tokens = torch.randint(1, cfg.vocab_size, (2, 8))
    norms, ropes = _norms_and_ropes(cfg)
    with torch.no_grad():
        _, cache = model.prefill(params, tokens)
        assert calls == {"rmsnorm": norms, "rope": ropes}
        if model.supports_paged_kv:
            cache = model.init_paged_cache(2, 8, 4, 4, device="cpu")
            model.decode_step_paged(params, cache, tokens[:, :1], torch.tensor([3, -1]))
        else:
            cache = model.init_cache(2, 16, device="cpu")
            model.decode_step(params, cache, tokens[:, :1], torch.tensor([3, -1]))
        assert calls == {"rmsnorm": 2 * norms, "rope": 2 * ropes}
        model.forward(params, tokens)
    assert calls == {"rmsnorm": 2 * norms, "rope": 2 * ropes}
