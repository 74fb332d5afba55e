"""The port's MLA attention against the JAX package's, function by function
(float32, 1e-4), on weights from the reference's ``mla_init`` and inputs
drawn from a numpy seed; and the bridge's plain causal attention for
unequal q and v head dims against the reference's ``_naive_attention``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import kernels_bridge as jbridge  # noqa: E402
from repro.models.common import ParamFactory  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import kernels_bridge as tbridge  # noqa: E402

TOL = 1e-4
ARCH = "deepseek-v2-236b"


def configs(**overrides):
    return (get_smoke_config(ARCH, dtype="float32", **overrides),
            jax_smoke(ARCH, dtype="float32", **overrides))


def mla_params(jcfg, seed=0):
    f = ParamFactory(jax.random.PRNGKey(seed), jnp.float32)
    jattn.mla_init(f, jcfg)
    return f.params, {k: torch.tensor(v) for k, v in _flatten(f.params).items()}


def normal(shape, seed=1, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=err_msg)


def close_trees(mine, theirs):
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        close(mine[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("q_lora_rank", [48, 0])
@pytest.mark.parametrize("smoke", [True, False])
def test_mla_specs_have_the_reference_tree_and_shapes(smoke, q_lora_rank):
    """``q_lora_rank == 0`` gives ``w_uq`` of (d, H*(nd+rd)) and no
    ``w_dq``/``q_norm``, as the reference's ``mla_init``."""
    get, jget = (get_smoke_config, jax_smoke) if smoke else (get_config, jax_config)
    cfg, jcfg = get(ARCH, q_lora_rank=q_lora_rank), jget(ARCH, q_lora_rank=q_lora_rank)
    f = ParamFactory(None, jnp.bfloat16, abstract=True)
    jattn.mla_init(f, jcfg)
    want = {k: tuple(v.shape) for k, v in f.params.items()}
    assert {k: s for k, (s, *_) in tattn.mla_specs(cfg).items()} == want
    assert ("w_dq" in want) == bool(q_lora_rank)


@pytest.mark.parametrize("q_lora_rank", [48, 0])
@pytest.mark.parametrize("window", [None, 8])
def test_mla_prefill_and_forward_match_jax(window, q_lora_rank):
    """Output and latent cache (the ring of the last W rows with its slot
    positions under a window shorter than the sequence)."""
    cfg, jcfg = configs(sliding_window=window, q_lora_rank=q_lora_rank)
    jp, tp = mla_params(jcfg)
    B, S = 2, 24
    jx, tx = normal((B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jcache = jattn.mla_prefill(jp, jcfg, jx, jnp.asarray(pos))
    tout, tcache = tattn.mla_prefill(tp, cfg, tx, torch.from_numpy(pos.copy()))
    close(tout, jout)
    close_trees(tcache, jcache)
    assert tcache["ckv"].shape == (B, window or S, cfg.kv_lora_rank)
    close(tattn.mla_forward(tp, cfg, tx, torch.from_numpy(pos.copy())),
          jattn.mla_forward(jp, jcfg, jx, jnp.asarray(pos)))


def test_mla_ring_prefill_refuses_a_length_off_the_window():
    cfg, jcfg = configs(sliding_window=8)
    _, tp = mla_params(jcfg)
    _, tx = normal((1, 12, cfg.d_model))
    with pytest.raises(ValueError, match="multiple of the ring window"):
        tattn.mla_prefill(tp, cfg, tx, torch.arange(12)[None])


@pytest.mark.parametrize("window", [None, 8])
def test_mla_decode_matches_jax(window):
    """The weight-absorbed decode from a prefilled cache: six ragged steps
    (per-slot positions, slot 2 idle), on the full cache or, with a window,
    on the ring past its wrap; live rows' outputs and every cache leaf
    within 1e-4, and the idle slot's cache rows untouched."""
    cfg, jcfg = configs(sliding_window=window)
    jp, tp = mla_params(jcfg)
    B, S, max_len = 3, 16, 32
    jx, tx = normal((B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, jpre = jattn.mla_prefill(jp, jcfg, jx, jnp.asarray(pos))
    _, tpre = tattn.mla_prefill(tp, cfg, tx, torch.from_numpy(pos.copy()))
    jcache = jattn.mla_init_cache(jcfg, B, max_len, jnp.float32)
    tcache = tattn.mla_init_cache(cfg, B, max_len, torch.float32, torch.device("cpu"))
    rows = window or S
    for k in tcache:  # the prefill's rows into the decode cache
        jcache[k] = jcache[k].at[:, :rows].set(jpre[k])
        tcache[k][:, :rows] = tpre[k]
    step_pos = np.array([S, S - 5, -1], np.int32)  # slot 1 resumes earlier; slot 2 idle
    live = step_pos >= 0
    idle_before = {k: v[2].clone() for k, v in tcache.items()}
    for t in range(6):
        jx1, tx1 = normal((B, 1, cfg.d_model), seed=10 + t)
        jo, jcache = jattn.mla_decode(jp, jcfg, jx1, jcache, jnp.asarray(step_pos))
        to, tcache = tattn.mla_decode(tp, cfg, tx1, tcache, torch.from_numpy(step_pos))
        close(to[live], np.asarray(jo)[live])
        step_pos = np.where(live, step_pos + 1, step_pos)
    close_trees(tcache, jcache)
    for k, v in idle_before.items():
        assert torch.equal(tcache[k][2], v), k


def test_mla_decode_row_with_nothing_valid_averages_the_latent_as_the_reference():
    """An idle slot on a fresh ring has no valid entry.  The port keeps the
    reference's masked softmax (-1e30), which averages the latent there,
    rather than the flat GQA decode's zeros (C8): the outputs are equal on
    every row, the empty one included, and that row is not zero."""
    cfg, jcfg = configs(sliding_window=8)
    jp, tp = mla_params(jcfg)
    B, max_len = 2, 32
    jcache = jattn.mla_init_cache(jcfg, B, max_len, jnp.float32)
    tcache = tattn.mla_init_cache(cfg, B, max_len, torch.float32, torch.device("cpu"))
    jl, tl = normal((B, 8, cfg.kv_lora_rank), seed=3)  # stale latent rows in the ring
    jcache["ckv"], tcache["ckv"] = jl, tl.clone()
    jx, tx = normal((B, 1, cfg.d_model), seed=4)
    pos = np.array([0, -1], np.int32)
    jo, _ = jattn.mla_decode(jp, jcfg, jx, jcache, jnp.asarray(pos))
    to, tc = tattn.mla_decode(tp, cfg, tx, tcache, torch.from_numpy(pos))
    assert not bool(((tc["slot_pos"][1] >= 0)).any())  # nothing valid in row 1
    close(to, jo)
    assert float(to[1].abs().max()) > 0


@pytest.mark.parametrize("S,q_block,window", [
    (40, 1024, None), (40, 1024, 7), (64, 16, None), (64, 16, 20), (48, 16, 1),
])
def test_plain_attention_for_unequal_head_dims_matches_reference(S, q_block, window):
    """MLA's q (nope + rope = 48) against v (32): the reference's
    ``_naive_attention``, and its query-blocked path where S > q_block."""
    B, H, D, VD = 2, 4, 48, 32
    jq, tq = normal((B, S, H, D), seed=5)
    jk, tk = normal((B, S, H, D), seed=6)
    jv, tv = normal((B, S, H, VD), seed=7)
    scale = 1 / np.sqrt(D)
    want = jbridge.causal_attention(jq, jk, jv, window=window, scale=scale, q_block=q_block)
    got = tbridge.causal_attention(tq, tk, tv, window=window, scale=scale, q_block=q_block)
    assert got.shape == (B, S, H, VD)
    close(got, want)
    if S <= q_block:
        close(got, jbridge._naive_attention(jq, jk, jv, window, scale))


def test_blocked_plain_attention_builds_no_score_tensor_beyond_one_tile(monkeypatch):
    """Each query tile scores against the keys once: no call sees more than
    ``q_block`` query rows."""
    seen = []
    naive = tbridge._naive_attention

    def spy(q, *a, **kw):
        seen.append(q.shape[1])
        return naive(q, *a, **kw)

    monkeypatch.setattr(tbridge, "_naive_attention", spy)
    q = torch.randn(1, 70, 2, 24)
    tbridge.causal_attention(q, torch.randn(1, 70, 2, 24), torch.randn(1, 70, 2, 16),
                             q_block=32)
    assert seen == [32, 32, 6]


def test_only_equal_head_dims_reach_the_flash_wrapper(monkeypatch):
    """GQA (equal dims) always goes through ``ops.flash_attention``; MLA
    never does, on any device, as in the reference."""
    calls = []
    flash = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[-1])
        return flash(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg, jcfg = configs()
    _, tp = mla_params(jcfg)
    _, tx = normal((1, 16, cfg.d_model))
    tattn.mla_prefill(tp, cfg, tx, torch.arange(16)[None])
    assert calls == []
    tbridge.causal_attention(*(torch.randn(1, 16, 2, 32) for _ in range(3)))
    assert calls == [32]


def test_mla_layers_take_a_dense_model_as_in_the_reference():
    """MLA dispatch does not depend on the family: the deepseek-v2 smoke
    config's attention in a dense stack has the reference's key tree."""
    from repro.models import Model as JaxModel
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke_config(ARCH), arch_type="dense")
    jcfg = dataclasses.replace(jax_smoke(ARCH), arch_type="dense")
    jp, _ = JaxModel(jcfg).init(None, abstract=True)
    assert sorted(Model(cfg).param_specs()) == sorted(_flatten_abstract(jp))


def _flatten_abstract(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_abstract(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
