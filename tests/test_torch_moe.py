"""The port's MoE layer against the JAX package's ``models/moe.py``, on the
same weights and inputs drawn from a numpy seed: capacity, top-k ties,
capacity drops, idle decode rows, the aux loss, float32 and bf16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import ParamFactory  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import unflatten  # noqa: E402

TOL = 1e-5
ARCH = "deepseek-v2-236b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(dtype="float32", **overrides):
    return (get_smoke_config(ARCH, dtype=dtype, **overrides),
            jax_smoke(ARCH, dtype=dtype, **overrides))


def moe_params(jcfg, dtype, seed=0):
    """The reference's ``moe_init`` weights, and the same numbers as torch
    tensors keyed by the port's ``moe_specs``."""
    f = ParamFactory(jax.random.PRNGKey(seed), JDT[dtype])
    jmoe.moe_init(f, jcfg)
    flat = _flatten(f.params)
    return f.params, unflatten({k: torch.tensor(v).to(TDT[dtype]) for k, v in flat.items()})


def inputs(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assignments_dropped(cfg, probs_src, x):
    """How many of the (T*k) assignments find their expert full."""
    logits = x.reshape(-1, x.shape[-1]).float() @ probs_src["router"].float()
    _, idx = tmoe.top_k(torch.softmax(logits, dim=-1), cfg.experts_per_token)
    per_expert = torch.bincount(idx.flatten(), minlength=cfg.num_experts)
    C = tmoe.capacity(x.shape[0] * x.shape[1], cfg)
    return int((per_expert - C).clamp(min=0).sum())


@pytest.mark.parametrize("tokens", [1, 3, 8, 9, 16, 31, 64, 100, 1024, 4097])
@pytest.mark.parametrize("arch,smoke,factor", [
    ("deepseek-v2-236b", True, 1.25), ("deepseek-v2-236b", True, 0.25),
    ("deepseek-v2-236b", False, 1.25), ("deepseek-v3-671b", False, 1.25),
])
def test_capacity_equals_reference(arch, smoke, factor, tokens):
    get, jget = (get_smoke_config, jax_smoke) if smoke else (get_config, jax_config)
    mine, theirs = get(arch, capacity_factor=factor), jget(arch, capacity_factor=factor)
    assert tmoe.capacity(tokens, mine) == jmoe.capacity(tokens, theirs)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_moe_specs_have_the_reference_tree_and_shapes(arch, smoke):
    get, jget = (get_smoke_config, jax_smoke) if smoke else (get_config, jax_config)
    f = ParamFactory(None, jnp.bfloat16, abstract=True)
    jmoe.moe_init(f, jget(arch))
    want = {k: tuple(v.shape) for k, v in _flatten_abstract(f.params).items()}
    assert {k: s for k, (s, *_) in tmoe.moe_specs(get(arch)).items()} == want
    assert tmoe.moe_specs(get(arch))["router"][2] == 0.02  # the reference's router scale


def _flatten_abstract(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_abstract(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("shape,overrides,drops", [
    ((1, 24, 128), {}, None),                            # one prompt
    ((2, 16, 128), {}, None),                            # a batch of prompts
    ((1, 64, 128), {"capacity_factor": 0.25}, True),     # C = 8: most assignments drop
    ((16, 1, 128), {"capacity_factor": 0.25}, True),     # 16 decode rows, C = 8 < B
    ((16, 1, 128), {}, False),                           # 16 decode rows, C = 16
    ((1, 24, 128), {"num_shared_experts": 0}, None),     # routed experts only
])
def test_moe_forward_matches_jax(shape, overrides, drops):
    """Output and aux loss within 1e-5 in float32.  The 16-row decode
    batches stand for an engine step whose idle rows (here rows 3, 7 and
    11, fed zeros) still take part, in arrival order, as in the reference."""
    cfg, jcfg = configs(**overrides)
    jp, tp = moe_params(jcfg, "float32")
    jx, tx = inputs(shape, "float32")
    if shape[0] == 16:
        jx = jx.at[jnp.array([3, 7, 11])].set(0.0)
        tx[[3, 7, 11]] = 0.0
    if drops is not None:
        assert (assignments_dropped(cfg, tp, tx) > 0) == drops
    jout, jaux = jmoe.moe_forward(jp, jcfg, jx)
    tout, taux = tmoe.moe_forward(tp, cfg, tx)
    assert tout.shape == tuple(shape) and tout.dtype == torch.float32
    np.testing.assert_allclose(f32(tout), f32(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)


def test_top_k_breaks_ties_to_the_lower_index_as_jax_does():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.1, 0.2, 0.3, 0.4]], np.float32)
    jw, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    tw, tidx = tmoe.top_k(torch.from_numpy(probs), 2)
    assert tidx.tolist() == np.asarray(jidx).tolist() == [[0, 1], [1, 2], [0, 2], [3, 2]]
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("router", ["zeros", "duplicated_columns"])
def test_moe_forward_with_tied_router_scores_matches_jax(router):
    """Crafted router weights whose scores tie: all four experts (zeros),
    or experts 1 and 3 always equal and on top.  The port must pick the
    lower index, or its output takes other experts' weights."""
    cfg, jcfg = configs()
    jp, tp = moe_params(jcfg, "float32")
    r = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    if router == "duplicated_columns":
        col = np.abs(np.random.default_rng(4).standard_normal(cfg.d_model)).astype(np.float32)
        r[:, 1] = r[:, 3] = col
    jp = {**jp, "router": jnp.asarray(r)}
    tp = {**tp, "router": torch.from_numpy(r)}
    # positive inputs, so the duplicated columns score above the zero ones
    jx, tx = inputs((1, 20, cfg.d_model), "float32")
    jx, tx = jnp.abs(jx), tx.abs()
    _, idx = tmoe.top_k(torch.softmax(tx[0] @ tp["router"], dim=-1), 2)
    assert idx.tolist() == [[0, 1] if router == "zeros" else [1, 3]] * 20
    jout, jaux = jmoe.moe_forward(jp, jcfg, jx)
    tout, taux = tmoe.moe_forward(tp, cfg, tx)
    np.testing.assert_allclose(f32(tout), f32(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=TOL)


def test_moe_forward_bf16_matches_jax():
    """bf16 weights and activations on identical inputs (the router still
    runs in float32): within the bf16 tolerance of the port's kernels."""
    cfg, jcfg = configs("bfloat16")
    jp, tp = moe_params(jcfg, "bfloat16")
    jx, tx = inputs((1, 24, cfg.d_model), "bfloat16")
    jout, jaux = jmoe.moe_forward(jp, jcfg, jx)
    tout, taux = tmoe.moe_forward(tp, cfg, tx)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(tout), f32(jout), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=1e-5)


def test_moe_forward_is_deterministic_with_dropped_assignments():
    """Dropped assignments are parked at slot C-1 with zero weight: two
    runs give the same bits, and a fully dropped token gets the shared
    expert alone."""
    cfg, jcfg = configs(capacity_factor=0.25)
    _, tp = moe_params(jcfg, "float32")
    _, tx = inputs((1, 64, cfg.d_model), "float32")
    a, _ = tmoe.moe_forward(tp, cfg, tx)
    b, _ = tmoe.moe_forward(tp, cfg, tx)
    assert torch.equal(a, b)
    # the last token finds both its experts full
    _, idx = tmoe.top_k(torch.softmax(tx[0] @ tp["router"], dim=-1), cfg.experts_per_token)
    before = torch.bincount(idx[:-1].flatten(), minlength=cfg.num_experts)
    assert bool((before[idx[-1]] >= tmoe.capacity(64, cfg)).all())
    shared_only = tmoe.mlp_forward(tp["shared"], tx[0, -1])
    torch.testing.assert_close(a[0, -1], shared_only, atol=TOL, rtol=TOL)
