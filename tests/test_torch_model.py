"""The port's configs, weight bridge and models (dense, SSM, hybrid, MoE
with MLA or GQA attention, and the vlm/audio dense stacks fed tokens or
frontend embeddings) against the JAX package's, on the same bridged
weights."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import long_context_variant  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402

ARCH = "qwen3-8b"
# the deepseek-v2 smoke config with GQA in place of MLA: the MoE family on
# the paged backend and the attention kernels
GQA_MOE = "deepseek-v2-236b+gqa"
MOE_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", GQA_MOE)
ARCHS = ("qwen3-8b", "mamba2-370m", "zamba2-1.2b", "phi4-mini-3.8b", "llama3-405b",
         "internvl2-1b", "musicgen-large") + MOE_ARCHS
# a pure SSM model has no KV to page, nor has MLA's latent cache a paged layout
PAGED_ARCHS = ("qwen3-8b", "zamba2-1.2b", "phi4-mini-3.8b", "llama3-405b", "internvl2-1b",
               "musicgen-large", GQA_MOE)
DTYPE_TOLS = (("float32", 1e-4), ("bfloat16", 0.15))
STUB_ARCHS = ("internvl2-1b", "musicgen-large")  # fed frontend embeddings
# one key of each new tree, so a renamed leaf fails loudly
TREE_KEYS = {
    "qwen3-8b": ("layers/attn/wq", "layers/mlp/w_up"),
    "mamba2-370m": ("layers/w_z", "layers/conv_w", "layers/A_log"),
    "zamba2-1.2b": ("shared_attn/wq", "shared_attn/ln", "layers/mamba_0/w_z",
                    "layers/mamba_1/w_out"),
    "phi4-mini-3.8b": ("layers/attn/wk", "layers/mlp/w_gate"),
    "llama3-405b": ("layers/attn/wv", "layers/mlp/w_down"),
    "internvl2-1b": ("layers/attn/wo", "layers/ln2"),
    "musicgen-large": ("layers/attn/wq", "layers/ln1"),
    "deepseek-v2-236b": ("dense_0/attn/w_dkv", "dense_0/mlp/w_gate", "layers/attn/w_uk",
                         "layers/moe/we_gate", "layers/moe/shared/w_up"),
    "deepseek-v3-671b": ("mtp/proj", "mtp/norm", "layers/attn/q_norm", "layers/moe/router"),
    GQA_MOE: ("dense_0/attn/wq", "layers/attn/wk", "layers/moe/we_down"),
}
_CACHE = {}


def variant(get, arch, **overrides):
    """``get(arch)`` of either package's registry; ``+gqa`` swaps MLA for GQA."""
    base = arch.removesuffix("+gqa")
    cfg = get(base, **overrides)
    return dataclasses.replace(cfg, attention_kind="gqa") if base != arch else cfg


def dtype_cases(archs):
    """(dtype, tol, arch) for float32 everywhere and bf16 except for MoE
    models: bf16 noise before the router can flip a near-tied top-k, and a
    flipped expert is not a question of tolerance."""
    return [(dt, tol, a) for dt, tol in DTYPE_TOLS for a in archs
            if dt == "float32" or a not in MOE_ARCHS]


def bridged(dtype, arch=ARCH):
    """(jax model, jax params, port model, port params) on one set of weights."""
    if (arch, dtype) not in _CACHE:
        jcfg = variant(jax_smoke, arch, dtype=dtype)
        jm = JaxModel(jcfg, remat=False)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        cfg = variant(get_smoke_config, arch, dtype=dtype)
        tp = params_from_jax(_flatten(jp), cfg, device="cpu")
        _CACHE[(arch, dtype)] = (jm, jp, Model(cfg), tp)
    return _CACHE[(arch, dtype)]


def leaves(tree, prefix=""):
    """{key path: leaf} of a nested dict (either package's cache tree)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_trees_close(mine, theirs, tol, skip=("page_tables",)):
    a, b = leaves(mine), leaves(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        if k.split("/")[-1] not in skip:
            np.testing.assert_allclose(f32(a[k]), f32(b[k]), atol=tol, rtol=tol, err_msg=k)


def without_sink(mine, theirs):
    """The port's paged cache without its pools' sink page, which the JAX
    package's pools lack (ROADMAP C5); each pool must hold exactly that one
    page more."""
    out = {}
    for k, v in mine.items():
        if isinstance(v, dict):
            out[k] = without_sink(v, theirs[k])
        elif k in ("pool_k", "pool_v"):
            # pages are the 4th axis from the end, stacked or not
            assert v.shape[-4] == theirs[k].shape[-4] + 1, (k, v.shape, theirs[k].shape)
            out[k] = v[..., :-1, :, :, :]
        else:
            out[k] = v
    return out


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_config_copy_equals_reference_field_by_field(getter, arch):
    if getter == "full":
        mine, theirs = variant(get_config, arch), variant(jax_config, arch)
    else:
        mine = variant(get_smoke_config, arch, dtype="float32")
        theirs = variant(jax_smoke, arch, dtype="float32")
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.padded_vocab == theirs.padded_vocab
    assert mine.param_count() == theirs.param_count()
    assert mine.kv_bytes_per_token() == theirs.kv_bytes_per_token()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_covers_every_key(arch):
    jm, jp, m, tp = bridged("float32", arch)
    flat = _flatten(jp)
    mine = flatten(tp)
    assert sorted(mine) == sorted(flat)  # none missing, none extra
    assert sorted(m.param_specs()) == sorted(flat)
    assert set(TREE_KEYS[arch]) <= set(mine)
    for key, arr in flat.items():
        assert tuple(mine[key].shape) == arr.shape, key
        np.testing.assert_array_equal(mine[key].numpy(), arr)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_refuses_missing_extra_and_misshapen_keys(arch):
    _, jp, m, _ = bridged("float32", arch)
    flat = _flatten(jp)
    cfg = m.cfg
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in flat.items() if k != "head"}, cfg, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax({**flat, "extra/proj": flat["head"]}, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**flat, "head": flat["head"][:, :8]}, cfg, device="cpu")


def test_bf16_bridge_goes_through_float32():
    jm, jp, m, tp = bridged("bfloat16")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    want = np.asarray(jp["layers"]["attn"]["wq"], np.float32)
    np.testing.assert_array_equal(tp["layers"]["attn"]["wq"].float().numpy(), want)


@pytest.mark.parametrize("arch,drawn,ones", [
    ("qwen3-8b", "layers/attn/wq", "layers/ln1"),
    ("mamba2-370m", "layers/w_xbc", "layers/D"),
    ("zamba2-1.2b", "shared_attn/wq", "layers/mamba_1/ssm_norm"),
])
def test_seeded_init_has_reference_shapes_and_is_reproducible(arch, drawn, ones):
    _, jp, m, _ = bridged("float32", arch)
    a, b, c = (m.init(seed, device="cpu") for seed in (3, 3, 4))
    shapes = {k: tuple(v.shape) for k, v in flatten(a).items()}
    assert shapes == {k: v.shape for k, v in _flatten(jp).items()}
    for k, v in flatten(a).items():
        assert torch.equal(v, flatten(b)[k]), k
    assert not torch.equal(flatten(a)[drawn], flatten(c)[drawn])
    assert torch.all(flatten(a)[ones] == 1)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, _, m, _ = bridged("float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init(0)  # the default device is cuda: no silent CPU fallback


def _prefill_inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    lengths = np.array([21, 32], np.int32)  # one right-padded row
    return toks, lengths


@pytest.mark.parametrize("dtype,tol,arch", dtype_cases(ARCHS))
def test_prefill_logits_and_cache_match_jax(dtype, tol, arch):
    jm, jp, m, tp = bridged(dtype, arch)
    toks, lengths = _prefill_inputs(m.cfg)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), lengths=jnp.asarray(lengths))
    tl, tc = m.prefill(tp, torch.from_numpy(toks).long(), torch.from_numpy(lengths))
    assert tl.shape == jl.shape
    np.testing.assert_allclose(f32(tl), f32(jl), atol=tol, rtol=tol)
    # every cache leaf: attention k/v or MLA latents, SSM conv tails and states
    assert_trees_close(tc, jc, tol)
    # the padded vocab tail is masked
    assert np.all(f32(tl)[..., m.cfg.vocab_size:] <= -1e29)


@pytest.mark.parametrize("arch", STUB_ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.15)])
def test_prefill_from_frontend_embeddings_matches_jax(dtype, tol, arch):
    """A stub frontend's embeddings in place of token ids: the port's
    ``prefill(embeds=)`` and JAX's on the same float32 input (cast to the
    config's dtype by both), with ragged lengths."""
    jm, jp, m, tp = bridged(dtype, arch)
    cfg = m.cfg
    rng = np.random.default_rng(3)
    emb = (0.02 * rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    lengths = np.array([cfg.frontend_tokens - 5, cfg.frontend_tokens], np.int32)
    jl, jc = jm.prefill(jp, embeds=jnp.asarray(emb), lengths=jnp.asarray(lengths))
    tl, tc = m.prefill(tp, lengths=torch.from_numpy(lengths), embeds=torch.from_numpy(emb))
    assert tl.shape == jl.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=tol, rtol=tol)
    assert_trees_close(tc, jc, tol)
    # the embeddings replace embed(tokens): the same rows give the same logits
    toks = rng.integers(1, cfg.vocab_size, size=(2, 8))
    rows = tp["embed"][torch.from_numpy(toks)]
    by_tokens, _ = m.prefill(tp, torch.from_numpy(toks))
    by_embeds, _ = m.prefill(tp, embeds=rows.float())
    torch.testing.assert_close(by_embeds, by_tokens, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,tol,arch,paged",
                         [c + (False,) for c in dtype_cases(ARCHS)]
                         + [c + (True,) for c in dtype_cases(PAGED_ARCHS)])
def test_decode_logits_match_jax(dtype, tol, arch, paged):
    """Four ragged decode steps from per-slot positions, slot 2 idle, on the
    flat or the paged cache; live rows' logits match (idle rows' are
    discarded by the engine, and the two packages fill them differently),
    and so does every cache leaf (idle slots' SSM states stay as they were).
    MoE models only in float32 (see :func:`dtype_cases`)."""
    jm, jp, m, tp = bridged(dtype, arch)
    B, ps, max_pages = 3, 4, 4
    rng = np.random.default_rng(2)
    if paged:
        jcache = jm.init_paged_cache(B, 16, ps, max_pages)
        tcache = m.init_paged_cache(B, 16, ps, max_pages, device="cpu")
        pt = np.array([[5, 9, 2, 0], [1, 3, 4, 0], [0, 0, 0, 0]], np.int32)
        jcache["page_tables"] = jnp.asarray(pt)
        tcache["page_tables"].copy_(torch.from_numpy(pt))
        jstep, tstep = jax.jit(jm.decode_step_paged), m.decode_step_paged
    else:
        jcache = jm.init_cache(B, 16)
        tcache = m.init_cache(B, 16, device="cpu")
        jstep, tstep = jax.jit(jm.decode_step), m.decode_step
    pos = np.array([0, 3, -1], np.int32)
    live = pos >= 0
    for _ in range(4):
        tok = rng.integers(1, m.cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(tok).long(), torch.from_numpy(pos))
        np.testing.assert_allclose(f32(tl)[live], f32(jl)[live], atol=tol, rtol=tol)
        pos = np.where(live, pos + 1, pos)
    assert_trees_close(without_sink(tcache, jcache), jcache, tol)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_scatter_prefill_into_pages_matches_jax(arch):
    jm, jp, m, tp = bridged("float32", arch)
    toks = np.arange(1, 17, dtype=np.int32)[None]
    _, jpre = jm.prefill(jp, tokens=jnp.asarray(toks), lengths=jnp.asarray([11]))
    _, tpre = m.prefill(tp, torch.from_numpy(toks).long(), torch.tensor([11]))
    jcache = jm.init_paged_cache(2, 8, 4, 4)
    tcache = m.init_paged_cache(2, 8, 4, 4, device="cpu")
    jout = jm.scatter_prefill(jcache, jpre, 1, 11, [6, 2, 5])
    tout = m.scatter_prefill(tcache, tpre, 1, 11, [6, 2, 5])
    assert_trees_close(without_sink(tout, jout), jout, 1e-5)
    pools = tcache["layers"].get("attn", tcache["layers"])  # the hybrid's sit under attn/
    assert tout["layers"].get("attn", tout["layers"])["pool_k"] is pools["pool_k"]  # in place


# ops that copy a device value to the host, and so wait for the device
HOST_SYNCS = {"aten.nonzero", "aten._local_scalar_dense", "aten.item"}


class AtenOps(TorchDispatchMode):
    """The name of every aten op dispatched under it, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,window,paged", [
    ("granite-20b", None, False),
    ("qwen3-8b", 8, False),  # the ring cache
    ("deepseek-v2-236b", None, False),  # MLA's latent cache
    ("mamba2-370m", None, False),
    ("zamba2-1.2b", None, True),
    ("zamba2-1.2b", None, False),
], ids=["granite-flat", "qwen3-ring", "deepseek-v2-mla", "mamba2", "zamba2-paged",
        "zamba2-flat"])
def test_decode_step_never_waits_for_the_device_and_idle_slots_keep_their_rows(
        arch, window, paged):
    """One decode step with idle slots at both ends and in the middle
    dispatches no op that reads a device value on the host (every slot
    writes, at fixed shapes), and leaves every idle slot's cache rows (k/v,
    the ring's slot_pos, MLA's latent rows, the SSM conv tail and state,
    the pages its table names) equal to before, while each live slot's
    change."""
    cfg = get_smoke_config(arch)
    m = Model(long_context_variant(cfg, window) if window else cfg)
    params = m.init(0, device="cpu")
    live = np.array([False, True, False, True, False])
    B, max_len, ps = live.size, 32, 4
    if paged:
        cache = m.init_paged_cache(B, B * max_len // ps, ps, max_len // ps, device="cpu")
    else:
        cache = m.init_cache(B, max_len, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for key, leaf in flatten(cache).items():
        if key == "page_tables":  # every slot its own pages
            perm = torch.randperm(leaf.numel(), generator=gen)
            leaf.copy_(perm.view(leaf.shape))
        elif key.endswith("slot_pos"):  # positions no step below writes
            leaf.copy_(torch.randint(1, 9, leaf.shape, generator=gen))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = {k: v.clone() for k, v in flatten(cache).items()}
    pos = torch.from_numpy(np.where(live, [0, 9, 0, 14, 0], -1))
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen)
    step = m.decode_step_paged if paged else m.decode_step
    with AtenOps() as seen:
        step(params, cache, tok, pos)
    assert not HOST_SYNCS & set(seen.names)
    slots = {"idle": torch.from_numpy(np.flatnonzero(~live)),
             "live": torch.from_numpy(np.flatnonzero(live))}
    for key, leaf in flatten(cache).items():
        axis = 1 if key.startswith("layers/") else 0  # past a stacked layer axis
        for side, idx in slots.items():
            if key.endswith(("pool_k", "pool_v")):  # the pages the slots' tables name
                idx = cache["page_tables"][idx].flatten().long()
            rows = (leaf.index_select(axis, idx), before[key].index_select(axis, idx))
            if side == "idle":
                assert torch.equal(*rows), key
            elif key != "page_tables":
                assert not torch.equal(*rows), key
