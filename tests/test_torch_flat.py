"""The port's flat-cache decode path on the CPU: the decode kernel's plain
version against the Pallas kernel (interpret mode) and its jnp oracle, the
non-gated GELU MLP, the sliding-window ring cache, and granite-20b (MQA,
GELU) through the model and the engine, each against the JAX package on
the same numpy inputs or bridged weights."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs import long_context_variant as jax_long_context  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_bhd  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import run_closed_loop as jax_run_closed_loop  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, get_config, get_smoke_config, long_context_variant,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_GROUP, decode_attention_plain, splits_for,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import kernels_bridge  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.serving import Engine, Request, run_closed_loop  # noqa: E402

ARCH = "granite-20b"
# tests/test_kernels.py's bounds for the Pallas decode kernel
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_LEN = 64
NEW_TOKENS = 6
_CACHE = {}


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def both(x: np.ndarray, dtype: str):
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


# -- the decode kernel's plain version --------------------------------------------


def _decode_inputs(rng, B, H, KV, S, D, dtype):
    return [both(normal(rng, s), dtype) for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,S,D,bk,valid_to",
    [
        (1, 4, 4, 256, 64, 128, 255),
        (2, 8, 2, 512, 64, 128, 300),
        (1, 4, 1, 256, 128, 256, 17),
    ],
)
def test_decode_plain_matches_pallas_and_ref(B, H, KV, S, D, bk, valid_to, dtype):
    """The reference's own sweep (tests/test_kernels.py) and tolerances."""
    rng = np.random.default_rng(S + H)
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, H, KV, S, D, dtype)
    valid = np.arange(S) <= valid_to
    vmask = np.broadcast_to(valid, (B, S))
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(vmask.copy()))
    pallas = decode_attention_bhd(qj, kj, vj, jnp.asarray(vmask, jnp.int32), block_k=bk,
                                  interpret=True)
    close(got, pallas, TOL[dtype])
    close(got, ref.decode_attention_ref(qj, kj, vj, jnp.asarray(valid)), TOL[dtype])


def _ragged_mask(rng, B, S, kind):
    """Per-row prefixes of ragged lengths, or ring-shaped rows: a run of
    valid slots that wraps around the end of the cache."""
    valid = np.zeros((B, S), bool)
    for b in range(B):
        if kind == "prefix":
            valid[b, :int(rng.integers(1, S + 1))] = True
        else:
            start, n = int(rng.integers(0, S)), int(rng.integers(1, S))
            valid[b, (start + np.arange(n)) % S] = True
    return valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["prefix", "ring"])
@pytest.mark.parametrize(
    "B,H,KV,S,D,bk",
    [
        (3, 12, 1, 256, 64, 128),  # G = 12 over one KV head (MQA)
        (2, 8, 2, 128, 32, 64),
        (2, 48, 1, 128, 128, 128), # granite-20b's group
        (2, 6, 2, 128, 16, 64),    # phi4-mini's smoke heads: head_dim 16, G = 3
        (2, 14, 2, 128, 16, 64),   # head_dim 16 at internvl2-1b's G = 7
    ],
)
def test_decode_plain_ragged_and_ring_masks(B, H, KV, S, D, bk, kind, dtype):
    """Masks that differ per row: the Pallas kernel takes them as they are;
    the oracle takes one row's (S,) mask at a time."""
    rng = np.random.default_rng(S + H + len(kind))
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, H, KV, S, D, dtype)
    valid = _ragged_mask(rng, B, S, kind)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(valid))
    pallas = decode_attention_bhd(qj, kj, vj, jnp.asarray(valid, jnp.int32), block_k=bk,
                                  interpret=True)
    close(got, pallas, TOL[dtype])
    for b in range(B):
        want = ref.decode_attention_ref(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1],
                                        jnp.asarray(valid[b]))
        close(got[b:b + 1], want, TOL[dtype])


def test_decode_row_with_nothing_valid_gives_zeros():
    """C8: a row whose mask is all False (an idle slot) gives zeros, as the
    port's paged decode does; the Pallas kernel and the oracle give the
    unweighted mean of v there.  Only idle slots see such rows."""
    rng = np.random.default_rng(8)
    B, H, KV, S, D = 2, 4, 1, 128, 32
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(rng, B, H, KV, S, D, "float32")
    valid = np.ones((B, S), bool)
    valid[1] = False
    got = f32(decode_attention_plain(qt, kt, vt, torch.from_numpy(valid)))
    assert np.all(got[1] == 0.0)
    pallas = f32(decode_attention_bhd(qj, kj, vj, jnp.asarray(valid, jnp.int32),
                                      interpret=True))
    mean_v = f32(vj)[1].mean(axis=0)  # (KV, D): every query head of a group
    np.testing.assert_allclose(pallas[1], np.repeat(mean_v, H // KV, axis=0), atol=1e-5)
    close(got[0], pallas[0], TOL["float32"])


def test_ops_decode_routes_cpu_to_plain_without_counting():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(normal(rng, (2, 1, 4, 32)))
    k = torch.from_numpy(normal(rng, (2, 20, 2, 32)))
    v = torch.from_numpy(normal(rng, (2, 20, 2, 32)))
    valid = torch.from_numpy(_ragged_mask(rng, 2, 20, "ring"))
    before = ops.launches()
    out = ops.decode_attention(q, k, v, valid)
    torch.testing.assert_close(out[:, 0], decode_attention_plain(q[:, 0], k, v, valid),
                               atol=0, rtol=0)
    assert ops.launches() == before
    meta = torch.empty((2, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.decode_attention(meta, meta[:, :, :2], meta[:, :, :2],
                             torch.empty((2, 1), dtype=torch.bool, device="meta"))


def test_flat_decode_goes_through_the_kernel_wrapper(monkeypatch):
    """C7: the model's flat decode calls ops.decode_attention (the kernel on
    a card); the JAX bridge takes its jnp einsum on every serving path."""
    seen = []

    def spy(q, k, v, valid, scale=None):
        seen.append(tuple(valid.shape))
        return torch.zeros_like(q)

    monkeypatch.setattr(ops, "decode_attention", spy)
    m = Model(get_smoke_config(ARCH, dtype="float32"))
    p = m.init(0, device="cpu")
    cache = m.init_cache(2, 16, device="cpu")
    m.decode_step(p, cache, torch.ones((2, 1), dtype=torch.long), torch.tensor([3, -1]))
    assert seen == [(2, 16)] * m.cfg.num_layers
    q = torch.zeros((1, 1, 4, 32))
    kernels_bridge.decode_attention(q, q[:, :, :1], q[:, :, :1], torch.ones((1, 1), dtype=bool))
    assert len(seen) == m.cfg.num_layers + 1


def test_splits_cover_the_sequence_in_whole_tiles():
    for B, KV, S in ((8, 1, 2048), (8, 8, 2048), (1, 1, 5), (3, 2, 1000), (8, 1, 512)):
        splits, split_len = splits_for(B, KV, S, 132)
        assert split_len % 32 == 0 and splits * split_len >= S > (splits - 1) * split_len
    assert splits_for(8, 1, 2048, 132) == (16, 128)  # granite-20b at batch 8: 128 blocks
    assert MAX_GROUP >= 48


# -- the GELU MLP ---------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_gelu_mlp_matches_jax(dtype, tol):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(10)
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_up": normal(rng, (d, ff), d ** -0.5), "w_down": normal(rng, (ff, d), ff ** -0.5)}
    x = normal(rng, (2, 3, d))
    want = jmlp.mlp_forward({k: both(v, dtype)[0] for k, v in p.items()}, both(x, dtype)[0])
    got = tmlp.mlp_forward({k: both(v, dtype)[1] for k, v in p.items()}, both(x, dtype)[1])
    close(got, want, tol)
    assert set(tmlp.mlp_specs(cfg)) == {"w_up", "w_down"}


# -- the sliding-window ring cache ------------------------------------------------

RING_W = 8


def ring_configs():
    return (long_context_variant(get_smoke_config("qwen3-8b", dtype="float32"), RING_W),
            jax_long_context(jax_smoke("qwen3-8b", dtype="float32"), RING_W))


def attn_params(rng, cfg):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": normal(rng, (d, H * hd), d ** -0.5),
        "wk": normal(rng, (d, KV * hd), d ** -0.5),
        "wv": normal(rng, (d, KV * hd), d ** -0.5),
        "wo": normal(rng, (H * hd, d), (H * hd) ** -0.5),
        "q_norm": 1.0 + normal(rng, (hd,), 0.1),
        "k_norm": 1.0 + normal(rng, (hd,), 0.1),
    }
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_ring_prefill_and_decode_match_jax_past_the_wrap():
    """gqa_prefill emits the last W rows with slot_pos; gqa_decode writes
    slot pos % W for live rows only and masks by the window.  Outputs,
    cache and slot_pos equal JAX's at every step past the wrap."""
    cfg, jcfg = ring_configs()
    rng = np.random.default_rng(11)
    jp, tp = attn_params(rng, cfg)
    B, S = 3, 16
    x = normal(rng, (B, S, cfg.d_model))
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jout, jc = jattn.gqa_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(positions))
    tout, tc = tattn.gqa_prefill(tp, cfg, torch.from_numpy(x), torch.from_numpy(positions))
    close(tout, jout, 1e-5)
    assert sorted(tc) == sorted(jc) == ["k", "slot_pos", "v"]
    tc = {k: v.clone() for k, v in tc.items()}  # the decode writes in place
    pos = np.array([S, S + 3, -1], np.int32)  # slot 2 idle
    live = pos >= 0
    for _ in range(2 * RING_W):
        xd = normal(rng, (B, 1, cfg.d_model))
        jout, jc = jattn.gqa_decode(jp, jcfg, jnp.asarray(xd), jc, jnp.asarray(pos))
        tout, tc = tattn.gqa_decode(tp, cfg, torch.from_numpy(xd), tc, torch.from_numpy(pos))
        close(tout[live], np.asarray(jout)[live], 1e-5)
        for key in ("k", "v", "slot_pos"):
            close(tc[key], jc[key], 1e-5)
        pos = np.where(live, pos + 1, pos)
    assert tc["slot_pos"].dtype == torch.int32
    assert tc["slot_pos"][2].tolist() == list(range(S - RING_W, S))  # the idle slot's


def test_ring_prefill_refuses_a_length_off_the_window():
    cfg, _ = ring_configs()
    rng = np.random.default_rng(12)
    _, tp = attn_params(rng, cfg)
    x = torch.from_numpy(normal(rng, (1, 12, cfg.d_model)))
    with pytest.raises(ValueError, match="multiple of the ring window"):
        tattn.gqa_prefill(tp, cfg, x, torch.arange(12)[None])


def test_ring_cache_shape_and_paged_refusal():
    """init_cache gives W-row rings (slot_pos -1) when W < max_len, as the
    reference's test_sliding_window_variant_limits_cache expects, and the
    full cache otherwise; the paged cache takes no window."""
    cfg, jcfg = ring_configs()
    m = Model(cfg)
    cache = m.init_cache(2, max_len=64, device="cpu")
    jcache = JaxModel(jcfg, remat=False).init_cache(2, 64)
    for key in ("k", "v", "slot_pos"):
        assert tuple(cache["layers"][key].shape) == jcache["layers"][key].shape
        np.testing.assert_array_equal(f32(cache["layers"][key]), f32(jcache["layers"][key]))
    assert cache["layers"]["k"].shape[2] == RING_W
    assert "slot_pos" not in m.init_cache(2, max_len=RING_W, device="cpu")["layers"]
    assert not m.supports_paged_kv
    with pytest.raises(ValueError, match="paged KV unsupported"):
        m.init_paged_cache(2, 8, 4, 4, device="cpu")


def test_ring_model_prefill_and_decode_match_jax():
    """qwen3 smoke through long_context_variant(window=8), driven as the
    reference's long-context specs drive it: Model.prefill over a multiple
    of the window, then Model.decode_step past the wrap."""
    cfg, jcfg = ring_configs()
    jm = JaxModel(jcfg, remat=False)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    tp = params_from_jax(_flatten(jp), cfg, device="cpu")
    rng = np.random.default_rng(13)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, jcache = jm.prefill(jp, tokens=jnp.asarray(toks))
    tl, tcache = m.prefill(tp, torch.from_numpy(toks).long())
    close(tl, jl, 1e-4)
    jstep = jax.jit(jm.decode_step)
    pos = np.array([16, 16], np.int32)
    for _ in range(RING_W + 3):
        tok = rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = m.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos))
        close(tl, jl, 1e-4)
        pos = pos + 1
    for key in ("k", "v", "slot_pos"):
        close(tcache["layers"][key], jcache["layers"][key], 1e-4)


def test_engine_refuses_a_ring_cache_as_the_reference_does():
    cfg, jcfg = ring_configs()
    m = Model(cfg)
    p = m.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="ring caches"):
        Engine(m, p, batch=2, max_len=64, kv_backend="flat")
    jm = JaxModel(jcfg, remat=False)
    with pytest.raises(NotImplementedError, match="ring caches"):
        JaxEngine(jm, jm.init(jax.random.PRNGKey(0))[0], batch=2, max_len=64,
                  kv_backend="flat")
    # a window no shorter than max_len never wraps: served on the flat cache
    assert Engine(m, p, batch=2, max_len=RING_W, kv_backend="auto").kv_backend == "flat"


# -- granite-20b: config, bridge, model, engine -----------------------------------


def bridged(dtype):
    if ("bridged", dtype) not in _CACHE:
        jm = JaxModel(jax_smoke(ARCH, dtype=dtype), remat=False)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        cfg = get_smoke_config(ARCH, dtype=dtype)
        _CACHE[("bridged", dtype)] = (jm, jp, Model(cfg),
                                      params_from_jax(_flatten(jp), cfg, device="cpu"))
    return _CACHE[("bridged", dtype)]


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_granite_config_equals_reference_field_by_field(getter, window):
    if getter == "full":
        mine, theirs = get_config(ARCH), jax_config(ARCH)
    else:
        mine, theirs = get_smoke_config(ARCH), jax_smoke(ARCH)
    if window:
        mine, theirs = long_context_variant(mine, window), jax_long_context(theirs, window)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert ARCH in ARCH_IDS
    assert long_context_variant(get_config("mamba2-370m")) is get_config("mamba2-370m")


def test_granite_bridge_carries_the_key_tree_without_w_gate():
    jm, jp, m, tp = bridged("float32")
    flat, mine = _flatten(jp), flatten(tp)
    assert sorted(mine) == sorted(flat) == sorted(m.param_specs())
    assert "layers/mlp/w_up" in mine and "layers/mlp/w_gate" not in mine
    for key, arr in flat.items():
        np.testing.assert_array_equal(mine[key].numpy(), arr)
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax({**flat, "layers/mlp/w_gate": flat["layers/mlp/w_up"]}, m.cfg,
                        device="cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.15)])
def test_granite_prefill_matches_jax(dtype, tol):
    jm, jp, m, tp = bridged(dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, m.cfg.vocab_size, size=(2, 32)).astype(np.int32)
    lengths = np.array([21, 32], np.int32)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), lengths=jnp.asarray(lengths))
    tl, tc = m.prefill(tp, torch.from_numpy(toks).long(), torch.from_numpy(lengths))
    close(tl, jl, tol)
    a, b = leaves(tc), leaves(jc)
    assert sorted(a) == sorted(b)
    for k in a:
        close(a[k], b[k], tol)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.15)])
def test_granite_decode_matches_jax(dtype, tol, paged):
    """Four ragged decode steps, slot 2 idle, on the flat or paged cache."""
    jm, jp, m, tp = bridged(dtype)
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
        close(f32(tl)[live], f32(jl)[live], tol)
        pos = np.where(live, pos + 1, pos)
    a, b = leaves(tcache), leaves(jcache)
    for k in a:
        if k.endswith("pool_k") or k.endswith("pool_v"):
            # the port's pools end in a sink page, which the JAX package's lack
            assert a[k].shape[1] == b[k].shape[1] + 1
            a[k] = a[k][:, :-1]
        if not k.endswith("page_tables"):
            close(a[k], b[k], tol)


@pytest.mark.parametrize("backend", ["flat", "paged"])
def test_granite_tokens_equal_jax_engine(backend):
    """Token for token on the same float32 weights, through slot reuse and
    a 16-token bucket boundary."""
    jm, jp, m, tp = bridged("float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, m.cfg.vocab_size, size=L).astype(np.int32)
               for L in (4, 17, 3, 9, 12)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    jax_run_closed_loop(JaxEngine(jm, jp, batch=2, max_len=MAX_LEN, kv_backend=backend), jreqs)
    eng = Engine(m, tp, batch=2, max_len=MAX_LEN, kv_backend=backend)
    assert eng.kv_backend == backend
    run_closed_loop(eng, treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens, j.out_tokens)


def granite_port():
    if "port" not in _CACHE:
        m = Model(get_smoke_config(ARCH))
        _CACHE["port"] = (m, m.init(0, device="cpu"))
    return _CACHE["port"]


def solo_tokens(m, params, prompt):
    eng = Engine(m, params, batch=1, max_len=MAX_LEN, kv_backend="flat")
    req = Request(rid=0, prompt=prompt, max_new_tokens=NEW_TOKENS)
    run_closed_loop(eng, [req])
    return list(req.out_tokens)


@pytest.mark.parametrize("backend", ["flat", "paged"])
def test_granite_ragged_oracle_staggered_admits(backend):
    """tests/test_engine_ragged.py's oracle on granite smoke (bf16, as
    served): three requests admitted at staggered steps decode exactly as
    each does alone."""
    m, params = granite_port()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, m.cfg.vocab_size, size=L).astype(np.int32) for L in (3, 5, 9)]
    solo = [solo_tokens(m, params, p) for p in prompts]
    eng = Engine(m, params, batch=3, max_len=MAX_LEN, kv_backend=backend)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    eng.admit(reqs[0])
    eng.step()
    eng.step()
    eng.admit(reqs[1])
    eng.step()
    eng.admit(reqs[2])
    while eng.num_live:
        eng.step()
    for req, want in zip(reqs, solo):
        assert req.out_tokens == want, (req.rid, req.out_tokens, want)


def test_serve_cli_serves_granite_on_the_flat_backend(tmp_path, capsys):
    out = tmp_path / "stats.json"
    serve.main(["--arch", ARCH, "--device", "cpu", "--backend", "flat", "--requests", "3",
                "--batch", "2", "--new-tokens", "3", "--stats-json", str(out)])
    text = capsys.readouterr().out
    assert "arch=granite-smoke" in text and "backend=flat" in text and "served=3" in text
    assert out.exists()
