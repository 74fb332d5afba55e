"""The port's SSD scan and Mamba2 block against the JAX package's, one
function at a time, on the same numpy inputs; the scan wrapper's routing;
and the engine's SSM-specific choices (prefill pad, KV backend)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_bshp  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import ParamFactory  # noqa: E402
from repro.serving.engine import attn_layer_count as jax_attn_layers  # noqa: E402
from repro.serving.engine import page_hbm_bytes as jax_page_bytes  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_plain  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving.engine import attn_layer_count, page_hbm_bytes  # noqa: E402

SCAN_TOL = 2e-3  # tests/test_kernels.py's bound for the Pallas scan
TOL = {"float32": 1e-4, "bfloat16": 0.15}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "mamba2-370m"


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def both(tree, dtype="float32"):
    """The same numpy values as jax arrays and torch tensors in ``dtype``."""
    return ({k: jnp.asarray(v, JNP[dtype]) for k, v in tree.items()},
            {k: torch.from_numpy(v).to(TORCH[dtype]) for k, v in tree.items()})


def scan_inputs(rng, B, S, H, P, N):
    """Drawn as tests/test_kernels.py draws them: dt through softplus, A
    negative."""
    x = normal(rng, (B, S, H, P))
    dt = np.log1p(np.exp(normal(rng, (B, S, H))))
    A = -np.exp(normal(rng, (H,)) * 0.5)
    return x, dt, A, normal(rng, (B, S, N)), normal(rng, (B, S, N))


def block_params(rng, cfg):
    """One Mamba2 block's weights, as numpy, keyed like both packages."""
    d, di, n, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    C = di + 2 * n
    return {
        "w_z": normal(rng, (d, di), d ** -0.5),
        "w_xbc": normal(rng, (d, C), d ** -0.5),
        "w_dt": normal(rng, (d, H), d ** -0.5),
        "conv_w": normal(rng, (cfg.conv_width, C), 0.5),
        "conv_b": normal(rng, (C,), 0.1),
        "A_log": normal(rng, (H,), 0.5),
        "dt_bias": normal(rng, (H,), 0.5),
        "D": 1.0 + normal(rng, (H,), 0.1),
        "ssm_norm": 1.0 + normal(rng, (di,), 0.1),
        "w_out": normal(rng, (di, d), di ** -0.5),
    }


# -- the scan ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (1, 128, 2, 32, 16, 32),
        (2, 256, 4, 64, 32, 64),
        (1, 64, 8, 16, 64, 64),   # single chunk
        (2, 96, 2, 32, 16, 32),   # 3 chunks
    ],
)
def test_ssm_scan_plain_matches_pallas_and_ref(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S + H)
    args = scan_inputs(rng, B, S, H, P, N)
    y, fin = ssm_scan_plain(*(torch.from_numpy(a) for a in args), chunk)
    jargs = [jnp.asarray(a) for a in args]
    yp, finp = ssm_scan_bshp(*jargs, chunk=chunk, interpret=True)
    yr, finr = ref.ssm_scan_ref(*jargs)
    for want_y, want_fin in ((yp, finp), (yr, finr)):
        close(y, want_y, SCAN_TOL)
        close(fin, want_fin, SCAN_TOL)
    # one body: the block's ssd_chunked is the plain scan
    y2, fin2 = tssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    assert torch.equal(y, y2) and torch.equal(fin, fin2)


def test_ssm_scan_plain_matches_jax_ssd_chunked_with_padded_steps():
    """dt = 0 on a row's padded tail: the final state equals the state after
    the real steps, as the reference's dt-masked prefill relies on."""
    rng = np.random.default_rng(3)
    x, dt, A, Bm, Cm = scan_inputs(rng, 2, 64, 4, 16, 16)
    dt[0, 40:] = 0.0
    got = ssm_scan_plain(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 16)
    want = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), 16)
    close(got[0], want[0], 1e-4)
    close(got[1], want[1], 1e-4)
    head = [torch.from_numpy(a[:1, :48].copy()) for a in (x, dt, Bm, Cm)]
    short = ssm_scan_plain(head[0], head[1], torch.from_numpy(A), head[2], head[3], 16)
    close(got[1][:1], short[1], 1e-5)


def test_ssm_scan_plain_refuses_a_ragged_length():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, 1, 40, 2, 16, 16)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm_scan_plain(*args, 16)


def test_ops_ssm_scan_routes_cpu_to_plain_without_counting():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, 1, 32, 2, 16, 16)]
    ops.reset_launches()
    y, fin = ops.ssm_scan(*args, chunk=16)
    want_y, want_fin = ssm_scan_plain(*args, 16)
    assert torch.equal(y, want_y) and torch.equal(fin, want_fin)
    # a sequence shorter than the chunk is one chunk, as in the Pallas wrapper
    y1, _ = ops.ssm_scan(*args, chunk=128)
    torch.testing.assert_close(y1, ssm_scan_plain(*args, 32)[0], atol=0, rtol=0)
    assert ops.launches()["ssm_scan"] == 0
    ops.LAUNCHES["ssm_scan"] = 4
    ops.reset_launches()
    assert ops.launches()["ssm_scan"] == 0


# -- the scan kernel's 3xTF32 products, in plain torch ------------------------------
#
# The CUDA kernel cannot run here.  This emulation follows its four steps
# (C·Bᵀ, each chunk's state, the carried recurrence, y) with every product
# in 3xTF32 as the kernel splits it, on the float32 bits: hi = the operand
# rounded to a tf32 (10 mantissa bits, half away from zero), lo = the
# remainder with its low 13 bits cut (the tensor core ignores them), and
# lo·hi + hi·lo + hi·hi summed in float32.  Held against a float64 run, it
# shows the design keeps float32 accuracy; one-pass TF32 does not.


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest tf32, ties away from zero: add half
    of the dropped 13 bits to the magnitude, then cut them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _cut(t: torch.Tensor) -> torch.Tensor:
    """float32 with its low 13 mantissa bits cut, as the tensor core reads it."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _cut(a - ah), _cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _scan_emulated(x, dt, A, B_, C_, L, mm):
    """The kernel's steps in float32 with its products through ``mm``."""
    Bb, S, H, P = x.shape
    N, nc = B_.shape[-1], S // L
    clip_exp = lambda t: torch.exp(torch.clamp(t, -60.0, 0.0))  # noqa: E731
    xr = x.reshape(Bb, nc, L, H, P).permute(0, 1, 3, 2, 4)  # (B, nc, H, L, P)
    dtr = dt.reshape(Bb, nc, L, H).permute(0, 1, 3, 2)  # (B, nc, H, L)
    Br, Cr = B_.reshape(Bb, nc, 1, L, N), C_.reshape(Bb, nc, 1, L, N)
    cs = torch.cumsum(dtr * A[:, None], -1)
    cb = mm(Cr, Br.transpose(-1, -2))  # chunk_cb
    lower = torch.tril(torch.ones((L, L), dtype=torch.bool))
    W = torch.where(lower, cb * clip_exp(cs[..., :, None] - cs[..., None, :])
                    * dtr[..., None, :], 0.0)
    weight = clip_exp(cs[..., -1:] - cs) * dtr
    states = mm((xr * weight[..., None]).transpose(-1, -2), Br)  # chunk_state
    carry, entering = torch.zeros_like(states[:, 0]), []
    for c in range(nc):  # state_pass
        entering.append(carry)
        carry = carry * clip_exp(cs[:, c, :, -1])[..., None, None] + states[:, c]
    entering = torch.stack(entering, 1)
    y = mm(W, xr) + mm(Cr * clip_exp(cs)[..., None], entering.transpose(-1, -2))  # chunk_scan
    return y.permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P), carry


def _tol_used(got, want) -> float:
    """The largest share of allclose's SCAN_TOL bound an element uses."""
    return max(((g.double() - w).abs() / (SCAN_TOL * (1 + w.abs()))).max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("N", [128, 64])  # mamba2-370m's and zamba2-1.2b's state
def test_ssm_scan_3xtf32_products_keep_float32_accuracy(N):
    """At mamba2's heads (P 64, chunk 128), two chunks: the 3xTF32 scan uses
    under a tenth of SCAN_TOL against float64, no more than float32 itself
    does, and agrees with the JAX package's ssd_chunked; one-pass TF32
    breaks the tolerance."""
    rng = np.random.default_rng(N)
    args = scan_inputs(rng, 1, 256, 4, 64, N)
    t = [torch.from_numpy(a) for a in args]
    want = ssm_scan_plain(*(a.double() for a in t), 128)
    three = _scan_emulated(*t, 128, _mm_3xtf32)
    one = _scan_emulated(*t, 128, _mm_tf32)
    f32 = _scan_emulated(*t, 128, torch.matmul)
    used3, used1, used32 = (_tol_used(r, want) for r in (three, one, f32))
    assert used3 < 0.1
    assert used3 <= 1.5 * used32 + 1e-3
    assert used1 > 1.0, f"one-pass TF32 used {used1:.2f} of the tolerance"
    jy, jfin = jssm.ssd_chunked(*(jnp.asarray(a) for a in args), 128)
    close(three[0], jy, SCAN_TOL)
    close(three[1], jfin, SCAN_TOL)


def test_ops_ssm_scan_refuses_other_devices():
    x = torch.empty((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.ssm_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, 0], x[:, :, 0], chunk=16)


# -- the block ---------------------------------------------------------------------


def test_ssm_specs_match_jax_init():
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    f = ParamFactory(jax.random.PRNGKey(0), jnp.float32)
    jssm.ssm_init(f, jcfg)
    specs = tssm.ssm_specs(cfg)
    assert set(specs) == set(f.params)
    for k, (shape, init, _, part) in specs.items():
        assert tuple(shape) == f.params[k].shape, k
        assert part == tuple(f.specs[k]), k
        if init in ("ones", "zeros"):
            assert np.all(np.asarray(f.params[k]) == (1.0 if init == "ones" else 0.0)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(6)
    (jx, jw, jb), (tx, tw, tb) = (
        list(t.values()) for t in both(
            {"x": normal(rng, (2, 11, 40)), "w": normal(rng, (4, 40), 0.5),
             "b": normal(rng, (40,), 0.1)}, dtype)
    )
    got = tssm._causal_conv(tx, tw, tb)
    assert got.dtype == TORCH[dtype]
    close(got, jssm._causal_conv(jx, jw, jb), TOL[dtype])


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(7)
    B, H, P, N = 3, 4, 16, 8
    state, x, dt = normal(rng, (B, H, P, N)), normal(rng, (B, H, P)), normal(rng, (B, H))
    dt = np.log1p(np.exp(dt))
    A = -np.exp(normal(rng, (H,), 0.5))
    Bt, Ct = normal(rng, (B, N)), normal(rng, (B, N))
    args = (state, x, dt, A, Bt, Ct)
    got = tssm.ssd_step(*(torch.from_numpy(a) for a in args))
    want = jssm.ssd_step(*(jnp.asarray(a) for a in args))
    close(got[0], want[0], TOL["float32"])
    close(got[1], want[1], TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_matches_jax(dtype):
    """Right-padded rows: y, the per-row conv tail and the final state."""
    cfg, jcfg = get_smoke_config(ARCH, dtype=dtype), jax_smoke(ARCH, dtype=dtype)
    rng = np.random.default_rng(8)
    jp, tp = both(block_params(rng, cfg), dtype)
    x = normal(rng, (3, 32, cfg.d_model))
    lengths = np.array([32, 19, 2], np.int32)  # one shorter than the conv tail
    jy, jc = jssm.ssm_prefill(jp, jcfg, jnp.asarray(x, JNP[dtype]), jnp.asarray(lengths))
    ty, tc = tssm.ssm_prefill(tp, cfg, torch.from_numpy(x).to(TORCH[dtype]),
                              torch.from_numpy(lengths))
    close(ty, jy, TOL[dtype])
    close(tc["conv"], jc["conv"], TOL[dtype])
    close(tc["state"], jc["state"], TOL[dtype])
    assert tc["state"].dtype == torch.float32 and tc["conv"].dtype == TORCH[dtype]
    close(tssm.ssm_forward(tp, cfg, torch.from_numpy(x).to(TORCH[dtype])),
          jssm.ssm_forward(jp, jcfg, jnp.asarray(x, JNP[dtype])), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_jax_and_leaves_dead_slots_untouched(dtype):
    cfg, jcfg = get_smoke_config(ARCH, dtype=dtype), jax_smoke(ARCH, dtype=dtype)
    rng = np.random.default_rng(9)
    jp, tp = both(block_params(rng, cfg), dtype)
    B, C = 4, cfg.d_inner + 2 * cfg.ssm_state
    conv0 = normal(rng, (B, cfg.conv_width - 1, C))
    state0 = normal(rng, (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), 0.1)
    x = normal(rng, (B, 1, cfg.d_model))
    live = np.array([True, False, True, False])
    jy, jc = jssm.ssm_decode(
        jp, jcfg, jnp.asarray(x, JNP[dtype]),
        {"conv": jnp.asarray(conv0, JNP[dtype]), "state": jnp.asarray(state0)},
        jnp.asarray(live))
    tcache = {"conv": torch.from_numpy(conv0).to(TORCH[dtype]),
              "state": torch.from_numpy(state0.copy())}
    conv_before = tcache["conv"].clone()
    ty, tc = tssm.ssm_decode(tp, cfg, torch.from_numpy(x).to(TORCH[dtype]), tcache,
                             torch.from_numpy(live))
    close(ty, jy, TOL[dtype])
    close(tc["conv"], jc["conv"], TOL[dtype])
    close(tc["state"], jc["state"], TOL[dtype])
    assert tc["state"] is tcache["state"]  # updated in place
    assert torch.equal(tc["conv"][~torch.from_numpy(live)], conv_before[~torch.from_numpy(live)])
    assert np.array_equal(tc["state"][[1, 3]].numpy(), state0[[1, 3]])
    assert not np.array_equal(tc["state"][[0, 2]].numpy(), state0[[0, 2]])


# -- the model and the engine ------------------------------------------------------


def test_scatter_prefill_into_flat_ssm_cache_matches_jax():
    jm = JaxModel(jax_smoke(ARCH, dtype="float32"), remat=False)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = Model(get_smoke_config(ARCH, dtype="float32"))
    tp = params_from_jax(_flatten(jp), m.cfg, device="cpu")
    toks = np.arange(1, 17, dtype=np.int32)[None]
    _, jpre = jm.prefill(jp, tokens=jnp.asarray(toks), lengths=jnp.asarray([11]))
    _, tpre = m.prefill(tp, torch.from_numpy(toks).long(), torch.tensor([11]))
    jout = jm.scatter_prefill(jm.init_cache(3, 32), jpre, 1, 11)
    tcache = m.init_cache(3, 32, device="cpu")
    tout = m.scatter_prefill(tcache, tpre, 1, 11)
    for key in ("conv", "state"):
        close(tout["layers"][key], jout["layers"][key], 1e-5)
        assert tout["layers"][key] is tcache["layers"][key]  # in place
        assert not tout["layers"][key][:, 0].any() and not tout["layers"][key][:, 2].any()


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_prefill_pad_equals_ssm_chunk(arch):
    m = Model(get_smoke_config(arch, dtype="float32"))
    eng = Engine(m, m.init(0, device="cpu"), batch=2, max_len=64)
    assert eng.pad_to == m.cfg.ssm_chunk == 16
    seen = []
    prefill = eng._prefill

    def spy(p, toks, lens):
        seen.append((toks.shape[1], int(lens[0])))
        return prefill(p, toks, lens)

    eng._prefill = spy
    for rid, L in enumerate((5, 16, 17)):
        eng.admit(Request(rid=rid, prompt=np.arange(1, L + 1, dtype=np.int32),
                          max_new_tokens=2))
        eng.step()
    assert seen == [(16, 5), (16, 16), (32, 17)]


def test_ssm_kv_backends_follow_the_reference():
    """A pure SSM model has no KV to page: "auto" and "paged" both give the
    flat state cache, as the reference's engine does; the hybrid pages."""
    m = Model(get_smoke_config("mamba2-370m", dtype="float32"))
    p = m.init(0, device="cpu")
    for backend in ("auto", "paged", "flat"):
        eng = Engine(m, p, batch=1, max_len=32, kv_backend=backend)
        assert eng.kv_backend == "flat" and eng.pool is None
    with pytest.raises(ValueError, match="paged KV unsupported"):
        m.init_paged_cache(1, 4, 16, 2, device="cpu")
    h = Model(get_smoke_config("zamba2-1.2b", dtype="float32"))
    assert Engine(h, h.init(0, device="cpu"), batch=1, max_len=32).kv_backend == "paged"


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m", "zamba2-1.2b"])
def test_attention_layers_and_page_bytes_match_reference(arch):
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert attn_layer_count(mine) == jax_attn_layers(theirs)
        assert page_hbm_bytes(mine, 16) == jax_page_bytes(theirs, 16)
    assert attn_layer_count(get_config(arch)) == {"qwen3-8b": 36, "mamba2-370m": 0,
                                                  "zamba2-1.2b": 19}[arch]


@pytest.mark.parametrize("field,value,block_key", [
    ("arch_type", "moe", "layers/moe/we_gate"),
    ("attention_kind", "mla", "shared_attn/w_dkv"),
])
def test_model_serves_moe_and_mla_as_the_reference_does(field, value, block_key):
    """The MoE family (on the zamba2 smoke widths, with four experts and
    one unrolled dense block) and MLA in the hybrid's shared block: the
    port builds them with the reference's key tree and prefills them to
    its logits on bridged float32 weights."""
    extra = dict(num_experts=4, experts_per_token=2, moe_d_ff=64,
                 first_dense_layers=1) if value == "moe" else {}
    over = dict(kv_lora_rank=8, dtype="float32", **extra, **{field: value})
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), **over)
    jm = JaxModel(dataclasses.replace(jax_smoke("zamba2-1.2b"), **over), remat=False)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    assert block_key in m.param_specs()
    assert sorted(m.param_specs()) == sorted(_flatten(jp))
    tp = params_from_jax(_flatten(jp), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(1, 16))
    want, _ = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32))
    got, _ = m.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("field,value,block_key", [
    ("arch_type", "vlm", "layers/attn/wq"), ("arch_type", "audio", "layers/mlp/w_up"),
    ("modality", "vision_stub", "layers/mamba_0/w_z"),
])
def test_model_serves_vlm_and_audio_as_the_dense_stack(field, value, block_key):
    """vlm and audio are the dense block stack, as in the reference; the
    modality names the frontend only and changes nothing in the model."""
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), kv_lora_rank=8,
                              **{field: value})
    m = Model(cfg)
    assert block_key in m.param_specs()
    logits, _ = m.prefill(m.init(0, device="cpu"), torch.ones((1, 16), dtype=torch.long))
    assert torch.isfinite(logits).all()


def test_hybrid_depth_must_divide_into_superblocks():
    with pytest.raises(ValueError, match="multiple of"):
        Model(dataclasses.replace(get_smoke_config("zamba2-1.2b"), num_layers=3))
