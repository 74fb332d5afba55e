"""The port's model modules against the JAX package's, one function at a
time, on the same numpy inputs (float32, 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

TOL = 1e-5
CFG = get_smoke_config("qwen3-8b", dtype="float32")
JCFG = jax_smoke("qwen3-8b", dtype="float32")


def normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def attn_params(rng):
    """GQA weights for the smoke config, as numpy, keyed like both packages."""
    d, H, KV, hd = CFG.d_model, CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, w = normal(rng, (2, 5, 64)), 1.0 + normal(rng, (64,), 0.1)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jcommon.rmsnorm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-6)
    got = tcommon.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), 1e-6)
    assert got.dtype == td
    close(got, want, TOL if dtype == "float32" else 1e-2)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = normal(rng, (2, 7, 4, 32))
    pos = rng.integers(0, 1000, size=(2, 7)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    close(got, want, 1e-4)  # angles up to 1e3 rad: float32 sin/cos ulps


def test_mlp_matches_jax():
    rng = np.random.default_rng(2)
    d, ff = CFG.d_model, CFG.d_ff
    p = {"w_gate": normal(rng, (d, ff), d ** -0.5), "w_up": normal(rng, (d, ff), d ** -0.5),
         "w_down": normal(rng, (ff, d), ff ** -0.5)}
    x = normal(rng, (2, 3, d))
    want = jmlp.mlp_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tmlp.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    close(got, want)
    assert set(tmlp.mlp_specs(CFG)) == set(p)


def test_gqa_prefill_matches_jax():
    rng = np.random.default_rng(3)
    jp, tp = attn_params(rng)
    B, S = 2, 24
    x = normal(rng, (B, S, CFG.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jcache = jattn.gqa_prefill(jp, JCFG, jnp.asarray(x), jnp.asarray(pos))
    tout, tcache = tattn.gqa_prefill(tp, CFG, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    close(tout, jout)
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])


def test_gqa_decode_matches_jax_and_skips_idle_slots():
    rng = np.random.default_rng(4)
    jp, tp = attn_params(rng)
    B, S, KV, hd = 3, 16, CFG.num_kv_heads, CFG.head_dim
    k0, v0 = normal(rng, (B, S, KV, hd)), normal(rng, (B, S, KV, hd))
    x = normal(rng, (B, 1, CFG.d_model))
    pos = np.array([5, -1, 11], np.int32)  # slot 1 idle
    jout, jc = jattn.gqa_decode(jp, JCFG, jnp.asarray(x),
                                {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, jnp.asarray(pos))
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    tout, tc = tattn.gqa_decode(tp, CFG, torch.from_numpy(x), tcache, torch.from_numpy(pos))
    close(tout, jout)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    assert np.array_equal(tc["k"][1].numpy(), k0[1])  # the idle slot's rows untouched


def test_gqa_decode_paged_matches_jax_and_leaves_pools_untouched_for_idle_slots():
    """The port's pools hold one page more than the JAX package's, the sink
    (the last), which takes the idle slots' writes; every real page matches
    and the idle slots' dummy page 0 is untouched."""
    rng = np.random.default_rng(5)
    jp, tp = attn_params(rng)
    B, KV, hd, P, ps, max_pages = 4, CFG.num_kv_heads, CFG.head_dim, 12, 4, 3
    pk, pv = normal(rng, (P + 1, ps, KV, hd)), normal(rng, (P + 1, ps, KV, hd))
    pt = np.array([[3, 7, 1], [0, 0, 0], [5, 2, 9], [0, 0, 0]], np.int32)
    pos = np.array([6, -1, 9, -1], np.int32)  # slots 1 and 3 idle
    live = pos >= 0
    x = normal(rng, (B, 1, CFG.d_model))
    jout, jc = jattn.gqa_decode_paged(
        jp, JCFG, jnp.asarray(x), {"pool_k": jnp.asarray(pk[:P]), "pool_v": jnp.asarray(pv[:P])},
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(live))
    tcache = {"pool_k": torch.from_numpy(pk.copy()), "pool_v": torch.from_numpy(pv.copy())}
    tout, tc = tattn.gqa_decode_paged(
        tp, CFG, torch.from_numpy(x), tcache, torch.from_numpy(pt), torch.from_numpy(pos))
    # idle rows: JAX's reference path averages the dummy page, the kernels
    # give zeros; their logits are discarded either way
    close(tout[live], np.asarray(jout)[live])
    close(tc["pool_k"][:P], jc["pool_k"])
    close(tc["pool_v"][:P], jc["pool_v"])
    changed = np.any(tc["pool_k"].numpy() != pk, axis=(1, 2, 3))
    # only pt[0][6 // 4], pt[2][9 // 4] and the sink; the idle slots' dummy
    # page 0 is untouched
    assert sorted(np.flatnonzero(changed)) == [7, 9, P]
    assert tc["pool_k"] is tcache["pool_k"]  # updated in place


def test_normalize_pos_and_live_rows():
    cpos, live = tattn.normalize_pos(torch.tensor([3, -1, 0]), 3)
    assert cpos.tolist() == [3, 0, 0] and live.tolist() == [True, False, True]
    cpos, live = tattn.normalize_pos(7, 2)
    assert cpos.tolist() == [7, 7] and live.tolist() == [True, True]
