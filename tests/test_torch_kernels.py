"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and its jnp
oracle, on the same numpy inputs; and the wrappers' device routing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MMA_TILE, decode_attention_plain, splits_for,
)
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention_plain  # noqa: E402

# the reference kernel tests' own bounds (tests/test_kernels.py, tests/test_paged.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PAGED_TOL = 3e-5
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    same float32 input to nearest-even on both sides)."""
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,S,D,bq,bk",
    [
        (1, 2, 2, 128, 64, 64, 64),   # MHA
        (2, 4, 2, 256, 64, 128, 64),  # GQA
        (1, 8, 1, 256, 128, 64, 128), # MQA, head_dim 128
        (2, 2, 2, 192, 32, 64, 96),   # uneven-ish blocks
        (1, 6, 2, 128, 16, 64, 64),   # phi4-mini's smoke heads: head_dim 16, G = 3
        (2, 14, 2, 128, 16, 64, 128), # head_dim 16 at internvl2-1b's G = 7
    ],
)
def test_flash_plain_matches_pallas_and_ref(B, H, KV, S, D, bq, bk, dtype):
    rng = np.random.default_rng(S + H)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(normal(rng, s), dtype) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    )
    got = f32(flash_attention_plain(qt, kt, vt))
    tol = FLASH_TOL[dtype]
    pallas = flash_attention_bhsd(qj, kj, vj, block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(got, f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, f32(ref.flash_attention_ref(qj, kj, vj)), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [64, 128])
def test_flash_plain_sliding_window(window):
    B, H, KV, S, D = 1, 2, 2, 256, 64
    rng = np.random.default_rng(window)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(normal(rng, s), "float32") for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    )
    got = f32(flash_attention_plain(qt, kt, vt, window=window))
    pallas = flash_attention_bhsd(qj, kj, vj, window=window, block_q=64, block_k=64,
                                  interpret=True)
    np.testing.assert_allclose(got, f32(pallas), atol=2e-5, rtol=2e-5)
    want = ref.flash_attention_ref(qj, kj, vj, window=window)
    np.testing.assert_allclose(got, f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(16, None), (48, None), (48, 20)])
def test_flash_plain_ragged_lengths_match_ref(S, window, dtype):
    """The engine's 16-token prefill buckets: lengths the Pallas kernel's
    tiling refuses, so only the oracle speaks for them."""
    B, H, KV, D = 2, 4, 2, 32
    rng = np.random.default_rng(S)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(normal(rng, s), dtype) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    )
    got = f32(flash_attention_plain(qt, kt, vt, window=window))
    want = f32(ref.flash_attention_ref(qj, kj, vj, window=window))
    np.testing.assert_allclose(got, want, atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


# -- the bf16 tensor-core kernels' order of work, in plain torch ----------------
#
# The CUDA kernels cannot run here.  These emulations follow their tile
# order and their one extra rounding (P to bf16 before P·V, as the mma.sync
# A operand): 64-key tiles, an online softmax in the log2 domain with
# scale * log2(e) folded in, float32 accumulation of bf16 x bf16 products.
# Held against the float32 plain versions and the JAX oracles at the bf16
# tolerance, they show the design fits it where there is no card.

LOG2E = 1.4426950408889634
MMA_KEYS = 64  # keys per tile of the bf16 flash kernel


def _online_tile(m, l, acc, s, v, ok):
    """One tile: scores ``s`` (.., n) in log2 units, V (.., n, D), mask
    ``ok``; returns the updated (m, l, acc)."""
    s = s.masked_fill(~ok, -1e30)
    mx = torch.maximum(m, s.amax(-1))
    alpha, p = torch.exp2(m - mx), torch.exp2(s - mx[..., None])
    pv = p.bfloat16().float() @ v  # P rounded to bf16, products summed in f32
    return mx, l * alpha + p.sum(-1), acc * alpha[..., None] + pv


def _flash_tiles_emulated(q, k, v, scale, window=None):
    """q (B, H, S, D), k/v (B, KV, S, D), bf16; the flash kernel's order."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    m = torch.full((B, H, S), -1e30)
    l, acc = torch.zeros((B, H, S)), torch.zeros((B, H, S, D))
    qi = torch.arange(S)[:, None]
    for k0 in range(0, S, MMA_KEYS):
        kj = torch.arange(k0, min(k0 + MMA_KEYS, S))[None, :]
        ok = kj <= qi
        if window is not None:
            ok &= kj > qi - window
        s = qf @ kf[:, :, k0:k0 + MMA_KEYS].transpose(-1, -2) * (scale * LOG2E)
        m, l, acc = _online_tile(m, l, acc, s, vf[:, :, k0:k0 + MMA_KEYS], ok)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("S,window", [(1024, None), (1024, 512), (1000, None)])
def test_flash_mma_rounding_fits_the_bf16_tolerance(S, window):
    """qwen3-8b's head_dim and group (D 128, G 4), at S = 1024 and a ragged S."""
    B, H, KV, D = 1, 8, 2, 128
    rng = np.random.default_rng(S + (window or 0))
    (qj, qt), (kj, kt), (vj, vt) = (
        both(normal(rng, s), "bfloat16") for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    )
    got = f32(_flash_tiles_emulated(qt, kt, vt, D ** -0.5, window))
    tol = FLASH_TOL["bfloat16"]
    plain = f32(flash_attention_plain(qt, kt, vt, window=window))
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)
    want = f32(ref.flash_attention_ref(qj, kj, vj, window=window))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _decode_tiles_emulated(q, k, v, valid, scale, sm_count=132):
    """q (B, H, D), k/v (B, S, KV, D), bf16, valid (B, S) bool; the flat
    decode kernel's order: splits of whole 64-token tiles, each tile's
    tokens cut among KS warps (KS = 4, 2, 1 for 1, 2, >= 3 row tiles of
    16), a warp skipping a slice with nothing valid, the warps merged in
    the block, then the splits merged."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    KS = {1: 4, 2: 2}.get(-(-G // 16), 1)
    NT = MMA_TILE // KS
    splits, split_len = splits_for(B, KV, S, sm_count, MMA_TILE)
    q4 = q.float().reshape(B, KV, G, D)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, KV, S, D)
    parts = []
    for sp in range(splits):
        s0, s1 = sp * split_len, min(S, (sp + 1) * split_len)
        warps = []
        for kq in range(KS):
            m = torch.full((B, KV, G), -1e30)
            l, acc = torch.zeros((B, KV, G)), torch.zeros((B, KV, G, D))
            for t in range(s0, s1, MMA_TILE):
                lo, hi = t + kq * NT, min(t + (kq + 1) * NT, s1)
                if lo >= hi:
                    continue
                ok = valid[:, None, None, lo:hi]
                s = q4 @ kf[:, :, lo:hi].transpose(-1, -2) * (scale * LOG2E)
                new = _online_tile(m, l, acc, s, vf[:, :, lo:hi], ok)
                live = ok.any(-1)  # (B, 1, 1): the slice is skipped where nothing is valid
                m, l = torch.where(live, new[0], m), torch.where(live, new[1], l)
                acc = torch.where(live[..., None], new[2], acc)
            warps.append((m, l, acc))
        mx = torch.stack([w[0] for w in warps]).amax(0)
        w = [torch.exp2(x[0] - mx) for x in warps]
        parts.append((mx / LOG2E, sum(x[1] * wi for x, wi in zip(warps, w)),
                      sum(x[2] * wi[..., None] for x, wi in zip(warps, w))))
    mx = torch.stack([p[0] for p in parts]).amax(0)  # the merge kernel, natural log
    w = [torch.exp(p[0] - mx) for p in parts]
    lsum = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[..., None] for p, wi in zip(parts, w))
    return (acc / lsum.clamp_min(1e-30)[..., None]).reshape(B, H, D).to(q.dtype)


@pytest.mark.parametrize("kind", ["prefix", "ring"])
@pytest.mark.parametrize("B,KV,G", [(3, 2, 1), (3, 2, 4), (2, 1, 48)])
def test_decode_mma_rounding_fits_the_bf16_tolerance(B, KV, G, kind):
    """The flat decode at zamba2-1.2b's G = 1, qwen3-8b's G = 4 and
    granite-20b's G = 48, head_dim 128, a 2048-row cache; masks per row
    (ragged prefixes or a wrapped ring run, one row empty)."""
    S, D, H = 2048, 128, KV * G
    rng = np.random.default_rng(G + len(kind))
    (qj, qt), (kj, kt), (vj, vt) = (
        both(normal(rng, s), "bfloat16") for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D))
    )
    valid = np.zeros((B, S), bool)
    for b in range(1, B):
        n = int(rng.integers(1, S + 1))
        start = 0 if kind == "prefix" else int(rng.integers(0, S))
        valid[b, (start + np.arange(n)) % S] = True
    got = f32(_decode_tiles_emulated(qt, kt, vt, torch.from_numpy(valid), D ** -0.5))
    tol = FLASH_TOL["bfloat16"]
    plain = f32(decode_attention_plain(qt, kt, vt, torch.from_numpy(valid)))
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)
    assert np.all(got[0] == 0.0)  # nothing valid: zeros
    for b in range(1, B):
        want = ref.decode_attention_ref(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1],
                                        jnp.asarray(valid[b]))
        np.testing.assert_allclose(got[b:b + 1], f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("G", [3, 7])
def test_mma_rounding_at_head_dim_16_fits_the_bf16_tolerance(G):
    """The bf16 kernels at D = 16, one m16n8k16 step for QK^T: flash at
    S = 300 and the flat decode over a 2048-row cache, groups of 3
    (phi4-mini) and 7 (internvl2-1b)."""
    B, KV, D, tol = 2, 2, 16, FLASH_TOL["bfloat16"]
    H = KV * G
    rng = np.random.default_rng(G)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(normal(rng, s), "bfloat16") for s in ((B, H, 300, D), (B, KV, 300, D),
                                                   (B, KV, 300, D))
    )
    got = f32(_flash_tiles_emulated(qt, kt, vt, D ** -0.5))
    np.testing.assert_allclose(got, f32(flash_attention_plain(qt, kt, vt)), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, f32(ref.flash_attention_ref(qj, kj, vj)), atol=tol, rtol=tol)

    S = 2048
    q, k, v = (torch.from_numpy(normal(rng, s)).bfloat16()
               for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    valid = torch.arange(S)[None, :] < torch.tensor([[700], [S]])
    got = f32(_decode_tiles_emulated(q, k, v, valid, D ** -0.5))
    np.testing.assert_allclose(got, f32(decode_attention_plain(q, k, v, valid)), atol=tol,
                               rtol=tol)


def _paged_inputs(rng, B, H, KV, D, num_pages, page_size, max_pages, zero_row):
    q = normal(rng, (B, H, D))
    pk = normal(rng, (num_pages, page_size, KV, D))
    pv = normal(rng, (num_pages, page_size, KV, D))
    pt = rng.integers(0, num_pages, size=(B, max_pages)).astype(np.int32)
    lengths = rng.integers(1, max_pages * page_size + 1, size=(B,)).astype(np.int32)
    if zero_row:
        lengths[-1] = 0
    return q, pk, pv, pt, lengths


@pytest.mark.parametrize(
    "B,H,KV,D,num_pages,page_size,max_pages,zero_row",
    [
        (2, 4, 2, 64, 8, 16, 3, False),
        (3, 8, 2, 64, 16, 32, 4, False),
        (1, 8, 1, 128, 8, 64, 2, False),  # MQA
        (2, 4, 4, 32, 12, 8, 6, False),   # MHA small pages
        (3, 4, 2, 32, 10, 8, 4, True),    # an idle slot: length 0
        (2, 48, 1, 128, 8, 16, 3, True),  # granite-20b: G = 48 over one KV head
        (2, 6, 2, 16, 8, 16, 3, True),    # phi4-mini's smoke heads: head_dim 16, G = 3
        (3, 8, 2, 16, 10, 8, 4, False),   # llama3-405b's smoke heads: head_dim 16, G = 4
        (2, 14, 2, 64, 8, 16, 3, True),   # internvl2-1b's heads: G = 7
    ],
)
def test_paged_plain_matches_pallas_and_ref(B, H, KV, D, num_pages, page_size, max_pages,
                                            zero_row):
    rng = np.random.default_rng(num_pages)
    q, pk, pv, pt, lengths = _paged_inputs(rng, B, H, KV, D, num_pages, page_size,
                                           max_pages, zero_row)
    got = paged_decode_attention_plain(
        *(torch.from_numpy(x) for x in (q, pk, pv, pt, lengths))
    ).numpy()
    jargs = [jnp.asarray(x) for x in (q, pk, pv, pt, lengths)]
    pallas = np.asarray(paged_decode_attention(*jargs, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=PAGED_TOL, rtol=PAGED_TOL)
    # the jnp oracle averages every gathered row for a length-0 request
    # (softmax over nothing but masked scores); the kernels give zeros
    live = lengths > 0
    oracle = np.asarray(ref.paged_decode_attention_ref(*jargs))
    np.testing.assert_allclose(got[live], oracle[live], atol=PAGED_TOL, rtol=PAGED_TOL)
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize(
    "B,KV,dtype,want",
    [
        (8, 8, torch.bfloat16, (8, 256)),   # qwen3-8b at batch 8: 512 blocks
        (8, 1, torch.bfloat16, (16, 128)),  # granite-20b: two tiles a split
        (8, 32, torch.bfloat16, (3, 704)),  # zamba2-1.2b: 768 blocks
        (8, 8, torch.float32, (8, 256)),
        (8, 1, torch.float32, (32, 64)),    # float32 tiles are 32 tokens
        (1, 1, torch.float32, (32, 64)),
    ],
)
def test_paged_splits_come_from_the_table_width_alone(B, KV, dtype, want):
    """The paged wrapper cuts the page table's width (128 pages of 16 on the
    main path) into splits from shapes alone: it never reads the lengths,
    which live on the card.  The splits cover the width in whole tiles,
    fill the card's 132 SMs about PAGED_WAVES times, and are at least two
    tiles long."""
    from repro_torch.kernels.decode_attention import TILE
    from repro_torch.kernels.paged_attention import (
        MIN_SPLIT_TILES, PAGED_WAVES, paged_splits,
    )

    got = paged_splits(B, KV, 128, 16, 132, dtype)
    assert got == want
    splits, split_len = got
    tile = MMA_TILE if dtype == torch.bfloat16 else TILE
    assert split_len % tile == 0 and split_len >= MIN_SPLIT_TILES * tile
    assert splits * split_len >= 128 * 16 > (splits - 1) * split_len
    assert B * KV * splits <= 2 * PAGED_WAVES * 132
    assert "lengths" not in paged_splits.__code__.co_varnames


def test_ops_wrappers_route_cpu_to_plain_versions_without_counting():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(normal(rng, (2, 16, 4, 32)))
    k = torch.from_numpy(normal(rng, (2, 16, 2, 32)))
    v = torch.from_numpy(normal(rng, (2, 16, 2, 32)))
    before = ops.launches()
    out = ops.flash_attention(q, k, v)
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    torch.testing.assert_close(out, want.transpose(1, 2), atol=0, rtol=0)

    qd, pk, pv, pt, lengths = _paged_inputs(rng, 2, 4, 2, 32, 6, 8, 3, True)
    outd = ops.paged_decode_attention(
        torch.from_numpy(qd)[:, None], torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(pt), torch.from_numpy(lengths),
    )
    wantd = paged_decode_attention_plain(
        *(torch.from_numpy(x) for x in (qd, pk, pv, pt, lengths))
    )
    torch.testing.assert_close(outd[:, 0], wantd, atol=0, rtol=0)
    assert ops.launches() == before  # the CPU path launches no kernel


def test_ops_wrappers_refuse_other_devices():
    """Neither a kernel nor its plain version runs on a device the wrapper
    does not know: it raises rather than copying to the CPU."""
    q = torch.empty((1, 16, 4, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="meta"):
        ops.paged_decode_attention(
            q[:, :1], torch.empty((4, 8, 2, 32), device="meta"),
            torch.empty((4, 8, 2, 32), device="meta"),
            torch.empty((1, 2), dtype=torch.int32, device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"),
        )


def test_reset_launches_zeroes_every_counter():
    ops.LAUNCHES["decode_attention"] = 2
    ops.LAUNCHES["flash_attention"] = 3
    ops.LAUNCHES["paged_decode_attention"] = 5
    ops.LAUNCHES["ssm_scan"] = 7
    ops.LAUNCHES["flash_attention_bwd"] = 11
    ops.LAUNCHES["ssm_scan_bwd"] = 13
    ops.LAUNCHES["rmsnorm"] = 17
    ops.LAUNCHES["rope"] = 19
    ops.reset_launches()
    assert ops.launches() == {"decode_attention": 0, "flash_attention": 0,
                              "paged_decode_attention": 0, "ssm_scan": 0,
                              "flash_attention_bwd": 0, "ssm_scan_bwd": 0,
                              "rmsnorm": 0, "rope": 0}


def test_rows_aligned_guards_the_kernels_16_byte_loads():
    """The kernels read K/V rows as 16-byte chunks; the launchers refuse a
    tensor whose rows do not start on 16-byte boundaries."""
    from repro_torch.kernels import _build

    t = torch.zeros((4, 8, 2, 32), dtype=torch.bfloat16)
    assert _build.rows_aligned(t, 16)
    assert _build.rows_aligned(t.transpose(1, 2), 16)  # strides stay multiples
    assert not _build.rows_aligned(t[..., 1:], 16)  # rows start 2 bytes in
    assert not _build.rows_aligned(torch.zeros((4, 8, 2, 36), dtype=torch.bfloat16)[..., :32], 16)
