"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with nvcc; without one each test skips (decided
inside the ``cuda`` fixture, never at import).  On a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import norm_rope as nr_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_plain  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SCAN_TOL = 2e-3  # tests/test_kernels.py's bound for the Pallas scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,S,D,window",
    [
        (1, 4, 2, 16, 32, None),
        (2, 4, 2, 48, 64, None),
        (1, 8, 2, 100, 128, 33),
        (2, 32, 8, 257, 128, None),
        (1, 2, 2, 130, 64, 1),
        (1, 48, 1, 1000, 128, None),  # granite-20b: 48 query heads over one KV head
        (1, 32, 32, 1024, 64, None),  # zamba2-1.2b's shared attention
        (8, 8, 1, 1024, 128, 512),    # the ring prefill: batch 8 under a 512 window
        (1, 4, 2, 1, 64, None),       # ragged against the 64-row query tile
        (2, 4, 2, 15, 128, None),
        (1, 4, 1, 65, 32, 40),
        (1, 6, 2, 100, 16, None),     # head_dim 16 (phi4-mini's smoke heads, G = 3)
        (2, 8, 2, 130, 16, 40),       # head_dim 16 under a window
        (1, 24, 8, 513, 128, None),   # phi4-mini: G = 3
        (1, 14, 2, 300, 64, None),    # internvl2-1b: G = 7
    ],
)
def test_flash_kernel_matches_plain(cuda, dtype, B, H, KV, S, D, window):
    rng = np.random.default_rng(S)
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, S, KV, D), dtype, cuda)
    v = _randn(rng, (B, S, KV, D), dtype, cuda)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = fa_mod.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 1 / math.sqrt(D), window
    ).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_kernel_reads_q_rows_that_are_not_16_byte_aligned(cuda):
    """q as a view one element into a wider tensor: TMA cannot read such
    rows, so the wrapper hands the bf16 kernel an aligned copy."""
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 100, 4, 2, 64
    q = _randn(rng, (B, S, H, D + 1), torch.bfloat16, cuda)[..., 1:]
    k = _randn(rng, (B, S, KV, D), torch.bfloat16, cuda)
    v = _randn(rng, (B, S, KV, D), torch.bfloat16, cuda)
    assert q.data_ptr() % 16 != 0
    got = ops.flash_attention(q, k, v)
    want = fa_mod.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 1 / math.sqrt(D)
    ).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


# The wgmma kernels' tile edges (128-row query and key tiles in the forward,
# 128-key or 128-row blocks over 64-row streamed tiles in the backward):
# S one short of, at and one past a tile, two tiles less one; windows of
# one key, one short of a tile, a whole tile and between tiles; D 64 and
# 128; G 1, 4 and 48.
WGMMA_EDGES = [
    (1, 8, 2, 127, 128, None),
    (1, 8, 2, 128, 128, None),
    (1, 8, 2, 129, 128, None),
    (1, 8, 2, 255, 128, None),
    (1, 4, 4, 127, 64, None),
    (1, 4, 4, 129, 64, None),
    (1, 48, 1, 255, 128, None),
    (1, 48, 1, 129, 64, None),
    (1, 8, 2, 300, 128, 1),
    (1, 8, 2, 300, 128, 127),
    (1, 4, 4, 300, 64, 128),
    (1, 48, 1, 300, 128, 200),
    (1, 4, 1, 255, 64, 200),
]


def _edge_inputs(rng, fused, B, H, KV, S, D, dtype, device):
    """q, k, v (B, S, heads, D), dout (B, S, H, D): on their own, or
    (``fused``, at B 2) q, k and v as strided views of one (B, S, (H +
    2 KV) D) tensor, as a fused QKV projection gives them."""
    if fused:
        x = _randn(rng, (B, S, (H + 2 * KV) * D), dtype, device)
        q = x[..., :H * D].unflatten(-1, (H, D))
        k = x[..., H * D:(H + KV) * D].unflatten(-1, (KV, D))
        v = x[..., (H + KV) * D:].unflatten(-1, (KV, D))
    else:
        q, k, v = (_randn(rng, (B, S, n, D), dtype, device) for n in (H, KV, KV))
    return q, k, v, _randn(rng, (B, S, H, D), dtype, device)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H,KV,S,D,window", WGMMA_EDGES)
def test_flash_wgmma_forward_at_the_tile_edges(cuda, fused, B, H, KV, S, D, window):
    """The bf16 forward (the wgmma kernel) and its row log-sum-exp against
    the plain version's at the tiles' edges."""
    B = 2 if fused else B
    assert fa_mod.variant(torch.bfloat16, D) == "wgmma"
    rng = np.random.default_rng(S + D + H)
    q, k, v, _ = _edge_inputs(rng, fused, B, H, KV, S, D, torch.bfloat16, cuda)
    scale = 1 / math.sqrt(D)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = torch.empty_like(qt)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    fa_mod.launch(qt, kt, vt, out, scale, window, lse)
    want, want_lse = fa_mod.flash_attention_plain_lse(qt, kt, vt, scale, window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert _rel_err(lse, want_lse) <= 1e-4


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,H,KV,S,D,window", WGMMA_EDGES)
def test_flash_wgmma_backward_at_the_tile_edges(cuda, fused, B, H, KV, S, D, window):
    """The bf16 backward kernels (wgmma) against the explicit plain backward
    on the forward kernel's out and lse, and the gradients through the
    wrapper's Function against the plain version's autograd, at the tiles'
    edges."""
    B = 2 if fused else B
    rng = np.random.default_rng(S + D + H + 1)
    q, k, v, dout = _edge_inputs(rng, fused, B, H, KV, S, D, torch.bfloat16, cuda)
    scale = 1 / math.sqrt(D)
    qt, kt, vt, dt = (x.transpose(1, 2) for x in (q, k, v, dout))
    out = torch.empty_like(qt)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    fa_mod.launch(qt, kt, vt, out, scale, window, lse)
    got = [torch.empty_like(t) for t in (qt, kt, vt)]
    fa_mod.launch_bwd(qt, kt, vt, out, lse, dt, *got, scale, window)
    want = fa_mod.flash_attention_bwd_plain(qt, kt, vt, out, lse, dt, scale, window)
    torch.cuda.synchronize()
    for name, g, ref in zip("qkv", got, want):
        assert torch.isfinite(g.float()).all()
        assert _rel_err(g, ref) <= 2e-2, f"d{name}"

    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(ops.flash_attention(*leaves, window=window), leaves, dout)
    plain_grads = torch.autograd.grad(_flash_plain(window, scale)(*leaves), leaves, dout)
    for name, g, ref in zip("qkv", grads, plain_grads):
        assert _rel_err(g, ref) <= 2e-2, f"d{name} through the Function"


@pytest.mark.parametrize("B,H,KV,S,D,window", [
    (2, 32, 8, 300, 128, None),   # qwen3-8b's heads
    (1, 48, 1, 257, 64, 100),
])
def test_flash_backward_kernels_are_deterministic(cuda, B, H, KV, S, D, window):
    """Two backward calls on the same inputs give bit-equal dq, dk and dv:
    every output element has one owner and no atomics."""
    rng = np.random.default_rng(S)
    q, k, v, dout = (_randn(rng, (B, n, S, D), torch.bfloat16, cuda) for n in (H, KV, KV, H))
    scale = 1 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    fa_mod.launch(q, k, v, out, scale, window, lse)
    runs = []
    for _ in range(2):
        grads = [torch.empty_like(t) for t in (q, k, v)]
        fa_mod.launch_bwd(q, k, v, out, lse, dout, *grads, scale, window)
        runs.append(grads)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", *runs):
        assert torch.equal(a, b), f"d{name}"


def _split_edge_lengths(B, max_pages, page_size, split_len):
    """Lengths at the edges of the kernel's splits: an idle slot, one that
    ends on a split edge and one just past it, one token (every later split
    past the length), a full table, and ones just short of an edge."""
    S = max_pages * page_size
    want = [0, split_len, split_len + 1, 1, S, 2 * split_len - 1, 3 * split_len, S - 1]
    return np.minimum(np.array((want * B)[:B]), S)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,D,num_pages,page_size,max_pages,lens",
    [
        (2, 4, 2, 64, 8, 16, 3, None),
        (3, 8, 2, 64, 16, 32, 4, None),
        (1, 8, 1, 128, 8, 64, 2, None),
        (2, 4, 4, 32, 12, 8, 6, None),
        (4, 32, 8, 128, 40, 16, 9, None),
        (3, 48, 1, 128, 40, 16, 9, None),   # granite-20b: 48 query heads over one KV head
        (2, 96, 2, 64, 24, 16, 6, None),    # G = 48 over two KV heads
        (2, 12, 1, 32, 8, 16, 3, None),     # G = 12: four rows per warp
        (8, 32, 8, 128, 1025, 16, 128, "edges"),  # qwen3-8b at batch 8: 8 splits
        (8, 48, 1, 128, 1025, 16, 128, "edges"),  # granite-20b at batch 8: 16 splits
        (4, 32, 8, 64, 200, 8, 40, "edges"),      # pages of 8 over several splits
        (4, 8, 2, 64, 60, 64, 12, "edges"),       # pages of 64 over several splits
        (8, 32, 32, 64, 1025, 16, 128, None),     # zamba2-1.2b at batch 8: 3 splits
        (2, 6, 2, 16, 8, 16, 3, None),            # head_dim 16, G = 3
        (4, 8, 2, 16, 60, 16, 12, "edges"),       # head_dim 16 over several splits
        (8, 24, 8, 128, 1025, 16, 128, "edges"),  # phi4-mini at batch 8: G = 3
        (8, 14, 2, 64, 1025, 16, 128, "edges"),   # internvl2-1b at batch 8: G = 7
    ],
)
def test_paged_kernel_matches_plain(cuda, dtype, B, H, KV, D, num_pages, page_size,
                                    max_pages, lens):
    rng = np.random.default_rng(num_pages)
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    pk = _randn(rng, (num_pages, page_size, KV, D), dtype, cuda)
    pv = _randn(rng, (num_pages, page_size, KV, D), dtype, cuda)
    pt = torch.as_tensor(rng.integers(0, num_pages, size=(B, max_pages)),
                         dtype=torch.int32, device=cuda)
    if lens == "edges":
        _, split_len = paged_mod.paged_splits(B, KV, max_pages, page_size,
                                              paged_mod.sm_count(cuda), dtype)
        lengths = _split_edge_lengths(B, max_pages, page_size, split_len)
    else:
        lengths = rng.integers(1, max_pages * page_size + 1, size=B)
        lengths[0] = 0  # an idle slot gives zeros
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_decode_attention(q, pk, pv, pt, lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    want = paged_mod.paged_decode_attention_plain(q[:, 0], pk, pv, pt, lengths)[:, None]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert got[0].abs().max().item() == 0.0


def _decode_mask(rng, B, S, kind, device):
    """A (B, S) bool mask: ragged prefixes (one empty row, one full), or
    ring-shaped (the live slots of a window that has wrapped: a run of
    valid slots that starts and ends mid-cache, and one empty row)."""
    valid = np.zeros((B, S), bool)
    for b in range(B):
        if kind == "prefix":
            valid[b, :int(rng.integers(1, S + 1))] = True
        else:
            start, n = int(rng.integers(0, S)), int(rng.integers(1, S + 1))
            valid[b, (start + np.arange(n)) % S] = True
    valid[0] = False
    if B > 1 and kind == "prefix":
        valid[1] = True
    return torch.as_tensor(valid, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefix", "ring"])
@pytest.mark.parametrize(
    "B,KV,G,D,S",
    [
        (3, 2, 1, 64, 300),    # one query head per KV head; S not a multiple of 32
        (4, 2, 4, 128, 1000),  # qwen3-8b's group
        (3, 1, 48, 128, 2047), # granite-20b: 48 query heads over one KV head
        (2, 1, 48, 64, 77),
        (2, 2, 12, 32, 40),    # four rows per warp; the smoke configs' head_dim
        (1, 8, 4, 128, 5),     # a cache shorter than one tile
        (3, 1, 20, 128, 700),  # G not a multiple of 16: two 16-row tiles, 12 padding rows
        (3, 2, 6, 64, 130),    # G = 6: one 16-row tile, 10 padding rows
        (2, 1, 64, 64, 200),   # G = 64: four 16-row tiles, one a warp
        (3, 2, 3, 16, 300),    # head_dim 16 at phi4-mini's G = 3
        (2, 2, 4, 16, 1000),   # head_dim 16 at llama3-405b's smoke group
        (2, 8, 3, 128, 1000),  # phi4-mini: G = 3
        (2, 2, 7, 64, 700),    # internvl2-1b: G = 7
    ],
)
def test_decode_kernel_matches_plain(cuda, dtype, kind, B, KV, G, D, S):
    rng = np.random.default_rng(S + G)
    H = KV * G
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    k = _randn(rng, (B, S, KV, D), dtype, cuda)
    v = _randn(rng, (B, S, KV, D), dtype, cuda)
    valid = _decode_mask(rng, B, S, kind, cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = dec_mod.decode_attention_plain(q[:, 0], k, v, valid)[:, None]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert got[0].abs().max().item() == 0.0  # a row with nothing valid gives zeros


def test_decode_kernel_reads_a_layer_of_the_stacked_cache(cuda):
    """k/v as one layer of the transformer's stacked (L, B, S, KV, D) cache,
    q as a head slice of the projection, the mask a broadcast view."""
    rng = np.random.default_rng(3)
    L, B, S, KV, G, D = 3, 2, 130, 2, 4, 64
    kc = _randn(rng, (L, B, S, KV, D), torch.bfloat16, cuda)
    vc = _randn(rng, (L, B, S, KV, D), torch.bfloat16, cuda)
    qp = _randn(rng, (B, 1, KV * G * D + 16), torch.bfloat16, cuda)
    q = qp[..., :KV * G * D].reshape(B, 1, KV * G, D)
    valid = (torch.arange(S, device=cuda) < 97)[None].expand(B, S)
    got = ops.decode_attention(q, kc[1], vc[1], valid)
    want = dec_mod.decode_attention_plain(q[:, 0], kc[1], vc[1], valid)[:, None]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_decode_wrapper_raises_and_never_falls_back(cuda, monkeypatch):
    rng = np.random.default_rng(4)
    q = _randn(rng, (2, 1, 8, 64), torch.float32, cuda)
    k = _randn(rng, (2, 40, 2, 64), torch.float32, cuda)
    valid = torch.ones((2, 40), dtype=torch.bool, device=cuda)

    def plain_called(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(dec_mod, "decode_attention_plain", plain_called)
    ops.decode_attention(q, k, k, valid)  # the kernel, not the plain version
    before = ops.LAUNCHES["decode_attention"]
    bad = [
        ((q[..., :48], k[..., :48], k[..., :48], valid), "head_dim"),
        ((q, k.bfloat16(), k.bfloat16(), valid), "dtype"),
        ((q, k, k, valid.int()), "bool"),
        ((q, k, k, valid.cpu()), "CUDA device"),
        ((q, k, k, valid[:, :39]), "shapes"),
        ((_randn(rng, (2, 1, 130, 64), torch.float32, cuda), k, k, valid), "kv heads"),
        ((q, k, k.transpose(1, 2).contiguous().transpose(1, 2), valid), "strides"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            ops.decode_attention(*args)
    assert ops.LAUNCHES["decode_attention"] == before


def test_wrappers_raise_on_unsupported_input(cuda):
    q = torch.zeros((1, 16, 4, 48), device=cuda)  # head_dim 48 has no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])


def _scan_inputs(rng, B, S, H, P, N, device):
    """Drawn as tests/test_kernels.py draws them: dt through softplus, A
    negative."""
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    x = f(rng.standard_normal((B, S, H, P)))
    dt = f(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    A = f(-np.exp(rng.standard_normal(H) * 0.5))
    return x, dt, A, f(rng.standard_normal((B, S, N))), f(rng.standard_normal((B, S, N)))


@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (1, 128, 2, 32, 16, 32),
        (2, 256, 4, 64, 32, 64),
        (1, 64, 8, 16, 64, 64),     # single chunk
        (2, 96, 2, 32, 16, 32),     # 3 chunks
        (1, 16, 8, 32, 16, 16),     # mamba2's smoke shape
        (1, 384, 32, 64, 128, 128), # mamba2-370m's heads and state, 3 chunks
        (1, 640, 64, 64, 64, 128),  # zamba2-1.2b's, 5 chunks
        (2, 144, 3, 16, 40, 48),    # chunk and N off the powers of two
        (1, 1024, 32, 64, 128, 128),  # mamba2-370m's longest prompt: 8 chunks
        (1, 2048, 32, 64, 128, 128),  # 16 chunks
        (2, 160, 2, 80, 24, 40),    # two P tiles, the second of 16 columns; ragged L
    ],
)
def test_ssm_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    rng = np.random.default_rng(S + N)
    args = _scan_inputs(rng, B, S, H, P, N, cuda)
    before = ops.LAUNCHES["ssm_scan"]
    y, fin = ops.ssm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    want_y, want_fin = ssm_scan_plain(*args, chunk)
    torch.testing.assert_close(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(fin, want_fin, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_ssm_scan_kernel_reads_strided_views_and_keeps_padded_states(cuda):
    """x, B and C as slices of one packed tensor, as the model passes them,
    and a row whose tail has dt = 0: its state is the state at its end."""
    rng = np.random.default_rng(1)
    B, S, H, P, N = 2, 256, 4, 32, 32
    packed = torch.as_tensor(rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32),
                             device=cuda)
    x = packed[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = packed[..., H * P:H * P + N], packed[..., H * P + N:]
    _, dt, A, _, _ = _scan_inputs(rng, B, S, H, P, N, cuda)
    dt[1, 200:] = 0.0
    y, fin = ops.ssm_scan(x, dt, A, Bm, Cm, chunk=64)
    want_y, want_fin = ssm_scan_plain(x, dt, A, Bm, Cm, 64)
    torch.testing.assert_close(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(fin, want_fin, atol=SCAN_TOL, rtol=SCAN_TOL)
    _, fin_short = ops.ssm_scan(x[1:, :200], dt[1:, :200], A, Bm[1:, :200], Cm[1:, :200],
                                chunk=40)
    torch.testing.assert_close(fin[1:], fin_short, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_ssm_scan_kernel_reads_rows_that_are_not_16_byte_aligned(cuda):
    """x, B and C one element into wider tensors: the kernel copies them 4
    bytes at a time instead of 16, with the same result."""
    rng = np.random.default_rng(6)
    B, S, H, P, N = 1, 256, 4, 64, 36
    x, dt, A, Bm, Cm = _scan_inputs(rng, B, S, H, P, N, cuda)
    wide = lambda t: torch.cat([t[..., :1], t], dim=-1)[..., 1:]  # noqa: E731
    xu, Bu, Cu = wide(x.reshape(B, S, H * P)).reshape(B, S, H, P), wide(Bm), wide(Cm)
    assert xu.data_ptr() % 16 and Bu.data_ptr() % 16 and Cu.data_ptr() % 16
    y, fin = ops.ssm_scan(xu, dt, A, Bu, Cu, chunk=64)
    want_y, want_fin = ssm_scan_plain(x, dt, A, Bm, Cm, 64)
    torch.testing.assert_close(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(fin, want_fin, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_ssm_scan_wrapper_raises_on_unsupported_input(cuda):
    rng = np.random.default_rng(2)
    x, dt, A, Bm, Cm = _scan_inputs(rng, 1, 96, 2, 32, 16, cuda)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssm_scan(x, dt, A, Bm, Cm, chunk=64)  # 96 % 64
    with pytest.raises(ValueError, match="chunk"):
        ops.ssm_scan(*_scan_inputs(rng, 1, 512, 2, 32, 16, cuda), chunk=256)
    with pytest.raises(ValueError, match="float32"):
        ops.ssm_scan(x.bfloat16(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.ssm_scan(x[..., :24], dt, A, Bm, Cm, chunk=32)
    for n in (300, 18):  # too large; not a multiple of 4
        with pytest.raises(ValueError, match="state size"):
            bc = torch.zeros((1, 96, n), device=cuda)
            ops.ssm_scan(x, dt, A, bc, bc, chunk=32)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssm_scan(x, dt, A.cpu(), Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="contiguous last axis"):
        ops.ssm_scan(x, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm,
                     chunk=32)


# -- MoE and MLA: plain torch on every device, held on the card to the CPU -------


def _smoke_block(spec_fn, cfg, seed):
    from repro_torch.models.common import init_params

    return init_params(spec_fn(cfg), seed, torch.device("cpu"), torch.float32, stacked=())


@pytest.mark.parametrize("shape,factor", [((1, 40, 128), 1.25), ((16, 1, 128), 0.25)])
def test_moe_forward_on_the_card_matches_the_cpu(cuda, shape, factor):
    """The same float32 weights and inputs: the card's output and aux loss
    within 1e-4 of the CPU's, dropped assignments (factor 0.25) included,
    and two runs on the card give the same bits (the accumulating
    index_put_ adds exact zeros to each slot's one real token)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import tree_to

    cfg = get_smoke_config("deepseek-v2-236b", dtype="float32", capacity_factor=factor)
    p = _smoke_block(tmoe.moe_specs, cfg, 0)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape, dtype=np.float32))
    want, want_aux = tmoe.moe_forward(p, cfg, x)
    pc = tree_to(p, cuda)
    got, aux = tmoe.moe_forward(pc, cfg, x.to(cuda))
    again, _ = tmoe.moe_forward(pc, cfg, x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.parametrize("window", [None, 8])
def test_mla_decode_on_the_card_matches_the_cpu(cuda, window):
    """Prefill then four ragged decode steps (slot 2 idle) on the flat or
    ring latent cache: outputs and caches within 1e-4 of the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as tattn
    from repro_torch.models.common import tree_to

    cfg = get_smoke_config("deepseek-v2-236b", dtype="float32", sliding_window=window)
    p = _smoke_block(tattn.mla_specs, cfg, 0)
    rng = np.random.default_rng(2)
    B, S = 3, 16
    x = torch.as_tensor(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    caches = {}
    outs = {}
    for dev in ("cpu", cuda):
        pd = tree_to(p, dev)
        _, pre = tattn.mla_prefill(pd, cfg, x.to(dev), torch.arange(S, device=dev).expand(B, S))
        cache = tattn.mla_init_cache(cfg, B, 32, torch.float32, torch.device(dev))
        for k in cache:
            cache[k][:, :pre[k].shape[1]] = pre[k]
        pos = torch.tensor([S, S - 3, -1], device=dev)
        outs[str(dev)] = []
        for t in range(4):
            xt = torch.as_tensor(np.random.default_rng(10 + t).standard_normal(
                (B, 1, cfg.d_model), dtype=np.float32)).to(dev)
            o, cache = tattn.mla_decode(pd, cfg, xt, cache, pos)
            outs[str(dev)].append(o.cpu())
            pos = torch.where(pos >= 0, pos + 1, pos)
        caches[str(dev)] = tree_to(cache, "cpu")
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b[:2], a[:2], atol=1e-4, rtol=1e-4)
    for k in caches["cpu"]:
        torch.testing.assert_close(caches[str(cuda)][k], caches["cpu"][k], atol=1e-4, rtol=1e-4)


# -- training: the kernels' gradients, and a train step on the card --------------


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|), in float32."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


def _flash_plain(window, scale):
    def plain(q, k, v):
        out = fa_mod.flash_attention_plain(*(x.transpose(1, 2) for x in (q, k, v)), scale,
                                           window)
        return out.transpose(1, 2)
    return plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,window", [
    (2, 4, 2, 48, 32, None),
    (1, 8, 2, 100, 128, 33),
    (2, 32, 8, 256, 128, None),   # qwen3-8b's heads
    (1, 48, 1, 130, 128, None),   # granite-20b's MQA
])
def test_flash_gradient_through_the_kernel_matches_plain(cuda, dtype, B, H, KV, S, D, window):
    """Under grad the wrapper launches the forward kernel once (the output
    has a grad_fn) and the backward kernel once, and dq, dk, dv are the
    plain version's autograd gradients within the forward's tolerance,
    relative to the largest gradient."""
    rng = np.random.default_rng(S + D)
    q, k, v = (_randn(rng, (B, S, n, D), dtype, cuda).requires_grad_() for n in (H, KV, KV))
    w = _randn(rng, (B, S, H, D), dtype, cuda)
    before = ops.LAUNCHES["flash_attention"], ops.LAUNCHES["flash_attention_bwd"]
    out = ops.flash_attention(q, k, v, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), w)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["flash_attention"], ops.LAUNCHES["flash_attention_bwd"]) == (
        before[0] + 1, before[1] + 1)
    plain_out = _flash_plain(window, 1 / math.sqrt(D))(q, k, v)
    want = torch.autograd.grad(plain_out, (q, k, v), w)
    assert _rel_err(out, plain_out) <= TOL[dtype]
    for name, g, ref in zip("qkv", got, want):
        assert g.dtype == dtype
        assert _rel_err(g, ref) <= TOL[dtype], f"d{name}"


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 4, 32, 16, 16),
    (1, 256, 32, 64, 128, 128),   # mamba2-370m's heads
])
def test_ssm_scan_gradient_through_the_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    rng = np.random.default_rng(S)
    x = _randn(rng, (B, S, H, P), torch.float32, cuda).requires_grad_()
    dt = torch.nn.functional.softplus(_randn(rng, (B, S, H), torch.float32, cuda)
                                      ).requires_grad_()
    A = (-torch.exp(_randn(rng, (H,), torch.float32, cuda) * 0.5)).requires_grad_()
    Bm, Cm = (_randn(rng, (B, S, N), torch.float32, cuda).requires_grad_() for _ in range(2))
    w = _randn(rng, (B, S, H, P), torch.float32, cuda)
    args = (x, dt, A, Bm, Cm)
    before = ops.LAUNCHES["ssm_scan"], ops.LAUNCHES["ssm_scan_bwd"]
    y, final = ops.ssm_scan(*args, chunk=chunk)
    assert y.grad_fn is not None and final.grad_fn is not None
    got = torch.autograd.grad(y, args, w)  # the final state unused, as in training
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["ssm_scan"], ops.LAUNCHES["ssm_scan_bwd"]) == (
        before[0] + 1, before[1] + 1)
    want_y, _ = ssm_scan_plain(*args, chunk)
    want = torch.autograd.grad(want_y, args, w)
    assert _rel_err(y, want_y) <= SCAN_TOL
    for name, g, ref in zip(("x", "dt", "A", "B_", "C_"), got, want):
        assert _rel_err(g, ref) <= SCAN_TOL, f"d{name}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,window", [
    (2, 4, 2, 48, 32, None),
    (1, 8, 2, 100, 128, 33),
    (2, 32, 8, 256, 128, None),   # qwen3-8b's heads
    (1, 48, 1, 130, 128, None),   # granite-20b's MQA
    (1, 14, 2, 300, 64, None),    # internvl2-1b: G = 7
    (1, 6, 2, 100, 16, 5),        # head_dim 16 (phi4-mini's smoke heads) under a window
    (1, 4, 2, 1, 64, None),       # ragged against the 64-row tiles
    (1, 8, 8, 1024, 128, 256),    # the [grad] window shape's heads, one KV head a head
])
def test_flash_backward_kernel_matches_its_plain_backward(cuda, dtype, B, H, KV, S, D, window):
    """The forward kernel's log-sum-exp against the masked scores' (float32,
    1e-4 relative to the largest), and the backward kernel's dq, dk, dv
    against the explicit plain backward on the same q, k, v, out, lse and
    dout: within the forward's tolerance relative to the largest gradient
    (bf16 rounds P and dS to bf16 as the products' operands)."""
    rng = np.random.default_rng(S + D + H)
    q, k, v = (_randn(rng, (B, n, S, D), dtype, cuda) for n in (H, KV, KV))
    dout = _randn(rng, (B, H, S, D), dtype, cuda)
    scale = 1 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    fa_mod.launch(q, k, v, out, scale, window, lse)
    _, want_lse = fa_mod.flash_attention_plain_lse(q, k, v, scale, window)
    torch.cuda.synchronize()
    assert _rel_err(lse, want_lse) <= 1e-4
    got = [torch.empty_like(t) for t in (q, k, v)]
    fa_mod.launch_bwd(q, k, v, out, lse, dout, *got, scale, window)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, window)
    torch.cuda.synchronize()
    for name, g, ref in zip("qkv", got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        assert _rel_err(g, ref) <= TOL[dtype], f"d{name}"


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 4, 32, 16, 16),
    (1, 256, 32, 64, 128, 128),   # mamba2-370m's heads
    (1, 100, 3, 16, 20, 25),      # a chunk that is no multiple of 8 or 16
    (2, 128, 64, 64, 64, 128),    # zamba2-1.2b's heads
    (4, 1024, 32, 64, 128, 128),  # mamba2-370m's training shape
    (2, 128, 4, 32, 32, 128),     # one chunk: S = L
    (1, 256, 4, 64, 256, 128),    # N 256: one ring stage a head in dbc_heads
])
def test_ssm_scan_backward_kernel_matches_its_plain_backward(cuda, final, B, S, H, P, N, chunk):
    """The backward kernels on the forward kernel's scratch against the
    explicit plain backward on the same inputs and entering states, with
    d(final) zero and not, within the scan's tolerance relative to the
    largest gradient; the entering states the forward kept equal the plain
    ones."""
    from repro_torch.kernels import ssm_scan as ssm_mod

    rng = np.random.default_rng(S + H)
    x = _randn(rng, (B, S, H, P), torch.float32, cuda)
    dt = torch.nn.functional.softplus(_randn(rng, (B, S, H), torch.float32, cuda))
    A = -torch.exp(_randn(rng, (H,), torch.float32, cuda) * 0.5)
    Bm, Cm = (_randn(rng, (B, S, N), torch.float32, cuda) for _ in range(2))
    dy = _randn(rng, (B, S, H, P), torch.float32, cuda)
    dfinal = _randn(rng, (B, H, P, N), torch.float32, cuda) if final else None
    y, fin = torch.empty_like(x), torch.empty((B, H, P, N), device=cuda)
    scratch = ssm_mod.scratch(B, S, H, P, N, chunk, cuda)
    ssm_mod.launch(x, dt, A, Bm, Cm, chunk, y, fin, *scratch)
    entering = ssm_mod.ssm_scan_plain_states(x, dt, A, Bm, Cm, chunk)
    got = ssm_mod.launch_bwd(x, dt, A, Bm, Cm, chunk, *scratch, dy, dfinal)
    want = ssm_mod.ssm_scan_bwd_plain(x, dt, A, Bm, Cm, chunk, entering, dy, dfinal)
    torch.cuda.synchronize()
    assert _rel_err(scratch[1], entering) <= SCAN_TOL
    for name, g, ref in zip(("x", "dt", "A", "B_", "C_"), got, want):
        assert torch.isfinite(g).all()
        assert _rel_err(g, ref) <= SCAN_TOL, f"d{name}"


def test_ssm_scan_backward_kernel_is_deterministic_on_packed_inputs(cuda):
    """x, B, C and dt as views of one packed projection, x one element off
    16 bytes (the launcher copies it for the bulk copies): two backward
    calls are bit-equal, and equal the plain backward within the scan's
    tolerance."""
    from repro_torch.kernels import ssm_scan as ssm_mod

    B, S, H, P, N, chunk = 2, 512, 8, 64, 128, 128
    rng = np.random.default_rng(17)
    width = 1 + H * P + 2 * N + H
    packed = _randn(rng, (B, S, width), torch.float32, cuda)
    x = packed[..., 1:1 + H * P].unflatten(-1, (H, P))
    Bm, Cm = packed[..., 1 + H * P:1 + H * P + N], packed[..., 1 + H * P + N:1 + H * P + 2 * N]
    dt = torch.nn.functional.softplus(packed[..., -H:])
    A = -torch.exp(_randn(rng, (H,), torch.float32, cuda) * 0.5)
    dy = _randn(rng, (B, S, H, P), torch.float32, cuda)
    dfinal = _randn(rng, (B, H, P, N), torch.float32, cuda)
    y, fin = torch.empty((B, S, H, P), device=cuda), torch.empty((B, H, P, N), device=cuda)
    scratch = ssm_mod.scratch(B, S, H, P, N, chunk, cuda)
    ssm_mod.launch(x, dt, A, Bm, Cm, chunk, y, fin, *scratch)
    first = ssm_mod.launch_bwd(x, dt, A, Bm, Cm, chunk, *scratch, dy, dfinal)
    second = ssm_mod.launch_bwd(x, dt, A, Bm, Cm, chunk, *scratch, dy, dfinal)
    entering = ssm_mod.ssm_scan_plain_states(x, dt, A, Bm, Cm, chunk)
    want = ssm_mod.ssm_scan_bwd_plain(x, dt, A, Bm, Cm, chunk, entering, dy, dfinal)
    torch.cuda.synchronize()
    for name, a, b, ref in zip(("x", "dt", "A", "B_", "C_"), first, second, want):
        assert torch.equal(a, b), f"d{name} differs between two calls"
        assert _rel_err(a, ref) <= SCAN_TOL, f"d{name}"


def test_no_grad_calls_take_the_direct_path_and_count_one_launch(cuda):
    rng = np.random.default_rng(9)
    q, k, v = (_randn(rng, (1, 64, n, 64), torch.bfloat16, cuda).requires_grad_()
               for n in (4, 2, 2))
    ops.reset_launches()
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
        y, _ = ops.ssm_scan(*(_randn(rng, s, torch.float32, cuda) for s in
                              ((1, 32, 2, 16), (1, 32, 2), (2,), (1, 32, 8), (1, 32, 8))),
                            chunk=16)
    assert out.grad_fn is None and y.grad_fn is None
    assert ops.launches()["flash_attention"] == 1 and ops.launches()["ssm_scan"] == 1
    out = ops.flash_attention(q, k, v)  # under grad: the Function, one launch
    assert out.grad_fn is not None and ops.launches()["flash_attention"] == 2
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q[:, :1], k, v, torch.ones((1, 64), dtype=torch.bool,
                                                        device=cuda))


@pytest.mark.parametrize("arch,remat", [("qwen3-8b", True), ("zamba2-1.2b", False)])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, remat):
    """Two steps of the float32 smoke config from one init and the same
    batches: the metrics within 1e-4 relative of the CPU's (the kernels'
    float32 forward differs from the plain version by up to their
    tolerance; embed gradients accumulate through atomics), and every
    attention and Mamba2 layer launched its forward kernel (twice under
    remat) and its backward kernel once a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.common import tree_to
    from repro_torch.training import adamw, data, make_train_step

    cfg = get_smoke_config(arch, dtype="float32")
    model = Model(cfg, remat=remat)
    p_cpu = model.init(0, device="cpu")
    p_gpu = tree_to(p_cpu, cuda)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2)
    dcfg = data.DataConfig(batch=2, seq_len=32)
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        step, state = make_train_step(model, opt), adamw.init(params)
        ops.reset_launches()
        runs[dev] = []
        for i in range(2):
            params, state, m = step(params, state, data.synthetic_batch(cfg, dcfg, i, dev))
            runs[dev].append({k: float(v) for k, v in m.items()})
    for want, got in zip(runs["cpu"], runs["cuda"]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    n_attn = cfg.num_layers // (cfg.shared_attn_every or 1)
    n_ssm = cfg.num_layers if cfg.arch_type == "hybrid" else 0
    per = 2 if remat else 1
    assert ops.launches()["flash_attention"] == 2 * n_attn * per
    assert ops.launches()["ssm_scan"] == 2 * n_ssm * per
    # one backward launch a layer and step: the forward's count, half of it under remat
    assert ops.launches()["flash_attention_bwd"] == 2 * n_attn
    assert ops.launches()["ssm_scan_bwd"] == 2 * n_ssm


def test_fake_cuda_tensors_book_the_kernels_and_launch_nothing(cuda, monkeypatch):
    """The dry run's route on a card: fake CUDA tensors (indexing works
    where CUDA does) go to the fake route, which books each kernel's work
    to the counter, builds nothing, launches nothing, allocates nothing."""
    from repro_torch.kernels import _build
    from repro_torch.roofline.analysis import StepCounter

    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    c = StepCounter(kernels=True)
    B, S, H, KV, D = 2, 128, 8, 2, 64
    with c:
        q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device=cuda)
        k = torch.empty((B, S, KV, D), dtype=torch.bfloat16, device=cuda)
        valid = torch.ones((B, S), dtype=torch.bool, device=cuda)
        c.start(())
        o = ops.flash_attention(q, k, k)
        od = ops.decode_attention(q[:, :1], k, k, valid)
    assert o.shape == q.shape and od.shape == (B, 1, H, D)
    assert {n: v["calls"] for n, v in c.kernels.items()} == {
        "flash_attention": 1, "decode_attention": 1}
    assert c.kernels["flash_attention"]["flops"] == fa_mod.work(B, S, H, KV, D, None, 2)[0]
    assert ops.launches() == {n: 0 for n in ops.launches()}
    assert torch.cuda.memory_allocated() == before


def test_expert_parallel_moe_on_a_one_rank_nccl_group_matches_moe_forward(cuda):
    """``moe_forward_shard_map`` on a one-rank NCCL group's (1, 1) mesh
    against ``moe_forward`` (the deepseek-v2 smoke layer in bf16): one rank
    routes every token at the same capacity, so both agree to rounding.  In
    a process of its own: no other default group may exist there."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    script = r"""
import socket, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models.common import init_params
cfg = get_smoke_config("deepseek-v2-236b")
p = init_params(moe.moe_specs(cfg), 0, torch.device("cuda"), torch.bfloat16, stacked=())
x = torch.randn((4, 32, cfg.d_model), device="cuda").to(torch.bfloat16)
with socket.socket() as s:
    s.bind(("localhost", 0)); port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
try:
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    with torch.no_grad():
        want, aux_want = moe.moe_forward(p, cfg, x)
        got, aux = moe.moe_forward_shard_map(p, cfg, x, mesh)
    print((got.float() - want.float()).abs().max().item(), abs(float(aux) - float(aux_want)))
finally:
    dist.destroy_process_group()
"""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=root, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    err, aux_err = map(float, res.stdout.split())
    assert err <= TOL[torch.bfloat16] and aux_err <= 1e-6


# -- the serving engine's paged decode step as one CUDA graph --------------------


def _serve(model, params, backend, **engine_kw):
    """Six requests over three slots in the engine's closed loop: staggered
    admissions and finishes, slots refilled mid-run, contexts crossing page
    boundaries; on a small page pool, preemptions.  Returns (engine,
    stats, every request's tokens)."""
    from repro_torch.serving import Engine, Request, run_closed_loop

    rng = np.random.default_rng(4)
    lens, news = (9, 3, 14, 6, 11, 4), (12, 5, 9, 14, 3, 10)
    reqs = [Request(rid=i, prompt=rng.integers(1, model.cfg.vocab_size, L).astype(np.int32),
                    max_new_tokens=n) for i, (L, n) in enumerate(zip(lens, news))]
    eng = Engine(model, params, batch=3, max_len=64, kv_backend=backend, **engine_kw)
    stats = run_closed_loop(eng, reqs)
    return eng, stats, [r.out_tokens for r in reqs]


def _ordered(t):
    """bf16 bit patterns as integers in the order of their values (-0 and
    +0 both 0), so that neighbouring values differ by 1."""
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _assert_kernel_rounding(got, want, ulps=1):
    """bf16: no element more than ``ulps`` bf16 ulps from the plain version
    and at least 99.9% equal (the kernel rounds where the plain ops do;
    only a float32 sum's order, or powf/cosf against PyTorch's, can move a
    value across a rounding boundary); float32: within a few of its ulps."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return
    diff = (_ordered(got) - _ordered(want)).abs()
    assert diff.max().item() <= ulps
    assert (diff == 0).float().mean().item() >= 0.999


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("rows,D,layout", [
    (1, 6144, "contiguous"),      # granite-20b's decode, one slot
    (32, 6144, "contiguous"),     # its decode step of 32 slots
    (2556, 6144, "contiguous"),   # a code admission's mean prompt
    (2556 * 8, 128, "contiguous"),  # the per-head qk-norm (qwen3-8b's k heads)
    (33, 1001, "contiguous"),     # an odd width: one element at a time
    (17, 6144, "last_rows"),      # the final norm's rows of a prefill, strided
    (9, 512, "unaligned"),        # rows that start off a 16-byte boundary
])
def test_rmsnorm_kernel_matches_the_models_norm(cuda, dtype, residual, rows, D, layout):
    """The normed rows (a weight of ones) within one bf16 ulp of the plain
    norm's, 99.9% equal; the weight's product rounded exactly as the plain
    ops round it (so a one-ulp step of a normed value stays one ulp of it
    scaled), and the scaled rows 99.9% equal to the plain norm's."""
    from repro_torch.models.common import rmsnorm

    rng = np.random.default_rng(rows + D)
    shape = (rows, 3, D) if layout == "last_rows" else (rows + 1, D)
    x = _randn(rng, shape, dtype, cuda) * 2
    r = _randn(rng, shape, dtype, cuda)
    w = _randn(rng, (D,), dtype, cuda)
    ones = torch.ones((D,), dtype=dtype, device=cuda)
    if layout == "last_rows":
        x, r = x[:, -1:], r[:, -1:]
    elif layout == "unaligned":
        x, r = x.flatten()[1:1 + rows * D].view(rows, D), r.flatten()[3:3 + rows * D].view(rows, D)
    else:
        x, r = x[:rows], r[:rows]
    before = ops.LAUNCHES["rmsnorm"]
    if residual:
        got, s = ops.rmsnorm(x, w, 1e-5, residual=r)
        assert torch.equal(s, r + x)
        normed = ops.rmsnorm(x, ones, 1e-5, residual=r)[0]
        x = r + x
    else:
        got, normed = ops.rmsnorm(x, w, 1e-5), ops.rmsnorm(x, ones, 1e-5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == before + 2
    _assert_kernel_rounding(normed, rmsnorm(x, ones, 1e-5))
    assert torch.equal(got, normed * w)
    # one ulp of a normed value is at most two of it scaled, and the product rounds once
    _assert_kernel_rounding(got, rmsnorm(x, w, 1e-5), ulps=3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,KV,hd,theta", [(48, 1, 128, 10_000.0),   # granite-20b
                                           (32, 8, 128, 1e6),        # qwen3-8b
                                           (24, 8, 96, 10_000.0)])   # a head dim of 96
def test_rope_kernel_matches_apply_rope_in_place(cuda, dtype, H, KV, hd, theta):
    from repro_torch.models.common import apply_rope

    rng = np.random.default_rng(H + KV + hd)
    B, S = 3, 97
    q = _randn(rng, (B, S, H, hd), dtype, cuda)
    k = _randn(rng, (B, S, KV, hd), dtype, cuda)
    positions = torch.stack([
        torch.arange(-1, S - 1),                              # an idle slot's -1, then 0...
        torch.as_tensor(rng.integers(0, 8192, S)),            # anywhere up to 8,191
        torch.full((S,), 8191),
    ]).to(cuda)
    want_q, want_k = apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    before = ops.LAUNCHES["rope"]
    got_q, got_k = ops.rope(q, k, positions, theta)
    torch.cuda.synchronize()
    assert got_q is q and got_k is k and ops.LAUNCHES["rope"] == before + 1
    _assert_kernel_rounding(got_q, want_q)
    _assert_kernel_rounding(got_k, want_k)
    # a decode step's (B, 1) positions, q a view of the projection's rows
    qkv = _randn(rng, (B, 1, (H + 2 * KV) * hd), dtype, cuda)
    q1, k1 = qkv[..., :H * hd].view(B, 1, H, hd), qkv[..., H * hd:(H + KV) * hd].view(B, 1, KV, hd)
    pos = positions[:, -1:]
    want_q, want_k = apply_rope(q1, pos, theta), apply_rope(k1, pos, theta)
    v = qkv[..., (H + KV) * hd:].clone()
    ops.rope(q1, k1, pos, theta)
    torch.cuda.synchronize()
    _assert_kernel_rounding(q1, want_q)
    _assert_kernel_rounding(k1, want_k)
    assert torch.equal(qkv[..., (H + KV) * hd:], v)  # v's columns untouched


def test_norm_and_rope_wrappers_raise_on_unsupported_input(cuda):
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=cuda)
    pos = torch.zeros((1, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.rmsnorm(x, torch.ones(64, device=cuda))  # a float32 weight
    with pytest.raises(ValueError, match="w must be"):
        ops.rmsnorm(x, torch.ones(32, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="positions must be int64"):
        ops.rope(q, q, pos.int(), 10_000.0)
    with pytest.raises(ValueError, match="even"):
        ops.rope(q[..., :63], q[..., :63], pos, 10_000.0)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.rmsnorm(x.float().requires_grad_(), torch.ones(64, device=cuda))


def _staggered(model, params, backend):
    """chip_smoke.py's staggered admissions: one request, two steps, a
    second, a step, a third, then steps until all finish."""
    from repro_torch.serving import Engine, Request

    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(1, model.cfg.vocab_size, L).astype(np.int32),
                    max_new_tokens=6) for i, L in enumerate((3, 5, 9))]
    eng = Engine(model, params, batch=3, max_len=64, kv_backend=backend)
    eng.admit(reqs[0])
    eng.step()
    eng.step()
    eng.admit(reqs[1])
    eng.step()
    eng.admit(reqs[2])
    while eng.num_live:
        eng.step()
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("arch", ["granite-20b", "qwen3-8b"])
def test_paged_engine_replays_one_captured_step_with_the_flat_engines_tokens(cuda, arch):
    """The dense stack's paged engine captures its decode step once and
    replays it at every step; its tokens equal the eager flat engine's
    through staggered admissions, finishes, refilled slots, page
    boundaries and preemptions; each replay counts the eager step's
    launches; and a replay's logits are the eager step's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.common import tree_to

    model = Model(get_smoke_config(arch, dtype="float32"))
    params = tree_to(model.init(0, device="cpu"), cuda)
    L = model.cfg.num_layers
    _, flat_stats, want = _serve(model, params, "flat")
    ops.reset_launches()
    eng, stats, got = _serve(model, params, "paged", page_size=4, num_pages=12)
    counts = ops.launches()
    assert stats.preempted > 0 and flat_stats.preempted == 0
    assert got == want
    assert eng.graph_captures == 1 and eng.graph_replays == eng.steps > 0
    admissions = len(got) + stats.preempted
    norms = L * (4 if model.cfg.qk_norm else 2) + 1  # ln1, ln2, the qk-norm's two; final
    assert counts == dict(counts, paged_decode_attention=eng.steps * L,
                          flash_attention=admissions * L,
                          rmsnorm=(admissions + eng.steps) * norms,
                          rope=(admissions + eng.steps) * L)
    assert counts["decode_attention"] == counts["ssm_scan"] == 0

    flat_eng, want = _staggered(model, params, "flat")
    eng, got = _staggered(model, params, "paged")
    assert got == want and eng.graph_captures == 1 and eng.graph_replays == eng.steps
    assert flat_eng.graph_captures == 0

    # one more step: the replay's launches and logits are the eager step's
    from repro_torch.serving import Request

    eng.admit(Request(rid=9, prompt=np.arange(1, 20, dtype=np.int32), max_new_tokens=4))
    before = ops.launches()
    eng.step()
    replayed = eng._graph.logits.clone()
    mid = ops.launches()
    eager, _ = eng._graph.step(eng.params, eng.cache, eng._tokens, eng._positions)
    after = ops.launches()
    per_replay = {k: mid[k] - before[k] for k in mid if mid[k] != before[k]}
    per_eager = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
    assert per_replay == per_eager == {"paged_decode_attention": L, "rmsnorm": norms, "rope": L}
    torch.testing.assert_close(replayed, eager, atol=1e-5, rtol=1e-5)

    # close() frees the graph; the next step captures anew
    eng.close()
    assert eng._graph.graph is None and eng._graph.logits is None
    eng.step()
    assert eng.graph_captures == 2

    # the engine and its graph hold no reference cycle: dropping the engine
    # frees the graph there and then, not whenever the collector runs
    import gc
    import weakref

    graph = weakref.ref(eng._graph)
    gc.disable()
    try:
        del eng
        assert graph() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("arch,backend", [("zamba2-1.2b", "paged"), ("gqa-moe", "paged"),
                                          ("granite-20b", "flat")])
def test_hybrid_moe_and_flat_engines_take_the_eager_step(cuda, arch, backend):
    """Only the dense stack's paged step is captured: the hybrid's SSM
    layers look the live rows up, the MoE step is left eager, and so is the
    flat backend's; each serves as before."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.common import tree_to

    if arch == "gqa-moe":
        cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b", dtype="float32"),
                                  attention_kind="gqa")
    else:
        cfg = get_smoke_config(arch, dtype="float32")
    model = Model(cfg)
    params = tree_to(model.init(0, device="cpu"), cuda)
    eng, _, tokens = _serve(model, params, backend)
    assert eng.kv_backend == backend
    assert eng._graph is None
    assert eng.graph_captures == eng.graph_replays == 0
    assert all(len(t) == n for t, n in zip(tokens, (12, 5, 9, 14, 3, 10)))
