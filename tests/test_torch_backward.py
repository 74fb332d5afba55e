"""The backward kernels' plain specifications and the autograd Functions
that launch them on a card, on the CPU: ``flash_attention_bwd_plain`` and
``ssm_scan_bwd_plain`` against ``jax.grad`` of the JAX package's oracles
(``repro.kernels.ref.flash_attention_ref``, ``repro.models.ssm.ssd_chunked``)
and against torch autograd of the plain forwards; ``FlashAttentionFn`` and
``SsmScanFn`` with the plain halves against autograd; their fake halves
(the dry run) booking each backward's ``work_bwd`` without running a plain
version.

Inputs are drawn from a seed with numpy, float32.  Tolerance: 1e-5 of the
largest gradient (an explicit float32 backward sums in another order than
either autodiff).  The kernels themselves run only on a card
(``tests/test_torch_gpu.py``)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import flash_attention_ref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_mod  # noqa: E402
from repro_torch.roofline.analysis import StepCounter  # noqa: E402

TOL = 1e-5


def rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- flash attention ----------------------------------------------------------------


@pytest.mark.parametrize("S", [24, 100])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("G", [1, 2, 7])
def test_flash_bwd_plain_matches_jax_grad_and_autograd(G, D, window, S):
    KV = 2 if G < 7 else 1
    B, H = 2, G * KV
    rng = np.random.default_rng(G * 1000 + D * 10 + S + (window or 0))
    q, k, v = draw(rng, B, H, S, D), draw(rng, B, KV, S, D), draw(rng, B, KV, S, D)
    dout = draw(rng, B, H, S, D)
    scale = 1.0 / math.sqrt(D)

    def loss(q, k, v):
        return jnp.sum(flash_attention_ref(q, k, v, scale, window) * dout)

    want_jax = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    want_torch = torch.autograd.grad(fa_mod.flash_attention_plain(qt, kt, vt, scale, window),
                                     (qt, kt, vt), torch.as_tensor(dout))
    out, lse = fa_mod.flash_attention_plain_lse(*(torch.as_tensor(a) for a in (q, k, v)),
                                                scale, window)
    got = fa_mod.flash_attention_bwd_plain(*(torch.as_tensor(a) for a in (q, k, v)), out, lse,
                                           torch.as_tensor(dout), scale, window)
    for name, g, wj, wt in zip("qkv", got, want_jax, want_torch):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        assert rel(g, np.asarray(wj)) <= TOL, f"d{name} against jax.grad"
        assert rel(g, wt) <= TOL, f"d{name} against autograd"


@pytest.mark.parametrize("window", [None, 5])
def test_flash_plain_lse_is_the_masked_scores_logsumexp(window):
    rng = np.random.default_rng(11)
    B, H, KV, S, D = 1, 4, 2, 37, 16
    q, k, v = draw(rng, B, H, S, D), draw(rng, B, KV, S, D), draw(rng, B, KV, S, D)
    scale = 0.25
    out, lse = fa_mod.flash_attention_plain_lse(*(torch.as_tensor(a) for a in (q, k, v)),
                                                scale, window)
    assert rel(out, fa_mod.flash_attention_plain(
        *(torch.as_tensor(a) for a in (q, k, v)), scale, window)) <= TOL
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  np.repeat(k, H // KV, axis=1).astype(np.float64)) * scale
    qi, kj = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = (kj <= qi) & ((kj > qi - window) if window else True)
    s = np.where(ok, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert rel(lse, want) <= TOL


# -- the SSD scan -------------------------------------------------------------------


def scan_inputs(rng, B=2, S=32, H=3, P=8, N=4):
    x, Bm, Cm = draw(rng, B, S, H, P), draw(rng, B, S, N), draw(rng, B, S, N)
    dt = np.log1p(np.exp(draw(rng, B, S, H))).astype(np.float32)  # softplus
    A = (-np.exp(draw(rng, H) * 0.5)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssm_bwd_plain_matches_jax_grad_and_autograd(chunk, final):
    rng = np.random.default_rng(chunk + 2 * final)
    args = scan_inputs(rng)
    B, S, H, P = args[0].shape
    N = args[3].shape[-1]
    dy = draw(rng, B, S, H, P)
    dfinal = draw(rng, B, H, P, N) if final else np.zeros((B, H, P, N), np.float32)

    def loss(*a):
        y, fin = ssd_chunked(*a, chunk)
        return jnp.sum(y * dy) + jnp.sum(fin * dfinal)

    want_jax = jax.grad(loss, argnums=tuple(range(5)))(*args)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    y, fin = ssm_mod.ssm_scan_plain(*leaves, chunk)
    want_torch = torch.autograd.grad((y * torch.as_tensor(dy)).sum()
                                     + (fin * torch.as_tensor(dfinal)).sum(), leaves)
    plain = [torch.as_tensor(a) for a in args]
    entering = ssm_mod.ssm_scan_plain_states(*plain, chunk)
    got = ssm_mod.ssm_scan_bwd_plain(*plain, chunk, entering, torch.as_tensor(dy),
                                     torch.as_tensor(dfinal) if final else None)
    for name, g, wj, wt in zip(("x", "dt", "A", "B_", "C_"), got, want_jax, want_torch):
        assert g.shape == wt.shape
        assert rel(g, np.asarray(wj)) <= TOL, f"d{name} against jax.grad"
        assert rel(g, wt) <= TOL, f"d{name} against autograd"


def _clip_exp(t):
    return np.exp(np.clip(t, -60.0, 0.0))


def scan_bwd_dbc_by_design(x, dt, A, Bm, Cm, chunk, dy, dfinal, rows, cols):
    """dB and dC as the backward kernels form them (``csrc/ssm_scan_bwd.cu``),
    in float64 numpy.  The reverse state pass (``state_bwd_kernel``, ``cols``
    state columns a block) forms each chunk's own-state gradient G_{c+1}
    inside the recurrence, G_c = Σ_i E(cs_i) dy_i ⊗ C_i + G_{c+1} E(cs_L).
    Then a block of ``rows`` rows R of a chunk (``dbc_heads_kernel``) walks
    the heads in order: d(C·Bᵀ) = Σ_h (dy_h x_hᵀ) ⊙ E_h ⊙ dt_h on its cross
    of the lower triangle (R's rows left of and on the diagonal, R's columns
    below it), and the state terms as one contraction over (head, p):
    [E(cs) ⊙ dy]_(R, HP)·[entering]_(HP, N) and [w ⊙ x]_(R, HP)·[G]_(HP, N);
    then dC[R] += d(C·Bᵀ)[R, :]·B and dB[R] += d(C·Bᵀ)[:, R]ᵀ·C.  Returns
    (dB, dC, how many blocks formed each (chunk, i, j) of the lower
    triangle)."""
    x, dt, A, Bm, Cm, dy = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm, dy))
    Bb, S, H, P = x.shape
    N, L = Bm.shape[-1], chunk
    nc = S // L
    xr, dyr = x.reshape(Bb, nc, L, H, P), dy.reshape(Bb, nc, L, H, P)
    Br, Cr = Bm.reshape(Bb, nc, L, N), Cm.reshape(Bb, nc, L, N)
    cs = np.cumsum(dt.reshape(Bb, nc, L, H) * A, axis=2)  # (B, nc, L, H)
    dt_r = dt.reshape(Bb, nc, L, H)

    own = np.zeros((Bb, nc, H, P, N))
    for n0 in range(0, N, cols):  # a state_bwd block: its columns, last chunk first
        g = np.zeros((Bb, H, P, N))[..., n0:n0 + cols] if dfinal is None else \
            np.asarray(dfinal, np.float64)[..., n0:n0 + cols]
        for c in reversed(range(nc)):
            own[:, c, ..., n0:n0 + cols] = g
            enter = np.einsum("bih,bihp,bin->bhpn", _clip_exp(cs[:, c]), dyr[:, c],
                              Cr[:, c, :, n0:n0 + cols])
            g = enter + g * _clip_exp(cs[:, c, -1])[..., None, None]

    entering = np.zeros((Bb, nc, H, P, N))
    carry = np.zeros((Bb, H, P, N))
    for c in range(nc):
        entering[:, c] = carry
        w = _clip_exp(cs[:, c, -1:] - cs[:, c]) * dt_r[:, c]  # (B, L, H)
        carry = carry * _clip_exp(cs[:, c, -1])[..., None, None] + np.einsum(
            "bjh,bjhp,bjn->bhpn", w, xr[:, c], Br[:, c])

    dB, dC = np.zeros((Bb, nc, L, N)), np.zeros((Bb, nc, L, N))
    formed = np.zeros((nc, L, L), int)
    ii, jj = np.arange(L)[:, None], np.arange(L)[None, :]
    for b in range(Bb):
        for c in range(nc):
            for r0 in range(0, L, rows):
                xe, de = min(r0 + rows, L), range(r0, min(r0 + rows, L))
                cross = ((ii >= r0) & (ii < xe)) | ((jj >= r0) & (jj < xe) & (ii >= xe))
                cross &= jj <= ii
                formed[c] += cross * (b == 0)
                dcb = np.zeros((L, L))
                for h in range(H):
                    e = _clip_exp(cs[b, c, :, h][:, None] - cs[b, c, :, h][None, :])
                    dcb += np.where(cross, dyr[b, c, :, h] @ xr[b, c, :, h].T * e
                                    * dt_r[b, c, :, h][None, :], 0.0)
                ew = _clip_exp(cs[b, c, de])  # (rows, H)
                ww = _clip_exp(cs[b, c, -1] - cs[b, c, de]) * dt_r[b, c, de]
                dC[b, c, de] = ((ew[..., None] * dyr[b, c, de]).reshape(len(de), H * P)
                                @ entering[b, c].reshape(H * P, N) + dcb[de] @ Br[b, c])
                dB[b, c, de] = ((ww[..., None] * xr[b, c, de]).reshape(len(de), H * P)
                                @ own[b, c].reshape(H * P, N) + dcb[:, de].T @ Cr[b, c])
    return dB.reshape(Bb, S, N), dC.reshape(Bb, S, N), formed


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("chunk,rows", [(8, 4), (40, 32), (40, 16)])
def test_ssm_bwd_head_sums_by_row_tiles_match_the_plain_backward_and_jax_grad(chunk, rows,
                                                                             final):
    """The algebra the backward kernels rely on: the heads' shares of dB
    and dC summed on chip, d(C·Bᵀ) formed once per lower-triangle element
    by row tiles (the last one ragged at chunk 40), the state terms as one
    contraction over (head, p), the own-state gradients inside the reverse
    recurrence (two column blocks), against ssm_scan_bwd_plain and jax.grad
    of the reference's ssd_chunked."""
    rng = np.random.default_rng(chunk + rows + final)
    args = scan_inputs(rng, S=80)
    B, S, H, P = args[0].shape
    N = args[3].shape[-1]
    dy = draw(rng, B, S, H, P)
    dfinal = draw(rng, B, H, P, N) if final else None

    def loss(*a):
        y, fin = ssd_chunked(*a, chunk)
        return jnp.sum(y * dy) + (jnp.sum(fin * dfinal) if final else 0.0)

    want_jax = jax.grad(loss, argnums=(3, 4))(*args)
    plain = [torch.as_tensor(a) for a in args]
    entering = ssm_mod.ssm_scan_plain_states(*plain, chunk)
    want = ssm_mod.ssm_scan_bwd_plain(*plain, chunk, entering, torch.as_tensor(dy),
                                      None if dfinal is None else torch.as_tensor(dfinal))[3:]
    dB, dC, formed = scan_bwd_dbc_by_design(*args, chunk, dy, dfinal, rows, cols=2)
    tile = np.arange(chunk) // rows
    twice = 1 + (tile[:, None] != tile[None, :])
    assert (formed == np.tril(twice)).all()
    for name, got, wp, wj in zip(("B_", "C_"), (dB, dC), want, want_jax):
        assert rel(got, wp) <= TOL, f"d{name} against ssm_scan_bwd_plain"
        assert rel(got, np.asarray(wj)) <= TOL, f"d{name} against jax.grad"


def test_launch_bwd_allocates_no_scratch_per_head_and_step(monkeypatch):
    """launch_bwd's scratch (``bwd_scratch``): each chunk's own state's
    gradient, the decay gradient's block sums and the dA shares; no
    (B, nc, H, L, ·) tensor, at mamba2-370m's training shape and through
    launch_bwd itself (its library replaced by a recorder)."""
    B, S, H, P, N, L = 4, 1024, 32, 64, 128, 128
    nc = S // L
    shapes = [tuple(t.shape) for t in ssm_mod.bwd_scratch(B, S, H, P, N, L, "meta")]
    assert shapes == [(B, nc, H, P, N), (B, nc, H, 2), (B, nc, H)]

    calls, made = [], []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made.append(tuple(t.shape))
        return t

    class Lib:
        @staticmethod
        def repro_ssm_scan_bwd(*a):
            calls.append(a)
            return 0

    monkeypatch.setattr(_build, "load", lambda name: Lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch, "empty", empty)
    Bs, Ss, Hs, Ps, Ns, Ls = 2, 64, 3, 32, 32, 16
    rng = np.random.default_rng(5)
    x, dt, A, Bm, Cm = (torch.as_tensor(a) for a in scan_inputs(rng, Bs, Ss, Hs, Ps, Ns))
    fwd_scratch = ssm_mod.scratch(Bs, Ss, Hs, Ps, Ns, Ls, "cpu")
    made.clear()
    grads = ssm_mod.launch_bwd(x, dt, A, Bm, Cm, Ls, *fwd_scratch, torch.zeros_like(x), None)
    assert len(calls) == 1 and len(calls[0]) == 18 + 6 + 3
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in (x, dt, A, Bm, Cm)]
    ncs = Ss // Ls
    assert made == [(Bs, Ss, Hs, Ps), (Bs, Ss, Hs), (Hs,), (Bs, Ss, Ns), (Bs, Ss, Ns),
                    (Bs, ncs, Hs, Ps, Ns), (Bs, ncs, Hs, 1), (Bs, ncs, Hs)]
    assert not any(s[:4] == (Bs, ncs, Hs, Ls) for s in made)


def test_ssm_plain_states_are_the_carry_entering_each_chunk():
    """What the forward kernel leaves in its states scratch: the state
    entering each chunk, the last chunk's carried on to the final state."""
    args = [torch.as_tensor(a) for a in scan_inputs(np.random.default_rng(3))]
    entering = ssm_mod.ssm_scan_plain_states(*args, 8)
    _, final = ssm_mod.ssm_scan_plain(*args, 8)
    _, first = ssm_mod.ssm_scan_plain(*(a[:, :8] if a.dim() > 1 else a for a in args), 8)
    assert entering.shape == (2, 4, 3, 8, 4) and not entering[:, 0].any()
    torch.testing.assert_close(entering[:, 1], first, atol=1e-6, rtol=1e-6)
    _, three = ssm_mod.ssm_scan_plain(*(a[:, :24] if a.dim() > 1 else a for a in args), 8)
    torch.testing.assert_close(entering[:, 3], three, atol=1e-6, rtol=1e-6)
    assert final.shape == entering[:, 0].shape


# -- the Functions ------------------------------------------------------------------


# the Functions' plain halves: the plain forward and the explicit plain backward
PLAIN_FLASH = (fa_mod.flash_attention_plain_lse, fa_mod.flash_attention_bwd_plain)
PLAIN_SCAN = (lambda *a: (*ssm_mod.ssm_scan_plain(*a), (ssm_mod.ssm_scan_plain_states(*a),)),
              ssm_mod.ssm_scan_bwd_plain)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_function_on_the_plain_route_equals_autograd(window):
    rng = np.random.default_rng(21)
    q, k, v = (torch.as_tensor(draw(rng, 2, 30, n, 32)).requires_grad_() for n in (14, 2, 2))
    w = torch.as_tensor(draw(rng, 2, 30, 14, 32))
    scale = 32 ** -0.5
    out = ops.FlashAttentionFn.apply(PLAIN_FLASH, q, k, v, window, scale)
    got = torch.autograd.grad(out, (q, k, v), w)
    want_out = fa_mod.flash_attention_plain(*(x.transpose(1, 2) for x in (q, k, v)), scale,
                                            window).transpose(1, 2)
    want = torch.autograd.grad(want_out, (q, k, v), w)
    assert rel(out.detach(), want_out.detach()) <= TOL
    for g, r in zip(got, want):
        assert rel(g, r) <= TOL


@pytest.mark.parametrize("final", [False, True])
def test_scan_function_on_the_plain_route_equals_autograd(final):
    rng = np.random.default_rng(22)
    leaves = [torch.as_tensor(a).requires_grad_() for a in scan_inputs(rng, S=48)]
    dy = torch.as_tensor(draw(rng, 2, 48, 3, 8))
    dfin = torch.as_tensor(draw(rng, 2, 3, 8, 4))

    def grads(fn):
        y, fin = fn(*leaves)
        loss = (y * dy).sum() + ((fin * dfin).sum() if final else 0)
        return torch.autograd.grad(loss, leaves)

    got = grads(lambda *a: ops.SsmScanFn.apply(PLAIN_SCAN, *a, 16))
    want = grads(lambda *a: ssm_mod.ssm_scan_plain(*a, 16))
    for g, r in zip(got, want):
        assert rel(g, r) <= TOL


def fake(counter, *shape, dtype=torch.float32):
    with counter:
        return torch.empty(shape, dtype=dtype).requires_grad_()


def test_fake_route_under_grad_books_the_backward_work_and_runs_no_plain_version(monkeypatch):
    """The dry run's training step: fake tensors of a counter that prices
    the card's kernels, under grad, book each Function's forward and
    backward (``work`` and ``work_bwd``), build and launch nothing, and
    call no plain version forward or backward."""
    for mod, name in ((fa_mod, "flash_attention_plain"), (fa_mod, "flash_attention_plain_lse"),
                      (fa_mod, "flash_attention_bwd_plain"), (ssm_mod, "ssm_scan_plain"),
                      (ssm_mod, "ssm_scan_plain_states"), (ssm_mod, "ssm_scan_bwd_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(f"ran {_n}"))
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    ops.reset_launches()
    c = StepCounter(kernels=True)
    B, S, H, KV, D, P, N, L = 2, 256, 8, 2, 64, 64, 32, 32
    q, k, v = (fake(c, B, S, n, D, dtype=torch.bfloat16) for n in (H, KV, KV))
    x, dt, A = fake(c, B, S, H, P), fake(c, B, S, H), fake(c, H)
    Bm, Cm = fake(c, B, S, N), fake(c, B, S, N)
    with c, torch.enable_grad():
        c.start(())
        o = ops.flash_attention(q, k, v, window=64)
        y, _ = ops.ssm_scan(x, dt, A, Bm, Cm, L)
        grads = torch.autograd.grad([o.float().sum(), y.sum()], [q, k, v, x, dt, A, Bm, Cm])
    assert [g.shape for g in grads] == [t.shape for t in (q, k, v, x, dt, A, Bm, Cm)]
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)
    want = {
        "flash_attention": fa_mod.work(B, S, H, KV, D, 64, 2),
        "flash_attention_bwd": fa_mod.work_bwd(B, S, H, KV, D, 64, 2),
        "ssm_scan": ssm_mod.work(B, S, H, P, N, L),
        "ssm_scan_bwd": ssm_mod.work_bwd(B, S, H, P, N, L),
    }
    assert {n: (kk["calls"], kk["flops"], kk["bytes"]) for n, kk in c.kernels.items()} == {
        n: (1, *w) for n, w in want.items()}


def test_backward_work_counts_the_causal_pairs_and_the_saved_states():
    """work_bwd: flash's five products over the live pairs (2.5 times the
    forward's FLOPs); the scan's about twice the forward's products, and
    its bytes exactly x, dy and dx, dt, A, B, C and their gradients and
    the entering states it reads, once each (d(final) only when the loss
    reaches the final state; never the forward's y)."""
    f_fl, f_by = fa_mod.work(1, 128, 4, 2, 32, None, 2)
    b_fl, b_by = fa_mod.work_bwd(1, 128, 4, 2, 32, None, 2)
    assert b_fl == 2.5 * f_fl and b_by == 2 * f_by + 4 * 4 * 128
    s_fl, _ = ssm_mod.work(1, 256, 4, 64, 32, 64)
    bs_fl, bs_by = ssm_mod.work_bwd(1, 256, 4, 64, 32, 64)
    assert 1.5 * s_fl < bs_fl < 2.5 * s_fl
    B, S, H, P, N, nc = 1, 256, 4, 64, 32, 256 // 64
    assert bs_by == 4 * (3 * B * S * H * P + 2 * (B * S * H + H + 2 * B * S * N)
                         + B * nc * H * P * N)
    with_final = ssm_mod.work_bwd(1, 256, 4, 64, 32, 64, with_final=True)[1]
    assert with_final - bs_by == 4 * B * H * P * N
