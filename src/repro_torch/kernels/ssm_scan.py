"""The Mamba2 SSD chunked scan: the CUDA kernel's launcher and its plain
version.

The kernel (``csrc/ssm_scan.cu``) replaces the Pallas ``ssm_scan_bshp``:
within each chunk of ``L`` steps the quadratic term
``(C·Bᵀ ⊙ exp(segsum(dt·A)) ⊙ dt)·x``, plus the term of the state entering
the chunk, ``exp(cumsum(dt·A)) · C·state``; the float32 ``(H, P, N)`` state
is carried across chunks, and every exponent is clipped to [-60, 0].  It
runs the plain version's steps as four launches (C·Bᵀ of every chunk, each
chunk's own state, the carried recurrence over the chunks, then y), the
products on the tensor cores in 3xTF32, which keeps float32 accuracy.
Under training the caller keeps the forward's scratch: each chunk's C·Bᵀ,
the state entering each chunk and each chunk's decay exponent, which the
backward (``csrc/ssm_scan_bwd.cu``) reads; :func:`ssm_scan_bwd_plain` is
the backward's specification in plain PyTorch (the JAX package
differentiates its jnp ``ssd_chunked``; it has no backward kernel).

Layouts (the reference kernel's), all float32:
  x      : (B, S, H, P), any batch/seq/head strides, contiguous P
  dt     : (B, S, H) post-softplus, contiguous H
  A      : (H,) negative
  B_, C_ : (B, S, N), one group shared by every head, contiguous N
Returns y (B, S, H, P) and the final state (B, H, P, N).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128  # steps per chunk the kernel stages in shared memory
P_MULTIPLE = 16  # the head dim is a whole number of 16-row tensor-core tiles
MAX_STATE = 256  # state size N the kernel's shared-memory budget holds
MAX_BWD_P = 64  # head dim the backward kernel stages whole
BWD_STATE_COLS = 64  # state columns a block of the backward's state pass carries
BWD_BOX = 32  # the backward's TMA boxes: head dim and state size in whole boxes


def _clip_exp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(t, -60.0, 0.0))


def _entering_states(xr, dtr, Br, dA_cs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's own state, then the carried recurrence over the chunks:
    (the state entering each chunk (B,nc,H,P,N), the final state)."""
    Bb, nc, _, H, Pd = xr.shape
    # per-chunk summary state
    last = dA_cs[:, :, -1:, :]  # (B,nc,1,H)
    seg = _clip_exp(last - dA_cs)  # decay from step j to the chunk's end
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", seg * dtr, Br, xr)  # (B,nc,H,P,N)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = _clip_exp(last[:, :, 0, :])  # (B,nc,H)
    carry = torch.zeros((Bb, H, Pd, Br.shape[-1]), dtype=xr.dtype, device=xr.device)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(entering, dim=1), carry


def ssm_scan_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, as the JAX package's
    ``ssd_chunked`` writes it: einsums over every chunk at once, then a
    loop over the chunks for the carried state.  Returns
    ``(y (B,S,H,P), final_state (B,H,P,N))``."""
    Bb, S, H, Pd = x.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"ssm_scan: sequence length {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    xr = x.reshape(Bb, nc, chunk, H, Pd)
    dtr = dt.reshape(Bb, nc, chunk, H)
    Br = B_.reshape(Bb, nc, chunk, N)
    Cr = C_.reshape(Bb, nc, chunk, N)

    dA_cs = torch.cumsum(dtr * A, dim=2)  # (B,nc,L,H), inclusive

    # intra-chunk (quadratic within the chunk)
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)  # (B,nc,L,L)
    decay = _clip_exp(dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :])  # (B,nc,L,L,H)
    m = cb[..., None] * decay * dtr[:, :, None, :, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    m = torch.where(mask[None, None, :, :, None], m, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xr)

    prev_states, carry = _entering_states(xr, dtr, Br, dA_cs)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cr, prev_states) * _clip_exp(dA_cs)[..., None]
    return (y_intra + y_inter).reshape(Bb, S, H, Pd), carry


def _clip_exp_grad(t: torch.Tensor) -> torch.Tensor:
    """d clip_exp(t) / dt under clamp's rule: exp(t) where -60 <= t <= 0,
    else 0."""
    return torch.where((t >= -60.0) & (t <= 0.0), torch.exp(t.clamp(-60.0, 0.0)), 0.0)


def ssm_scan_bwd_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
    entering: torch.Tensor,  # (B, nc, H, P, N): the state entering each chunk
    dy: torch.Tensor,  # (B, S, H, P)
    dfinal: Optional[torch.Tensor] = None,  # (B, H, P, N); None: the loss does not reach it
) -> Tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, dA, dB_, dC_) of :func:`ssm_scan_plain`'s
    outputs, written out chunk by chunk in plain PyTorch (not autograd):
    the specification the backward kernel follows.  Per chunk, with cs the
    inclusive cumsum of dt·A, E = clip_exp and E' its clamp-rule
    derivative:

    * the entering state's gradient G_c = Σ_i E(cs_i) dy_i ⊗ C_i +
      G_{c+1} E(cs_L), from G_nc = d(final); each chunk's own state gets
      G_{c+1}, and its decay exponent cs_L the term E'(cs_L) Σ G_{c+1} ⊙
      entering_c;
    * with W_ij = C_i·B_j E(cs_i - cs_j) dt_j (j <= i) and dW = dy·xᵀ:
      dx = Wᵀ dy + w ⊙ (B G_{c+1}ᵀ) with w_j = E(cs_L - cs_j) dt_j; dC and
      dB from d(C·Bᵀ) = dW E dt (summed over heads), from dy·entering
      (dC) and from x·G_{c+1} (dB);
    * the cumsum exponents' gradient (from E' of every exponent), then its
      reverse cumsum within the chunk gives ddt (beside dt's direct terms)
      and dA."""
    Bb, S, H, Pd = x.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"ssm_scan: sequence length {S} is not a multiple of chunk {chunk}")
    nc, L = S // chunk, chunk
    xr, dyr = x.reshape(Bb, nc, L, H, Pd), dy.reshape(Bb, nc, L, H, Pd)
    dtr = dt.reshape(Bb, nc, L, H)
    Br, Cr = B_.reshape(Bb, nc, L, N), C_.reshape(Bb, nc, L, N)
    cs = torch.cumsum(dtr * A, dim=2)  # (B,nc,L,H)
    last = cs[:, :, -1]  # (B,nc,H)

    # the entering states' gradients, last chunk first
    d_enter = torch.einsum("bcih,bcihp,bcin->bchpn", _clip_exp(cs), dyr, Cr)
    g = torch.zeros((Bb, H, Pd, N), dtype=x.dtype, device=x.device) if dfinal is None \
        else dfinal
    d_own, d_last = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        d_own[c] = g
        d_last[c] = _clip_exp_grad(last[:, c]) * (g * entering[:, c]).sum((-1, -2))
        g = d_enter[:, c] + g * _clip_exp(last[:, c])[..., None, None]
    d_own = torch.stack(d_own, dim=1)  # (B,nc,H,P,N)

    # within the chunk: W = CB ⊙ E(cs_i - cs_j) ⊙ dt_j on and below the diagonal
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,L_i,L_j,H)
    e = torch.where(mask, _clip_exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    dW = torch.where(mask, torch.einsum("bcihp,bcjhp->bcijh", dyr, xr), 0.0)
    dx = torch.einsum("bcijh,bcihp->bcjhp", cb[..., None] * e * dtr[:, :, None], dyr)
    dcb = (dW * e * dtr[:, :, None]).sum(-1)  # summed over heads: B and C are shared
    dC = torch.einsum("bcij,bcjn->bcin", dcb, Br)
    dB = torch.einsum("bcij,bcin->bcjn", dcb, Cr)
    r = dW * cb[..., None] * torch.where(mask, _clip_exp_grad(seg), 0.0) * dtr[:, :, None]
    dcs = r.sum(3) - r.sum(2)
    ddt = (dW * cb[..., None] * e).sum(2)

    # the entering state's term of y: E(cs_i) C_i·entering
    z = torch.einsum("bcihp,bchpn->bcihn", dyr, entering)
    dC = dC + torch.einsum("bcih,bcihn->bcin", _clip_exp(cs), z)
    dcs = dcs + _clip_exp_grad(cs) * torch.einsum("bcihn,bcin->bcih", z, Cr)

    # the chunk's own state, Σ_j w_j x_j ⊗ B_j with w_j = E(cs_L - cs_j) dt_j
    to_end = last[:, :, None, :] - cs
    w = _clip_exp(to_end) * dtr
    v = torch.einsum("bcjn,bchpn->bcjhp", Br, d_own)
    dx = dx + w[..., None] * v
    dw = (xr * v).sum(-1)  # (B,nc,L,H)
    ddt = ddt + _clip_exp(to_end) * dw
    r_end = _clip_exp_grad(to_end) * dtr * dw
    dcs = dcs - r_end
    dB = dB + torch.einsum("bcjh,bcjhp,bchpn->bcjn", w, xr, d_own)
    dcs[:, :, -1] += r_end.sum(2) + torch.stack(d_last, dim=1)

    # cs = cumsum(dt·A): each step's exponent gradient summed over the steps after it
    rc = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])
    ddt = ddt + A * rc
    dA = (dtr * rc).sum((0, 1, 2))
    return (dx.reshape(Bb, S, H, Pd), ddt.reshape(Bb, S, H), dA, dB.reshape(Bb, S, N),
            dC.reshape(Bb, S, N))


def ssm_scan_plain_states(x, dt, A, B_, C_, chunk) -> torch.Tensor:
    """The state entering each chunk, (B, nc, H, P, N), as the forward
    kernel leaves it in its ``states`` scratch (the carry of
    :func:`ssm_scan_plain` before each chunk)."""
    Bb, S, H, Pd = x.shape
    nc = S // chunk
    dtr = dt.reshape(Bb, nc, chunk, H)
    return _entering_states(x.reshape(Bb, nc, chunk, H, Pd), dtr,
                            B_.reshape(Bb, nc, chunk, B_.shape[-1]),
                            torch.cumsum(dtr * A, dim=2))[0]


def work(B: int, S: int, H: int, P: int, N: int, L: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one scan: each input read once and each output
    written once, in float32; the multiply-adds of C·Bᵀ (lower triangle,
    once per chunk), of the intra-chunk term, of the entering state's term
    and of the state update (the exponentials not counted)."""
    tri = L * (L + 1) // 2
    nc = S // L
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N + B * H * P * N)
    flops = 2.0 * B * nc * tri * (N + H * P) + 2 * (2.0 * B * S * H * P * N)
    return flops, float(nbytes)


def work_bwd(B: int, S: int, H: int, P: int, N: int, L: int,
             with_final: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one backward call: the multiply-adds of dy·xᵀ and
    Wᵀ·dy (lower triangles), of the entering state's gradient, B·dOwnᵀ,
    dy·entering and x·dOwn (L·P·N each, every chunk and head) and of the
    head-summed d(C·Bᵀ) against B and C; in float32, x, dt, A, B, C, dy and
    the saved entering states read once (d(final) too, ``with_final``),
    dx, ddt, dA, dB and dC written once.  The forward's y is not read."""
    tri = L * (L + 1) // 2
    nc = S // L
    flops = (2.0 * 2 * B * nc * H * tri * P + 4 * 2.0 * B * S * H * P * N
             + 2 * 2.0 * B * nc * tri * N)
    nbytes = 4 * (3 * B * S * H * P + 2 * (B * S * H + H + 2 * B * S * N)
                  + B * nc * H * P * N + with_final * B * H * P * N)
    return flops, float(nbytes)


def scratch(Bb: int, S: int, H: int, P: int, N: int, chunk: int,
            device) -> Tuple[torch.Tensor, ...]:
    """The forward's scratch, (cb, states, decay): each chunk's C·Bᵀ
    (B, nc, L, L), each chunk's state, then the state entering it (B, nc,
    H, P, N), and each chunk's cumsum of dt·A at its end (B, nc, H), all
    float32.  Under training the caller keeps them for the backward."""
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((Bb, nc, chunk, chunk), **f32), torch.empty((Bb, nc, H, P, N), **f32),
            torch.empty((Bb, nc, H), **f32))


def launch(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    chunk: int,
    y: torch.Tensor,  # (B, S, H, P) contiguous float32, written
    final: torch.Tensor,  # (B, H, P, N) contiguous float32, written
    cb: torch.Tensor,  # the scratch of :func:`scratch`, written
    states: torch.Tensor,
    decay: torch.Tensor,
) -> None:
    """Launch the CUDA kernels on x's current stream; raises on bad input or
    a refused launch."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    tensors = (("x", x), ("dt", dt), ("A", A), ("B_", B_), ("C_", C_), ("y", y),
               ("final", final))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssm_scan: {name} must be on x's CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"ssm_scan: {name} must be float32, got {t.dtype}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name} needs a contiguous last axis")
    if dt.shape != (Bb, S, H) or A.shape != (H,):
        raise ValueError(f"ssm_scan: dt{tuple(dt.shape)} / A{tuple(A.shape)} do not fit "
                         f"x{tuple(x.shape)}")
    if B_.shape != (Bb, S, N) or C_.shape != B_.shape:
        raise ValueError(f"ssm_scan: B_{tuple(B_.shape)} / C_{tuple(C_.shape)} do not fit "
                         f"x{tuple(x.shape)}")
    if y.shape != x.shape or final.shape != (Bb, H, P, N):
        raise ValueError("ssm_scan: output shapes do not fit the inputs")
    if not (y.is_contiguous() and final.is_contiguous()):
        raise ValueError("ssm_scan: outputs must be contiguous")
    if min(Bb, S, H) < 1:
        raise ValueError(f"ssm_scan: empty input x{tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssm_scan: chunk {chunk} must divide S={S} and lie in 1..{MAX_CHUNK}")
    if P < 1 or P % P_MULTIPLE:
        raise ValueError(f"ssm_scan: head dim {P} is not a multiple of {P_MULTIPLE}")
    if not 1 <= N <= MAX_STATE or N % 4:
        raise ValueError(f"ssm_scan: state size {N} is not a multiple of 4 in 4..{MAX_STATE}")
    nc = S // chunk
    for t, shape in zip((cb, states, decay), ((Bb, nc, chunk, chunk), (Bb, nc, H, P, N),
                                              (Bb, nc, H))):
        if (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"ssm_scan: scratch must be contiguous float32 {shape}")
    fn = _build.load("ssm_scan").repro_ssm_scan
    # (batch, seq) strides of x, dt, B_, C_; x's head stride on its own
    strides = _build.strides_arg([x, dt, B_, C_], (0, 1))
    # rows that start on 16-byte boundaries move 16 bytes a copy
    aligned = all(_build.rows_aligned(t, 16) for t in (x, B_, C_))
    rc = fn(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        y.data_ptr(), final.data_ptr(), cb.data_ptr(), states.data_ptr(), decay.data_ptr(),
        Bb, S, H, P, N, chunk, int(aligned), strides, x.stride(2),
        _build.stream_handle(x.device),
    )
    _build.check(rc, "ssm_scan")


def bwd_scratch(Bb: int, S: int, H: int, P: int, N: int, chunk: int,
                device) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' scratch, float32: each chunk's own state's
    gradient (B, nc, H, P, N), written once by the reverse state pass and
    read by the chunk and head-sum passes; the chunk decay's gradient in
    fixed-order sums, one per block of BWD_STATE_COLS state columns (B, nc,
    H, ceil(N / BWD_STATE_COLS)); each chunk's dA share (B, nc, H).  Nothing
    per head and per step: the heads' shares of dB and dC are summed on
    chip."""
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((Bb, nc, H, P, N), **f32),
            torch.empty((Bb, nc, H, -(-N // BWD_STATE_COLS)), **f32),
            torch.empty((Bb, nc, H), **f32))


def launch_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    chunk: int,
    cb: torch.Tensor,  # the forward's scratch (:func:`scratch`), as it left it
    states: torch.Tensor,
    decay: torch.Tensor,
    dy: torch.Tensor,  # (B, S, H, P)
    dfinal: Optional[torch.Tensor],  # (B, H, P, N), or None: the loss does not reach it
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernels on x's current stream; returns (dx, ddt,
    dA, dB_, dC_), contiguous float32.  The inputs are the forward's, with
    the forward's launch's layout checks; raises on a head dim above
    MAX_BWD_P or a refused launch."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if P > MAX_BWD_P:
        raise ValueError(f"ssm_scan backward: head dim {P} > {MAX_BWD_P}")
    dy = _build.aligned16(dy.contiguous())
    dfinal = None if dfinal is None else _build.aligned16(dfinal.contiguous())
    for name, t in (("dy", dy), ("dfinal", dfinal)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"ssm_scan backward: {name} must be float32 on x's device")
    if dy.shape != x.shape or (dfinal is not None and dfinal.shape != (Bb, H, P, N)):
        raise ValueError("ssm_scan backward: gradient shapes do not fit the outputs")
    # TMA reads boxes of 32 columns: a head dim or a state size that is not
    # a multiple of 32 runs zero-padded (zero columns add nothing to any
    # gradient), and the gradients are cut back
    Pp, Np = -(-P // BWD_BOX) * BWD_BOX, -(-N // BWD_BOX) * BWD_BOX
    if (Pp, Np) != (P, N):
        def pad(t, *widths):  # zeros after the last len(widths) dims
            return torch.nn.functional.pad(t, [a for w in reversed(widths) for a in (0, w)])

        dx, ddt, dA, dB, dC = launch_bwd(
            pad(x, Pp - P), dt, A, pad(B_, Np - N), pad(C_, Np - N), chunk, cb,
            pad(states, Pp - P, Np - N), decay, pad(dy, Pp - P),
            None if dfinal is None else pad(dfinal, Pp - P, Np - N))
        return (dx[..., :P].contiguous(), ddt, dA, dB[..., :N].contiguous(),
                dC[..., :N].contiguous())
    # TMA reads x, B_ and C_ in place: their rows must start on 16 bytes
    x, B_, C_ = (_build.aligned16(t) for t in (x, B_, C_))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, S, H, P), **f32)
    ddt = torch.empty((Bb, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((Bb, S, N), **f32)
    dC = torch.empty((Bb, S, N), **f32)
    scratch = bwd_scratch(Bb, S, H, P, N, chunk, x.device)
    fn = _build.load("ssm_scan_bwd").repro_ssm_scan_bwd
    strides = _build.strides_arg([x, dt, B_, C_], (0, 1))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(
        *(ptr(t) for t in (x, dt, A, B_, C_, cb, states, decay, dy, dfinal, dx, ddt, dA, dB, dC,
                           *scratch)),
        Bb, S, H, P, N, chunk, strides, x.stride(2), _build.stream_handle(x.device),
    )
    _build.check(rc, "ssm_scan_bwd")
    return dx, ddt, dA, dB, dC
