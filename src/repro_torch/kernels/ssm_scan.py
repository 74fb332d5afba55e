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

Layouts (the reference kernel's), all float32:
  x      : (B, S, H, P), any batch/seq/head strides, contiguous P
  dt     : (B, S, H) post-softplus, contiguous H
  A      : (H,) negative
  B_, C_ : (B, S, N), one group shared by every head, contiguous N
Returns y (B, S, H, P) and the final state (B, H, P, N).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128  # steps per chunk the kernel stages in shared memory
P_MULTIPLE = 16  # the head dim is a whole number of 16-row tensor-core tiles
MAX_STATE = 256  # state size N the kernel's shared-memory budget holds


def _clip_exp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(t, -60.0, 0.0))


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

    # per-chunk summary state
    last = dA_cs[:, :, -1:, :]  # (B,nc,1,H)
    seg = _clip_exp(last - dA_cs)  # decay from step j to the chunk's end
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", seg * dtr, Br, xr)  # (B,nc,H,P,N)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = _clip_exp(last[:, :, 0, :])  # (B,nc,H)
    carry = torch.zeros((Bb, H, Pd, N), dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cr, prev_states) * _clip_exp(dA_cs)[..., None]
    return (y_intra + y_inter).reshape(Bb, S, H, Pd), carry


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


def launch(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    chunk: int,
    y: torch.Tensor,  # (B, S, H, P) contiguous float32, written
    final: torch.Tensor,  # (B, H, P, N) contiguous float32, written
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
    # scratch, L2-resident at the models' shapes: C·Bᵀ of each chunk, each
    # chunk's state (then the state entering it), each chunk's cumsum of dt·A
    cb = torch.empty((Bb, nc, chunk, chunk), dtype=torch.float32, device=x.device)
    states = torch.empty((Bb, nc, H, P, N), dtype=torch.float32, device=x.device)
    decay = torch.empty((Bb, nc, H), dtype=torch.float32, device=x.device)
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
