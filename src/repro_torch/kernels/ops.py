"""Public wrappers around the CUDA kernels, in model layout.

A tensor on the CPU goes to the kernel's plain PyTorch version (the tests
run there).  A tensor on a CUDA device goes to the kernel, which is built
at first use; if it cannot run, the wrapper raises.  No path falls back to
the plain version on a card.  Any other device raises.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (CPU
calls are not counted), so a run can show that its main path went through
the kernels: set the counts to 0 with :func:`reset_launches`, run, read.

Training reaches two of the kernels, flash attention and the SSD scan.
When grad mode is on and an input requires grad, their wrappers on a card
go through :class:`PlainGradient`: the forward is the kernel, exactly as
without grad, and the backward is the gradient of the kernel's plain
version, recomputed from the saved inputs (the reference has no backward
kernel either: its training differentiates its jnp path).  Without grad
they launch the kernel directly.  On the CPU the plain versions are
differentiable as they stand.  The two decode kernels have no gradient,
and their wrappers raise under grad rather than return an output that
autograd cannot differentiate.  Under activation checkpointing the
forward runs twice, and so counts two launches.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssm_scan as _ssm


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def _wants_grad(*inputs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def _refuse_grad(what: str, *inputs: torch.Tensor) -> None:
    """Raise where autograd would need a gradient that the kernel lacks."""
    if _wants_grad(*inputs):
        raise RuntimeError(f"{what} has no gradient: call it under torch.no_grad()")


class PlainGradient(torch.autograd.Function):
    """``kernel(*inputs)`` forward, the gradient of ``plain(*inputs)``
    backward.  ``kernel`` and ``plain`` compute one function of the tensor
    ``inputs`` (one output or a tuple); only the inputs are saved, and the
    backward recomputes ``plain`` on them under grad, one call at a time.
    Outputs that the loss does not reach (the scan's final state in
    training) get no gradient and cost nothing."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs: torch.Tensor):
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True) if pairs and wanted else ())
        return (None, None) + tuple(next(got, None) if x.requires_grad else None
                                    for x in inputs)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention; (B, S, H, D) out."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])

    def plain(q, k, v):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # views, no copy
        return _fa.flash_attention_plain(qt, kt, vt, scale, window).transpose(1, 2)

    def kernel(q, k, v):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _fa.launch(*(x.transpose(1, 2) for x in (q, k, v, out)), scale, window)
        flash_attention.launches += 1
        return out

    if not _route(q, "flash_attention"):
        return plain(q, k, v)
    if _wants_grad(q, k, v):
        return PlainGradient.apply(kernel, plain, q, k, v)
    return kernel(q, k, v)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) — model layout
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) bool — per-request validity (prefix or ring)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode over the flat cache; (B, 1, H, D) out.  A row with
    no valid entry gives zeros."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _refuse_grad("decode_attention", q, k, v)
    q3 = q[:, 0]
    if not _route(q, "decode_attention"):
        return _dec.decode_attention_plain(q3, k, v, valid, scale)[:, None]
    out = torch.empty(q3.shape, dtype=q.dtype, device=q.device)
    _dec.launch(q3, k, v, valid, out, scale)
    decode_attention.launches += 1
    return out[:, None]


def paged_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) — model layout
    pool_k: torch.Tensor,  # (num_pages, page_size, KV, D)
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,  # (B,) int32 — valid tokens per request
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode over the paged pool; (B, 1, H, D) out."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _refuse_grad("paged_decode_attention", q, pool_k, pool_v)
    q3 = q[:, 0]
    if not _route(q, "paged_decode_attention"):
        return _paged.paged_decode_attention_plain(
            q3, pool_k, pool_v, page_tables, lengths, scale
        )[:, None]
    out = torch.empty(q3.shape, dtype=q.dtype, device=q.device)
    _paged.launch(q3, pool_k, pool_v, page_tables, lengths, out, scale)
    paged_decode_attention.launches += 1
    return out[:, None]


def ssm_scan(
    x: torch.Tensor,  # (B, S, H, P) float32
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan; returns y (B, S, H, P) and the final state
    (B, H, P, N), both float32.  A sequence shorter than ``chunk`` is one
    chunk, as in the Pallas wrapper; otherwise ``S % chunk`` must be 0."""
    chunk = min(chunk, x.shape[1])

    def plain(x, dt, A, B_, C_):
        return _ssm.ssm_scan_plain(x, dt, A, B_, C_, chunk)

    def kernel(x, dt, A, B_, C_):
        Bb, S, H, P = x.shape
        y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
        final = torch.empty((Bb, H, P, B_.shape[-1]), dtype=torch.float32, device=x.device)
        _ssm.launch(x, dt, A, B_, C_, chunk, y, final)
        ssm_scan.launches += 1
        return y, final

    if not _route(x, "ssm_scan"):
        return plain(x, dt, A, B_, C_)
    if _wants_grad(x, dt, A, B_, C_):
        return PlainGradient.apply(kernel, plain, x, dt, A, B_, C_)
    return kernel(x, dt, A, B_, C_)


decode_attention.launches = 0
flash_attention.launches = 0
paged_decode_attention.launches = 0
ssm_scan.launches = 0

WRAPPERS = (decode_attention, flash_attention, paged_decode_attention, ssm_scan)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
