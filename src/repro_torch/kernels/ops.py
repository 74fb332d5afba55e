"""Public wrappers around the CUDA kernels, in model layout.

A tensor on the CPU goes to the kernel's plain PyTorch version (the tests
run there).  A tensor on a CUDA device goes to the kernel, which is built
at first use; if it cannot run, the wrapper raises.  No path falls back to
the plain version on a card.  Any other device raises.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (CPU
calls are not counted), so a run can show that its main path went through
the kernels: set the counts to 0 with :func:`reset_launches`, run, read.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention; (B, S, H, D) out."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # views, no copy
    if not _route(q, "flash_attention"):
        return _fa.flash_attention_plain(qt, kt, vt, scale, window).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _fa.launch(qt, kt, vt, out.transpose(1, 2), scale, window)
    flash_attention.launches += 1
    return out


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
    if not _route(x, "ssm_scan"):
        return _ssm.ssm_scan_plain(x, dt, A, B_, C_, chunk)
    Bb, S, H, P = x.shape
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    final = torch.empty((Bb, H, P, B_.shape[-1]), dtype=torch.float32, device=x.device)
    _ssm.launch(x, dt, A, B_, C_, chunk, y, final)
    ssm_scan.launches += 1
    return y, final


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
