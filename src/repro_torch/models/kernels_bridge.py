"""Bridge between model code and the kernel layer.

Models call :func:`causal_attention` / :func:`decode_attention` /
:func:`ssm_scan`, and each always goes through its wrapper in
:mod:`repro_torch.kernels.ops`: the CUDA kernel for tensors on a card, the
kernel's plain version on the CPU.

* ``causal_attention`` takes the flash kernel at any sequence length (the
  JAX bridge takes its kernel only when ``S % 128 == 0``; this kernel
  masks the ragged tail, so the engine's 16-token prefill buckets use it
  too).
* ``decode_attention`` is the flat cache's decode (prefix or ring mask),
  so the flat KV backend runs the decode kernel on a card; the JAX package
  sets ``use_kernels`` on no serving path and takes its jnp einsum there.
* ``ssm_scan`` makes SSM and hybrid prefill run the scan kernel on a card;
  the JAX package's ``ssm_forward``/``ssm_prefill`` call their jnp
  ``ssd_chunked`` directly and never reach their Pallas scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def causal_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, (B, S, H, hd) layout."""
    if q.shape[-1] != v.shape[-1]:
        raise NotImplementedError("q and v head dims differ (MLA is not ported)")
    return ops.flash_attention(q, k, v, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    valid: torch.Tensor,  # (B, S) bool — per-request validity (prefix or ring)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token GQA decode over a flat cache, (B, 1, H, hd) out; a row with
    no valid entry gives zeros (the JAX einsum averages v there)."""
    return ops.decode_attention(q, k, v, valid, scale=scale)


def ssm_scan(
    x: torch.Tensor,  # (B, S, H, P) float32
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked scan; returns (y (B,S,H,P), final state (B,H,P,N))."""
    return ops.ssm_scan(x, dt, A, B_, C_, chunk)
