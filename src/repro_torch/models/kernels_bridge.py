"""Bridge between model code and the kernel layer.

Models call :func:`causal_attention` / :func:`decode_attention` /
:func:`ssm_scan`.  ``causal_attention`` always goes through :func:`repro_torch.kernels.ops.flash_attention`:
the CUDA kernel for tensors on a card, at any sequence length (the JAX
bridge takes its kernel only when ``S % 128 == 0``; this kernel masks the
ragged tail, so the engine's 16-token prefill buckets use it too), and the
kernel's plain version on the CPU.  ``decode_attention`` is the plain flat
decode the flat KV backend uses, as in the JAX package.  ``ssm_scan``
always goes through :func:`repro_torch.kernels.ops.ssm_scan`, so SSM and
hybrid prefill run the scan kernel on a card; the JAX package's
``ssm_forward``/``ssm_prefill`` call their jnp ``ssd_chunked`` directly
and never reach their Pallas scan.

GQA grouping (H = KV·G) is handled here so both backends see the same
contract.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    B, S, H, hd = q.shape
    return q.reshape(B, S, kv_heads, H // kv_heads, hd)


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
    valid: torch.Tensor,  # (B, S) bool — per-request ragged validity
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, _, H, hd = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q5 = _grouped(q, KV)  # (B,1,KV,G,hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q5, k).float() * scale
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return o.reshape(B, 1, H, v.shape[-1])


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
