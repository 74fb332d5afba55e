"""Bridge between model code and the kernel layer.

Models call :func:`causal_attention` / :func:`decode_attention` /
:func:`ssm_scan`, and each always goes through its wrapper in
:mod:`repro_torch.kernels.ops`: the CUDA kernel for tensors on a card, the
kernel's plain version on the CPU.

* ``causal_attention`` takes the flash kernel at any sequence length (the
  JAX bridge takes its kernel only when ``S % 128 == 0``; this kernel
  masks the ragged tail, so the engine's 16-token prefill buckets use it
  too).  When q's head dim differs from v's (MLA: nope + rope against
  v), it takes the reference's plain attention instead, on every device,
  as the reference routes MLA away from its kernel: the whole score
  matrix up to ``q_block`` query rows, blocked over query tiles beyond.
* ``decode_attention`` is the flat cache's decode (prefix or ring mask),
  so the flat KV backend runs the decode kernel on a card; the JAX package
  sets ``use_kernels`` on no serving path and takes its jnp einsum there.
* ``ssm_scan`` makes SSM and hybrid prefill run the scan kernel on a card;
  the JAX package's ``ssm_forward``/``ssm_prefill`` call their jnp
  ``ssd_chunked`` directly and never reach their Pallas scan.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def _naive_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, vd)
    window: Optional[int],
    scale: float,
    q_offset: int = 0,
) -> torch.Tensor:
    """The reference's plain causal attention for query rows ``q_offset``
    on: float32 scores masked with -1e30, softmax cast to v's dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    q5 = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q5, k).float() * scale
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(Skv, device=q.device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    scores = scores.masked_fill(~ok, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return o.reshape(B, Sq, H, v.shape[-1])


def causal_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, vd)
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_block: int = 1024,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, (B, S, H, vd) layout.
    Equal q and v head dims take the flash kernel; unequal ones (MLA) the
    plain path, whose score tile never exceeds ``q_block`` query rows."""
    if q.shape[-1] == v.shape[-1]:
        return ops.flash_attention(q, k, v, window=window, scale=scale)
    if hasattr(q, "device_mesh"):  # DTensors: heads and batch shard, as flash's do
        return ops.on_shards(lambda q, k, v: causal_attention(q, k, v, window, scale, q_block),
                             (q, k, v), ((0, 2),) * 3, ((0, 2),))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    S = q.shape[1]
    if S <= q_block:
        return _naive_attention(q, k, v, window, scale)
    return torch.cat([
        _naive_attention(q[:, i:i + q_block], k, v, window, scale, q_offset=i)
        for i in range(0, S, q_block)
    ], dim=1)


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
