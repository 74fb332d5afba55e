"""Causal prefill attention: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas
``flash_attention_bhsd``: f32 online softmax over kv tiles up to the causal
limit, optional sliding window (``kj > qi - window``), GQA by ``h // G``;
bf16 runs its products on the tensor cores (P rounded to bf16 before P·V),
float32 on the CUDA cores.
It reads q/k/v through their strides, so the model layout needs no copy,
and masks the ragged tail, so any ``S`` works.

Layouts here are the reference kernel's: q (B, H, S, D); k/v (B, KV, S, D)
(any strides with a contiguous ``D``).  :mod:`repro_torch.kernels.ops`
holds the public wrapper in model layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: float32 scores over the full
    (S, S) matrix, masked with -1e30, softmax, cast to q's dtype."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q5 = q.reshape(B, KV, G, S, D).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", q5, k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    scores = scores.masked_fill(~ok, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def causal_pairs(S: int, window: Optional[int]) -> int:
    """The (query, key) pairs a causal query row sees, over all ``S`` rows:
    ``min(i + 1, window)`` for row ``i``."""
    W = S if window is None else min(window, S)
    return W * (W + 1) // 2 + (S - W) * W


def work(B: int, S: int, H: int, KV: int, D: int, window: Optional[int],
         dbytes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call: the multiply-adds of q·kᵀ and p·v over
    the causal (windowed) pairs; q, k, v read once and the output written
    once."""
    return (4.0 * B * H * D * causal_pairs(S, window),
            float(B * S * (2 * H + 2 * KV) * D * dbytes))


def launch(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, H, S, D), written
    scale: float,
    window: Optional[int],
) -> None:
    """Launch the CUDA kernel on q's current stream; raises on bad input or
    a refused launch."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} dtype {t.dtype} != {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous head_dim")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, KV, S, D) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(
            f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} out{tuple(out.shape)}"
        )
    if H % KV:
        raise ValueError(f"flash_attention: {H} heads not a multiple of {KV} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    # k and v are read as 16-byte chunks; the bf16 kernel stores pairs of out
    for name, t, n in (("k", k, 16), ("v", v, 16), ("out", out, 4)):
        if not _build.rows_aligned(t, n):
            raise ValueError(f"flash_attention: {name} rows are not {n}-byte aligned")
    fn = _build.load("flash_attention").repro_flash_attention
    # (batch, seq, head) strides of q, k, v, out: dims 0, 2, 1 of bhsd
    strides = _build.strides_arg([q, k, v, out], (0, 2, 1))
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, S, H, KV, D, strides, float(scale),
        int(window) if window is not None else 0,
        _build.stream_handle(q.device),
    )
    _build.check(rc, "flash_attention")
