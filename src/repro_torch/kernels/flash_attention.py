"""Causal prefill attention: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas
``flash_attention_bhsd``: f32 online softmax over kv tiles up to the causal
limit, optional sliding window (``kj > qi - window``), GQA by ``h // G``;
bf16 runs its products on the tensor cores (P rounded to bf16 before P·V),
float32 on the CUDA cores.  Which kernel runs is :func:`variant`: bf16 at
head dim 64 or 128 (every full-width model) on Hopper's warpgroup products
(``wgmma``, operands brought by TMA), bf16 at 16 or 32 (smoke configs) on
``mma.sync``, float32 on the CUDA cores.
It reads q/k/v through their strides, so the model layout needs no copy,
and masks the ragged tail, so any ``S`` works; a q whose rows TMA cannot
read (not 16-byte aligned: a view into a wider tensor) gets an aligned
copy.

Under training the forward also writes each query row's log-sum-exp, and
the backward (``csrc/flash_attention_bwd.cu``, FA2-style) recomputes P a
tile at a time from it: Δ = rowsum(dO ⊙ O), then dK/dV by key tile and dQ
by query tile, each written once (no atomics, so the result is
deterministic).  The JAX package has no backward kernel: its training
differentiates the jnp attention; :func:`flash_attention_bwd_plain` writes
the same gradients out in plain PyTorch.

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
# rows of the backward's padded lse and Δ scratch: S rounded up to this
# (csrc/flash_attention_bwd.cu: padded_rows)
BWD_PAD = 64


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel the C entry points choose for a dtype and head dim, as
    ``chip_smoke.py`` names it: "wgmma" (bf16, D 64 or 128), "mma_sync"
    (bf16, D 16 or 32) or "f32"."""
    if dtype != torch.bfloat16:
        return "f32"
    return "wgmma" if head_dim in (64, 128) else "mma_sync"


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
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores, _ = _masked_scores(q, k, scale, window)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def _masked_scores(q, k, scale, window):
    """float32 scale·q·kᵀ over (B, KV, G, S, S), masked with -1e30, and the
    mask."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    q5 = q.reshape(B, KV, H // KV, S, D).float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", q5, k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return scores.masked_fill(~ok, NEG_INF), ok


def flash_attention_plain_lse(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain`'s output and each query row's float32
    log-sum-exp of its masked scores, (B, H, S): what the forward kernel
    writes under training."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores, _ = _masked_scores(q, k, scale, window)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype), lse.reshape(B, H, S)


def flash_attention_bwd_plain(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, H, S, D): the forward's output
    lse: torch.Tensor,  # (B, H, S) float32: the forward's log-sum-exp
    dout: torch.Tensor,  # (B, H, S, D)
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's formulas in plain PyTorch over the whole
    (S, S) matrix (not autograd): P = exp(S - lse), Δ = rowsum(dO ⊙ O),
    dV = Σ_g Pᵀ dO, dS = P ⊙ (dO Vᵀ - Δ), dQ = scale · dS K,
    dK = scale · Σ_g dSᵀ Q; float32 throughout, each gradient cast to its
    input's dtype."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores, ok = _masked_scores(q, k, scale, window)
    p = torch.exp(scores - lse.reshape(B, KV, G, S, 1).float()) * ok
    do5 = dout.reshape(B, KV, G, S, D).float()
    delta = (do5 * out.reshape(B, KV, G, S, D).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do5)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", do5, v.float()) - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.reshape(B, KV, G, S, D).float()) * scale
    return dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def work_bwd(B: int, S: int, H: int, KV: int, D: int, window: Optional[int],
             dbytes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one backward call: the multiply-adds of Q·Kᵀ
    (recomputed), dO·Vᵀ, Pᵀ·dO, dS·K and dSᵀ·Q over the causal (windowed)
    pairs, 2.5 times the forward's; q, k, v, out and dO read once, the
    float32 lse read, dq, dk and dv written once."""
    return (10.0 * B * H * D * causal_pairs(S, window),
            float(B * S * (4 * H + 4 * KV) * D * dbytes + 4 * B * H * S))


def _check(what: str, named, q: torch.Tensor, k: torch.Tensor, window: Optional[int],
           lse: Optional[torch.Tensor]) -> None:
    """Raise unless the ``named`` operands ((name, tensor) pairs) share q's
    CUDA device and dtype with a contiguous head dim, and the dtype, head
    dim, heads, window and ``lse`` (when given) fit the kernels."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    for name, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on q's CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} dtype {t.dtype} != {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous head_dim")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"{what}: {H} heads not a multiple of {KV} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")
    if lse is not None and (lse.shape != (B, H, S) or lse.dtype != torch.float32
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"{what}: lse must be a contiguous float32 (B, H, S) tensor on "
                         "q's device")


def launch(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, H, S, D), written
    scale: float,
    window: Optional[int],
    lse: Optional[torch.Tensor] = None,  # (B, H, S) contiguous float32, written
) -> None:
    """Launch the CUDA kernel on q's current stream (writing each row's
    log-sum-exp into ``lse`` when given); raises on bad input or a refused
    launch.  q rows that are not 16-byte aligned (a view into a wider
    tensor) are read from an aligned copy: TMA reads whole 16-byte units."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    _check("flash_attention", (("q", q), ("k", k), ("v", v), ("out", out)), q, k, window, lse)
    if k.shape != (B, KV, S, D) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(
            f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} out{tuple(out.shape)}"
        )
    q = _build.aligned16(q)
    # k and v are read as 16-byte units; the bf16 kernels store pairs of out
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
        lse.data_ptr() if lse is not None else None,
        _build.stream_handle(q.device),
    )
    _build.check(rc, "flash_attention")


def launch_bwd(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, H, S, D): the forward's output
    lse: torch.Tensor,  # (B, H, S) float32: the forward's log-sum-exp
    dout: torch.Tensor,  # (B, H, S, D)
    dq: torch.Tensor,  # (B, H, S, D), written
    dk: torch.Tensor,  # (B, KV, S, D), written
    dv: torch.Tensor,
    scale: float,
    window: Optional[int],
) -> None:
    """Launch the backward kernels (Δ, then dK/dV, then dQ) on q's current
    stream; raises on bad input or a refused launch.  Every operand's rows
    must be 16-byte aligned (the wrapper passes contiguous copies of any
    that are not).  The kernels' float32 scratch (Δ, and at bf16 D 64/128
    also lse in log2 units, both padded to :data:`BWD_PAD` rows) is
    allocated here."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("dq", dq),
             ("dk", dk), ("dv", dv))
    _check("flash_attention_bwd", named, q, k, window, lse)
    if (k.shape != (B, KV, S, D) or v.shape != k.shape or dk.shape != k.shape
            or dv.shape != k.shape or any(t.shape != q.shape for t in (out, dout, dq))):
        raise ValueError("flash_attention_bwd: shapes do not fit q and k")
    for name, t in named:
        if not _build.rows_aligned(t, 16):
            raise ValueError(f"flash_attention_bwd: {name} rows are not 16-byte aligned")
    S_pad = -(-S // BWD_PAD) * BWD_PAD
    scratch = torch.empty(2 * B * H * S_pad, dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
    # (batch, seq, head) strides of the eight operands: dims 0, 2, 1 of bhsd
    strides = _build.strides_arg([q, k, v, out, dout, dq, dk, dv], (0, 2, 1))
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, S, H, KV, D, strides, float(scale),
        int(window) if window is not None else 0, _build.stream_handle(q.device),
    )
    _build.check(rc, "flash_attention_bwd")
