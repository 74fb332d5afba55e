"""RMSNorm and split-half rotary embedding, one pass each: the CUDA kernels'
launchers, their plain versions and their work.

The kernels (``csrc/norm_rope.cu``) replace no Pallas kernel: the JAX
package writes its norms and rotary as jnp and leaves them to XLA, and the
port ran them as chains of PyTorch elementwise ops
(:func:`repro_torch.models.common.rmsnorm`, ``apply_rope``).  Both are
bound by bytes; the serving paths call them through
:func:`repro_torch.kernels.ops.rmsnorm` and :func:`~repro_torch.kernels.ops.rope`.

* ``rmsnorm``: each row of ``D`` elements read once, its sum of squares
  reduced in float32 within the block, written once; behind a residual add
  the rounded sum ``residual + x`` is also written, as the new residual
  stream.  The rounding is the plain version's; only the order of the sum
  of squares differs.
* ``rope``: q (B, S, H, hd) and k (B, S, KV, hd) rotated in place in one
  launch, the angles computed on the device from the (B, S) int64
  positions, with the plain version's rounding.

Layouts: a norm's rows with a unit last stride and one stride between rows
(any tensor that reshapes to (rows, D) as a view; else a copy is made),
``w`` (D,) contiguous, outputs contiguous; rope's q and k with a
contiguous head dim and any other strides.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.common import apply_rope, rmsnorm


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float,
                  residual: Optional[torch.Tensor] = None):
    """``rmsnorm(x, w, eps)``, or with ``residual`` (rmsnorm(residual + x),
    residual + x): the ops the model ran before the kernel."""
    if residual is None:
        return rmsnorm(x, w, eps)
    s = residual + x
    return rmsnorm(s, w, eps), s


def rope_plain(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_rope`` of q and of k, as new tensors."""
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def work_rmsnorm(rows: int, D: int, dbytes: int, residual: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one norm of ``rows`` rows: x read and the output
    written once, the weight read once; with a residual, the residual read
    and the sum written besides (and one add an element)."""
    n = rows * D
    return float(n * (5 if residual else 4)), float(dbytes * (n * (4 if residual else 2) + D))


def work_rope(tokens: int, H: int, KV: int, hd: int, dbytes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one rotary call: q and k read and written once,
    each token's int64 position read once; four products and two sums a
    pair of elements."""
    n = tokens * (H + KV) * hd
    return float(3 * n), float(2 * n * dbytes + 8 * tokens)


def _rows(t: torch.Tensor, D: int) -> torch.Tensor:
    """``t`` as (rows, D) with a unit last stride: a view where one exists."""
    t2 = t.reshape(-1, D)
    return t2 if t2.stride(1) == 1 else t2.contiguous()


def launch_rmsnorm(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    out: torch.Tensor,  # x's shape, contiguous, written
    eps: float,
    residual: Optional[torch.Tensor] = None,  # x's shape
    sum_out: Optional[torch.Tensor] = None,  # x's shape, contiguous, written with residual
) -> None:
    """Launch the norm on x's current stream; raises on bad input or a
    refused launch."""
    D = x.shape[-1]
    args = [("x", x), ("w", w), ("out", out)]
    if residual is not None:
        args += [("residual", residual), ("sum_out", sum_out)]
    for name, t in args:
        if t is None or t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"rmsnorm: {name} must be on x's CUDA device")
        if t.dtype != x.dtype:
            raise ValueError(f"rmsnorm: {name} dtype {t.dtype} != {x.dtype}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"rmsnorm: dtype {x.dtype} not supported")
    if w.shape != (D,) or not w.is_contiguous():
        raise ValueError(f"rmsnorm: w must be ({D},) and contiguous, got {tuple(w.shape)}")
    for name, t in (("out", out), ("sum_out", sum_out), ("residual", residual)):
        if t is not None and t.shape != x.shape:
            raise ValueError(f"rmsnorm: {name} shape {tuple(t.shape)} != {tuple(x.shape)}")
    for name, t in (("out", out), ("sum_out", sum_out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    x2 = _rows(x, D)
    r2 = None if residual is None else _rows(residual, D)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _build.load("norm_rope").repro_rmsnorm(
        x2.data_ptr(), ptr(r2), w.data_ptr(), out.data_ptr(), ptr(sum_out),
        _build.DTYPE_CODES[x.dtype], x2.shape[0], D, x2.stride(0),
        0 if r2 is None else r2.stride(0), float(eps), _build.stream_handle(x.device),
    )
    _build.check(rc, "rmsnorm")


def launch_rope(
    q: torch.Tensor,  # (B, S, H, hd), rotated in place
    k: torch.Tensor,  # (B, S, KV, hd), rotated in place
    positions: torch.Tensor,  # (B, S) int64 (or broadcast to it)
    theta: float,
) -> None:
    """Launch the rotary on q's current stream; raises on bad input or a
    refused launch."""
    B, S, H, hd = q.shape
    for name, t in (("k", k), ("positions", positions)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"rope: {name} must be on q's CUDA device")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype:
        raise ValueError(f"rope: dtypes {q.dtype}/{k.dtype} not supported")
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"rope: k shape {tuple(k.shape)} does not match q's {tuple(q.shape)}")
    if hd % 2 or hd > 2048:
        raise ValueError(f"rope: head dim {hd} must be even and at most 2048")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("rope: q and k need a contiguous head dim")
    if positions.dtype != torch.int64:
        raise ValueError(f"rope: positions must be int64, got {positions.dtype}")
    if B > 65535:
        raise ValueError(f"rope: batch {B} over 65,535")
    pos = positions.expand(B, S)
    vals = [t.stride(d) for t in (q, k) for d in (0, 1, 2)] + [pos.stride(0), pos.stride(1)]
    rc = _build.load("norm_rope").repro_rope(
        q.data_ptr(), k.data_ptr(), pos.data_ptr(), _build.DTYPE_CODES[q.dtype],
        B, S, H, k.shape[2], hd, (ctypes.c_int64 * 8)(*vals), float(theta),
        _build.stream_handle(q.device),
    )
    _build.check(rc, "rope")
