"""Flat-cache one-token decode attention: the CUDA kernel's launcher and its
plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas
``decode_attention_bhd``: per request, a float32 online softmax over the
cache rows its ``(B, S)`` mask marks valid (a prefix, or a ring cache's
live slots); query head ``h`` reads KV head ``h // G``; a row with no
valid entry gives zeros.  The sequence is cut into splits that run as
separate blocks, and a second launch merges their partials
(flash-decoding).  bf16 runs its products on the tensor cores in 64-token
tiles, float32 on the CUDA cores in 32-token tiles.

Layouts (the reference kernel's, with a bool mask):
  q     : (B, H, D), any strides with a contiguous D
  k / v : (B, S, KV, D), the same strides, contiguous D
  valid : (B, S) bool, contiguous S
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64  # query heads per kv head the kernels take (4 tiles of 16 rows)
TILE = 32  # tokens per tile of the float32 kernel; a split is a whole number of tiles
MMA_TILE = 64  # tokens per tile of the bf16 (tensor-core) kernel


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) bool (or 0/1)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: a float32 masked softmax.  A row
    with no valid entry gives zeros, as the kernel does (a softmax over
    nothing but masked scores would average every row of v instead)."""
    B, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ok = valid.bool()
    q4 = q.reshape(B, KV, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", q4, k.float()) * scale
    scores = scores.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()).reshape(B, H, D)
    o = o.masked_fill(~ok.any(dim=-1)[:, None, None], 0.0)
    return o.to(q.dtype)


def work(B: int, S: int, H: int, KV: int, D: int, dbytes: int,
         rows: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call over ``rows`` valid cache rows in all
    (default: every row, ``B * S``): the valid k/v rows and the mask read
    once, q read and the output written once."""
    rows = B * S if rows is None else rows
    return (4.0 * rows * H * D,
            float(2 * rows * KV * D * dbytes + B * S + 2 * B * H * D * dbytes))


def splits_for(B: int, KV: int, S: int, sm_count: int, tile: int = TILE) -> Tuple[int, int]:
    """(splits, split_len): enough splits that B * KV * splits blocks about
    fill the card once, each a whole number of ``tile``-token tiles."""
    want = max(1, -(-sm_count // (B * KV)))
    split_len = -(-S // want)
    split_len = -(-split_len // tile) * tile
    return -(-S // split_len), split_len


_SM_COUNT = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[device]


def launch(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) bool
    out: torch.Tensor,  # (B, H, D) contiguous, written
    scale: float,
) -> None:
    """Launch the CUDA kernels (splits, then merge) on q's current stream;
    raises on bad input or a refused launch."""
    B, H, D = q.shape
    Bk, S, KV, Dk = k.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid), ("out", out)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be on q's CUDA device")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype} != {q.dtype}")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported")
    if valid.dtype != torch.bool:
        raise ValueError("decode_attention: valid must be a bool mask")
    if D not in HEAD_DIMS or Dk != D:
        raise ValueError(f"decode_attention: head_dim {D}/{Dk} not in {HEAD_DIMS}")
    if Bk != B or v.shape != k.shape or valid.shape != (B, S) or out.shape != q.shape:
        raise ValueError("decode_attention: q/k/v/valid/out shapes disagree")
    if S < 1:
        raise ValueError("decode_attention: empty cache")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: {H} heads over {KV} kv heads unsupported")
    if q.stride(-1) != 1 or valid.stride(-1) != 1 or not out.is_contiguous():
        raise ValueError("decode_attention: q, valid need a contiguous last axis, out "
                         "contiguous")
    if v.stride() != k.stride() or k.stride(-1) != 1:
        raise ValueError("decode_attention: k and v need equal strides and a contiguous "
                         "head_dim")
    for name, t in (("k", k), ("v", v)):  # read as 16-byte chunks
        if not _build.rows_aligned(t, 16):
            raise ValueError(f"decode_attention: {name} is not 16-byte aligned")
    tile = MMA_TILE if q.dtype == torch.bfloat16 else TILE
    splits, split_len = splits_for(B, KV, S, sm_count(q.device), tile)
    part_m = torch.empty((B, H, splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, splits, D), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attention").repro_decode_attention
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, H, KV, S, D, split_len, splits,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2), valid.stride(0),
        float(scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "decode_attention")
