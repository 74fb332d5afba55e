"""Paged one-token decode attention: the CUDA kernel's launcher and its plain
version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas
``paged_decode_attention``: per request, f32 online softmax over its first
``lengths[b]`` tokens, read page by page through its page table; query head
``h`` reads KV head ``h // G``; a ``length == 0`` row gives zeros; page id 0
is a legal dummy in unused table cells.  The table's width is cut into
splits that run as separate blocks, and a second launch merges their
partials (flash-decoding, as the flat decode does).  bf16 runs its products
on the tensor cores in 64-token tiles, float32 on the CUDA cores in
32-token tiles.

Layouts (the reference kernel's):
  q               : (B, H, D), any strides with a contiguous D
  pool_k / pool_v : (num_pages, page_size, KV, D), contiguous
  page_tables     : (B, max_pages) int32
  lengths         : (B,) int32
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    MMA_TILE, TILE, sm_count, decode_attention_plain, splits_for,
)

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64  # query heads per kv head the kernel takes (4 warps x 16 heads)


# Splits enough for B * KV * splits blocks to fill the card about this many
# times: requests of ragged lengths then spread over the SMs more evenly
# than in one wave (chip_smoke.py phase 3 times both) ...
PAGED_WAVES = 4
# ... but no split shorter than two tiles: the merge's cost grows with the
# number of splits, and a one-tile split saves too little to pay for it.
MIN_SPLIT_TILES = 2


def work(B: int, tokens: int, H: int, KV: int, D: int, dbytes: int,
         table_entries: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call over ``tokens`` valid tokens in all: their
    k/v rows, the page table and the lengths read once, q read and the
    output written once."""
    return (4.0 * tokens * H * D,
            float((2 * tokens * KV * D + 2 * B * H * D) * dbytes + table_entries * 4 + B * 4))


def paged_splits(B: int, KV: int, max_pages: int, page_size: int, sm_count: int,
                 dtype: torch.dtype) -> Tuple[int, int]:
    """(splits, split_len) over the page table's width, ``max_pages *
    page_size`` tokens: from shapes alone, never from ``lengths`` (they
    live on the card, and reading them would sync the host every step)."""
    tile = MMA_TILE if dtype == torch.bfloat16 else TILE
    width = max_pages * page_size
    splits, split_len = splits_for(B, KV, width, PAGED_WAVES * sm_count, tile)
    if split_len < MIN_SPLIT_TILES * tile:
        split_len = MIN_SPLIT_TILES * tile
        splits = -(-width // split_len)
    return splits, split_len


def paged_decode_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    pool_k: torch.Tensor,  # (num_pages, page_size, KV, D)
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,  # (B,) int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The same function in plain PyTorch: gather each request's pages into a
    flat cache, then the flat decode's plain version over its first
    ``lengths[b]`` rows.  Rows with ``length == 0`` give zeros, as the
    kernels do (a softmax over nothing but masked scores would average
    every gathered row instead)."""
    B = q.shape[0]
    _, page_size, KV, D = pool_k.shape
    S = page_tables.shape[1] * page_size
    pt = page_tables.long()
    k = pool_k[pt].reshape(B, S, KV, D)
    v = pool_v[pt].reshape(B, S, KV, D)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    return decode_attention_plain(q, k, v, valid, scale)


def launch(
    q: torch.Tensor,  # (B, H, D)
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    lengths: torch.Tensor,
    out: torch.Tensor,  # (B, H, D) contiguous, written
    scale: float,
) -> None:
    """Launch the CUDA kernels (splits, then merge) on q's current stream;
    raises on bad input or a refused launch."""
    B, H, D = q.shape
    num_pages, page_size, KV, Dk = pool_k.shape
    max_pages = page_tables.shape[1]
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("page_tables", page_tables), ("lengths", lengths), ("out", out)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} must be on q's CUDA device")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v), ("out", out)):
        if t.dtype != q.dtype:
            raise ValueError(f"paged_decode_attention: {name} dtype {t.dtype} != {q.dtype}")
    for name, t in (("page_tables", page_tables), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"paged_decode_attention: {name} must be int32")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v), ("page_tables", page_tables),
                    ("lengths", lengths), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    if q.stride(-1) != 1:
        raise ValueError("paged_decode_attention: q needs a contiguous head_dim")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"paged_decode_attention: dtype {q.dtype} not supported")
    if D not in HEAD_DIMS or Dk != D:
        raise ValueError(f"paged_decode_attention: head_dim {D}/{Dk} not in {HEAD_DIMS}")
    if pool_v.shape != pool_k.shape or out.shape != q.shape:
        raise ValueError("paged_decode_attention: pool/out shapes disagree")
    if page_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_decode_attention: page_tables/lengths batch != q batch")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):  # read as 16-byte chunks
        if not _build.rows_aligned(t, 16):
            raise ValueError(f"paged_decode_attention: {name} is not 16-byte aligned")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: {H} heads over {KV} kv heads unsupported")
    splits, split_len = paged_splits(B, KV, max_pages, page_size, sm_count(q.device),
                                     q.dtype)
    # one scratch allocation a call: m and l (B, H, splits), acc (B, H, splits, D)
    n = B * H * splits
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    part_m, part_l, part_acc = part[:n], part[n:2 * n], part[2 * n:]
    fn = _build.load("paged_attention").repro_paged_decode_attention
    rc = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_tables.data_ptr(), lengths.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, H, KV, D, page_size, max_pages, split_len, splits,
        q.stride(0), q.stride(1), float(scale),
        _build.stream_handle(q.device),
    )
    _build.check(rc, "paged_decode_attention")
