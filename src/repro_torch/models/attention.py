"""Attention: GQA (with qk-norm and RoPE) with prefill, flat decode (full
or sliding-window ring cache) and paged decode; and MLA (DeepSeek's
multi-head latent attention) with prefill and a weight-absorbed decode
over the flat or ring latent cache.

The port of the JAX package's ``models/attention.py``.
``gqa_forward`` and ``mla_forward`` are the cacheless training forwards.
Decode is *ragged*: ``pos`` is a per-request ``(B,)`` vector of positions,
and negative positions mark idle slots, which leave their cache rows as
they were (:func:`~repro_torch.models.common.write_rows`; the paged decode
sends their writes to a sink page instead).

JAX returns new cache arrays; here the caches are updated **in place**,
which is what lets a 36-layer page pool stay one allocation.  The
functions still return the cache dict, so the call sites read like the
reference.

Caches carry no layer axis here; the transformer stacks them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import kernels_bridge
from repro_torch.kernels import ops
from repro_torch.models.common import (
    ParamSpec, PartitionSpec, apply_rope, constrain, rmsnorm, split_heads, write_rows,
)
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs: Dict[str, ParamSpec] = {
        "wq": ((d, H * hd), "normal", None, (None, "model")),
        "wk": ((d, KV * hd), "normal", None, (None, "model")),
        "wv": ((d, KV * hd), "normal", None, (None, "model")),
        "wo": ((H * hd, d), "normal", None, ("model", None)),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ((hd,), "ones", None, (None,))
        specs["k_norm"] = ((hd,), "ones", None, (None,))
    return specs


def _gqa_project(
    p: Params, cfg: ModelConfig, x: torch.Tensor, norm
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v split into heads, q and k normed by ``norm`` under
    ``qk_norm``."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(x @ p["wq"], H, hd)
    k = split_heads(x @ p["wk"], KV, hd)
    v = split_heads(x @ p["wv"], KV, hd)
    if cfg.qk_norm:
        q = norm(q, p["q_norm"], cfg.norm_eps)
        k = norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_qkv(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training path's q, k, v: the plain norm and rotary."""
    q, k, v = _gqa_project(p, cfg, x, rmsnorm)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _gqa_qkv_serving(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The serving paths' q, k, v: the same values through the norm and
    rotary wrappers (one kernel each on a card, no gradient)."""
    q, k, v = _gqa_project(p, cfg, x, ops.rmsnorm)
    q, k = ops.rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_attend(
    p: Params, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_hint: Optional[PartitionSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal (optionally sliding-window) attention over any
    ``S``, the window a mask over the whole sequence; returns (out, k, v).
    ``kv_hint``: a partition spec k/v take once, above the attention (the
    reference's constraint above its tile loop; DTensors only)."""
    B, S = q.shape[:2]
    k, v = constrain(k, kv_hint), constrain(v, kv_hint)
    o = kernels_bridge.causal_attention(q, k, v, window=cfg.sliding_window)
    return o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"], k, v


def gqa_forward(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
    kv_hint: Optional[PartitionSpec] = None,
) -> torch.Tensor:
    """Full-sequence causal attention without a cache (the training path)."""
    return _gqa_attend(p, cfg, *_gqa_qkv(p, cfg, x, positions), kv_hint)[0]


def gqa_prefill(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
    kv_hint: Optional[PartitionSpec] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence causal (optionally sliding-window) attention that also
    emits the decode cache: the whole k/v, or, when the window is shorter
    than the sequence, the ring of its last ``W`` rows with their
    positions in ``slot_pos`` (``S`` must then be a multiple of ``W``, so
    position ``t`` lands in slot ``t % W``)."""
    B, S, _ = x.shape
    W = cfg.sliding_window
    if W and W < S and S % W:
        raise ValueError(f"prefill length {S} must be a multiple of the ring window {W}")
    out, k, v = _gqa_attend(p, cfg, *_gqa_qkv_serving(p, cfg, x, positions), kv_hint)
    if W and W < S:
        slot_pos = torch.arange(S - W, S, dtype=torch.int32, device=x.device)
        return out, {"k": k[:, S - W:], "v": v[:, S - W:], "slot_pos": slot_pos.expand(B, W)}
    return out, {"k": k, "v": v}


def gqa_init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype, device: torch.device
) -> Dict[str, torch.Tensor]:
    """The flat decode cache: ``max_len`` rows, or a ring of ``W`` rows when
    the sliding window is shorter, with ``slot_pos`` -1 (empty) per slot."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    rows = W if W and W < max_len else max_len
    cache = {
        "k": torch.zeros((batch, rows, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, rows, KV, hd), dtype=dtype, device=device),
    }
    if rows < max_len:
        cache["slot_pos"] = torch.full((batch, rows), -1, dtype=torch.int32, device=device)
    return cache


def gqa_cache_specs(
    cfg: ModelConfig, dp: Tuple[str, ...], seq_axis: Optional[str]
) -> Dict[str, PartitionSpec]:
    """Partition specs of the flat cache's leaves: batch over ``dp``, rows
    over ``seq_axis``."""
    spec = (dp, seq_axis, None, None)
    out = {"k": spec, "v": spec}
    if cfg.sliding_window:
        out["slot_pos"] = (dp, None)
    return out


def normalize_pos(pos, batch: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast a scalar-or-(B,) position to ``(B,)`` and derive liveness.

    Negative positions mark idle/padding slots: their logits are still
    computed but their cache rows stay as they were.
    Returns ``(clamped_pos (B,), live (B,) bool)``."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device).expand(batch)
    return pos.clamp(min=0), pos >= 0


def prefix_valid(pos: torch.Tensor, max_len: int) -> torch.Tensor:
    """The full cache's ``(B, max_len)`` mask: row ``s`` of slot ``b`` is
    valid iff ``s <= pos[b]`` (an idle slot, ``pos < 0``, sees row 0, as in
    the reference).  The transformer builds it once per decode step."""
    return torch.arange(max_len, device=pos.device)[None, :] <= pos.clamp(min=0)[:, None]


def _write_token(
    cache: Dict[str, torch.Tensor],
    new: Dict[str, torch.Tensor],  # leaf name -> (B, 1, ...) rows of the new token
    cpos: torch.Tensor,  # (B,) clamped positions
    live: torch.Tensor,  # (B,) bool
    valid: Optional[torch.Tensor],  # (B, S) prefix mask of a full cache, or None
) -> torch.Tensor:
    """Write the new token's rows into the flat cache: at ``pos``, or in a
    ring at slot ``pos % W`` with its position in ``slot_pos``.  Returns
    the ``(B, rows)`` mask of the rows the token attends to: the prefix
    (``valid``, or built here), or the ring's slots whose position lies in
    the window ``(pos - W, pos]``."""
    if "slot_pos" not in cache:
        for name, rows in new.items():
            write_rows(cache[name], rows, live, cpos)
        return prefix_valid(cpos, cache[next(iter(new))].shape[1]) if valid is None else valid
    slot_pos = cache["slot_pos"]
    W = slot_pos.shape[1]
    slot = cpos % W
    for name, rows in {**new, "slot_pos": cpos[:, None].to(slot_pos.dtype)}.items():
        write_rows(cache[name], rows, live, slot)
    c = cpos[:, None]
    return (slot_pos >= 0) & (slot_pos > c - W) & (slot_pos <= c)


def gqa_decode(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],
    pos,  # (B,) per-slot position of the new token (or scalar)
    valid: Optional[torch.Tensor] = None,  # (B, S) prefix mask of a full cache
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the flat cache: the full ``(B, max_len, KV,
    hd)`` one, or the ring ``(B, W, KV, hd)`` one with ``slot_pos``
    (:func:`_write_token`)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    cpos, live = normalize_pos(pos, B, x.device)
    q, k_new, v_new = _gqa_qkv_serving(p, cfg, x, cpos[:, None])
    valid = _write_token(cache, {"k": k_new, "v": v_new}, cpos, live, valid)
    o = kernels_bridge.decode_attention(q, cache["k"], cache["v"], valid)
    return o.reshape(B, 1, H * hd) @ p["wo"], cache


# -- paged KV (shared page pool; the serving engine's production layout) ------


def gqa_init_paged_cache(
    cfg: ModelConfig, num_pages: int, page_size: int, dtype: torch.dtype,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Per-layer page pools.  One logical page id addresses a slab across all
    layers, so one host-side :class:`~repro_torch.serving.paged_cache.PagePool`
    table drives every layer's kernel.  Past the ``num_pages`` a pool hands
    out, each pool holds one more, the *sink*, which takes the idle slots'
    writes (:func:`gqa_decode_paged`) and which no page table names.  A
    sliding window keeps the flat ring cache, as in the reference."""
    if cfg.sliding_window:
        raise NotImplementedError(f"{cfg.name}: the paged cache takes no sliding window")
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (num_pages + 1, page_size, KV, hd)
    return {
        "pool_k": torch.zeros(shape, dtype=dtype, device=device),
        "pool_v": torch.zeros(shape, dtype=dtype, device=device),
    }


def gqa_decode_paged(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],  # {"pool_k","pool_v"} (P + 1, ps, KV, hd)
    page_tables: torch.Tensor,  # (B, max_pages) int32
    pos,  # (B,) per-slot position of the new token
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ragged decode against the paged pool: the new token's k/v is written
    into its slot's current page, then
    :func:`repro_torch.kernels.ops.paged_decode_attention` runs over the
    pages — the CUDA kernel on a card, its plain version on the CPU.
    The pools are updated in place.

    Every slot writes, so the step has fixed shapes and never waits for the
    device, as a CUDA graph needs: an idle slot (``pos < 0``) writes into
    the pool's last page, the sink (:func:`gqa_init_paged_cache`), as JAX
    routes it to an out-of-bounds page whose write the scatter drops.  Its
    length is 0, for which the kernel returns zeros."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    cpos, live = normalize_pos(pos, B, x.device)
    q, k_new, v_new = _gqa_qkv_serving(p, cfg, x, cpos[:, None])
    pool_k, pool_v = cache["pool_k"], cache["pool_v"]
    ps = pool_k.shape[1]
    page = page_tables.gather(1, (cpos // ps)[:, None])[:, 0].long()
    page = torch.where(live, page, pool_k.shape[0] - 1)
    off = cpos % ps
    pool_k[page, off] = k_new[:, 0]
    pool_v[page, off] = v_new[:, 0]
    lengths = torch.where(live, cpos + 1, 0).to(torch.int32)
    o = ops.paged_decode_attention(q, pool_k, pool_v, page_tables, lengths)
    return o.reshape(B, 1, H * hd) @ p["wo"], cache


# -- MLA (DeepSeek multi-head latent attention) --------------------------------


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    specs: Dict[str, ParamSpec] = {}
    if qr:
        specs["w_dq"] = ((d, qr), "normal", None, (None, None))
        specs["q_norm"] = ((qr,), "ones", None, (None,))
        specs["w_uq"] = ((qr, H * (nd + rd)), "normal", None, (None, "model"))
    else:
        specs["w_uq"] = ((d, H * (nd + rd)), "normal", None, (None, "model"))
    specs["w_dkv"] = ((d, r + rd), "normal", None, (None, None))
    specs["kv_norm"] = ((r,), "ones", None, (None,))
    specs["w_uk"] = ((r, H * nd), "normal", None, (None, "model"))
    specs["w_uv"] = ((r, H * vd), "normal", None, (None, "model"))
    specs["wo"] = ((H * vd, d), "normal", None, ("model", None))
    return specs


def _mla_q(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query's no-RoPE and RoPE parts, (B, S, H, nd) and (B, S, H, rd)."""
    H, nd, rd = cfg.num_heads, cfg.nope_head_dim, cfg.rope_head_dim
    cq = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps) if cfg.q_lora_rank else x
    q = split_heads(cq @ p["w_uq"], H, nd + rd)
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)


def _mla_latent(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed KV ``ckv`` (B, S, r) and the shared rotary key
    ``krope`` (B, S, rd)."""
    r = cfg.kv_lora_rank
    dkv = x @ p["w_dkv"]
    ckv = rmsnorm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, krope


def _mla_attend(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
    kv_hint: Optional[PartitionSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence MLA with the latent expanded into per-head K/V; returns
    (out, ckv, krope).  ``kv_hint`` as in :func:`_gqa_attend`, on the
    expanded K/V."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv, krope = _mla_latent(p, cfg, x, positions)
    k_nope = split_heads(ckv @ p["w_uk"], H, nd)
    v = split_heads(ckv @ p["w_uv"], H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
    k, v = constrain(k, kv_hint), constrain(v, kv_hint)
    o = kernels_bridge.causal_attention(
        q, k, v, window=cfg.sliding_window, scale=1.0 / math.sqrt(nd + rd)
    )
    return o.reshape(B, S, H * vd) @ p["wo"], ckv, krope


def mla_forward(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
    kv_hint: Optional[PartitionSpec] = None,
) -> torch.Tensor:
    """Full-sequence causal MLA without a cache (the training path)."""
    return _mla_attend(p, cfg, x, positions, kv_hint)[0]


def mla_prefill(
    p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
    kv_hint: Optional[PartitionSpec] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence MLA that also emits the latent decode cache: the whole
    ``ckv``/``krope``, or the ring of their last ``W`` rows with
    ``slot_pos`` when the window is shorter than the sequence (``S`` a
    multiple of ``W``, as in :func:`gqa_prefill`)."""
    B, S, _ = x.shape
    W = cfg.sliding_window
    if W and W < S and S % W:
        raise ValueError(f"prefill length {S} must be a multiple of the ring window {W}")
    out, ckv, krope = _mla_attend(p, cfg, x, positions, kv_hint)
    if W and W < S:
        slot_pos = torch.arange(S - W, S, dtype=torch.int32, device=x.device)
        return out, {"ckv": ckv[:, S - W:], "krope": krope[:, S - W:],
                     "slot_pos": slot_pos.expand(B, W)}
    return out, {"ckv": ckv, "krope": krope}


def mla_init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype, device: torch.device
) -> Dict[str, torch.Tensor]:
    """The latent decode cache, ``(B, rows, r)`` and ``(B, rows, rd)``:
    ``max_len`` rows, or a ring of ``W`` with ``slot_pos`` -1 (empty)."""
    r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    W = cfg.sliding_window
    rows = W if W and W < max_len else max_len
    cache = {
        "ckv": torch.zeros((batch, rows, r), dtype=dtype, device=device),
        "krope": torch.zeros((batch, rows, rd), dtype=dtype, device=device),
    }
    if rows < max_len:
        cache["slot_pos"] = torch.full((batch, rows), -1, dtype=torch.int32, device=device)
    return cache


def mla_cache_specs(
    cfg: ModelConfig, dp: Tuple[str, ...], seq_axis: Optional[str]
) -> Dict[str, PartitionSpec]:
    """Partition specs of the latent cache's leaves, as :func:`gqa_cache_specs`."""
    out = {"ckv": (dp, seq_axis, None), "krope": (dp, seq_axis, None)}
    if cfg.sliding_window:
        out["slot_pos"] = (dp, None)
    return out


def mla_decode(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],
    pos,  # (B,) per-slot position of the new token (or scalar)
    valid: Optional[torch.Tensor] = None,  # (B, S) prefix mask of a full cache
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-absorbed one-token decode: ``w_uk`` folds into the query and
    ``w_uv`` into the output, so scores and reads stay in the latent space
    and the cache holds ``r + rd`` numbers a token.  The ring and the
    validity follow :func:`gqa_decode`.  The softmax is the reference's,
    masked with -1e30, so a row with no valid entry averages the latent
    as the reference's does."""
    B = x.shape[0]
    H = cfg.num_heads
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    cpos, live = normalize_pos(pos, B, x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, cpos[:, None])  # (B,1,H,nd), (B,1,H,rd)
    ckv_new, krope_new = _mla_latent(p, cfg, x, cpos[:, None])
    valid = _write_token(cache, {"ckv": ckv_new, "krope": krope_new}, cpos, live, valid)
    ckv, krope = cache["ckv"], cache["krope"]
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, split_heads(p["w_uk"], H, nd))
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, ckv)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, krope))
    scores = scores.float() / math.sqrt(nd + rd)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    o_latent = torch.einsum("bhqs,bsr->bqhr", probs, ckv)  # (B, 1, H, r)
    o = torch.einsum("bqhr,rhv->bqhv", o_latent, split_heads(p["w_uv"], H, vd))
    return o.reshape(B, 1, H * vd) @ p["wo"], cache
