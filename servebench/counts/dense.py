"""A dense GQA decoder's admission and decode step (``arch_type`` dense):
(flops by precision, bytes), each weight read once."""

from __future__ import annotations

from typing import Dict, Sequence

from servebench.counts import kernels


def _dims(cfg: Dict):
    d, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    return d, H, KV, hd


def layer_params(cfg: Dict) -> int:
    d, H, KV, hd = _dims(cfg)
    attn = d * (H + 2 * KV) * hd + H * hd * d
    mlp = (3 if cfg.get("mlp_gated", True) else 2) * d * cfg["d_ff"]
    return attn + mlp


def head_params(cfg: Dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def weight_bytes(cfg: Dict) -> float:
    return 2.0 * (cfg["num_layers"] * (layer_params(cfg) + 2 * cfg["d_model"])
                  + head_params(cfg) + cfg["d_model"])


def kv_bytes_per_token(cfg: Dict) -> float:
    _, _, KV, hd = _dims(cfg)
    return 2.0 * 2 * KV * hd * cfg["num_layers"]


def attention_layers(cfg: Dict) -> int:
    return cfg["num_layers"]


def prefill(cfg: Dict, L: int) -> kernels.Work:
    """An admission of an ``L``-token prompt: every layer over L tokens,
    the head over the last one; weights and the L embedding rows read, the
    cache's L rows and one row of logits written."""
    d, H, KV, hd = _dims(cfg)
    attn_flops, _ = kernels.flash_attention(L, H, KV, hd)
    flops = (2.0 * L * layer_params(cfg) + attn_flops["bf16"]) * cfg["num_layers"]
    flops += 2.0 * head_params(cfg)
    nbytes = weight_bytes(cfg) + 2.0 * L * d + L * kv_bytes_per_token(cfg) + 2.0 * cfg["vocab_size"]
    return {"bf16": flops}, nbytes


def decode(cfg: Dict, lens: Sequence[int]) -> kernels.Work:
    """One decode step of the live slots, ``lens`` their contexts with the
    new token: every layer and the head over one token a slot; weights
    and the slots' cached rows read, one row of cache and logits a slot
    written."""
    d, H, KV, hd = _dims(cfg)
    B = len(lens)
    flops = (2.0 * B * layer_params(cfg) + 4.0 * H * hd * sum(lens)) * cfg["num_layers"]
    flops += 2.0 * B * head_params(cfg)
    nbytes = (weight_bytes(cfg) + 2.0 * B * d + sum(lens) * kv_bytes_per_token(cfg)
              + 2.0 * B * cfg["vocab_size"])
    return {"bf16": flops}, nbytes
