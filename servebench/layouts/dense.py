"""The dense GQA block stack (``arch_type`` dense): the top-level leaves,
then ``num_layers`` stacked blocks of attention and an MLP, gated (SwiGLU)
or not (GELU)."""

from __future__ import annotations

from typing import Dict, List

from servebench.weights import Group, _normal, top_leaves


def groups(cfg: Dict) -> List[Group]:
    d = cfg["d_model"]
    H, KV = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    ff = cfg["d_ff"]
    block = [("ln1", (d,), "norm", 0.1),
             _normal("attn/wq", (d, H * hd)), _normal("attn/wk", (d, KV * hd)),
             _normal("attn/wv", (d, KV * hd)), _normal("attn/wo", (H * hd, d))]
    if cfg.get("qk_norm"):
        block += [("attn/q_norm", (hd,), "norm", 0.1), ("attn/k_norm", (hd,), "norm", 0.1)]
    block.append(("ln2", (d,), "norm", 0.1))
    if cfg.get("mlp_gated", True):
        block.append(_normal("mlp/w_gate", (d, ff)))
    block += [_normal("mlp/w_up", (d, ff)), _normal("mlp/w_down", (ff, d))]
    return [Group("", None, top_leaves(cfg)), Group("layers", cfg["num_layers"], block)]
