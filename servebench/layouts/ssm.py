"""The Mamba2 stack (``arch_type`` ssm): the top-level leaves, then
``num_layers`` stacked Mamba2 layers.  :func:`mamba` is one layer's
leaves, for a family that holds Mamba2 layers among others."""

from __future__ import annotations

from typing import Dict, List

from servebench.weights import Group, Leaf, _normal, d_inner, ssm_heads, top_leaves


def mamba(cfg: Dict) -> List[Leaf]:
    d, di, n, H = cfg["d_model"], d_inner(cfg), cfg["ssm_state"], ssm_heads(cfg)
    conv_ch = di + 2 * n
    W = cfg.get("conv_width", 4)
    return [("ln", (d,), "norm", 0.1),
            _normal("w_z", (d, di)), _normal("w_xbc", (d, conv_ch)), _normal("w_dt", (d, H)),
            _normal("conv_w", (W, conv_ch)), ("conv_b", (conv_ch,), "bias", 0.1),
            ("A_log", (H,), "a_log", 0.0), ("dt_bias", (H,), "dt_bias", 0.0),
            ("D", (H,), "d_skip", 0.1), ("ssm_norm", (di,), "norm", 0.1),
            _normal("w_out", (di, d))]


def groups(cfg: Dict) -> List[Group]:
    return [Group("", None, top_leaves(cfg)), Group("layers", cfg["num_layers"], mamba(cfg))]
