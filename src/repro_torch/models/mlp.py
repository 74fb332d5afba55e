"""Dense feed-forward block: SwiGLU, or the non-gated GELU MLP."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig


def mlp_specs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamSpec]:
    """``d_ff`` overrides the config's width (the MoE shared experts are one
    SwiGLU of ``moe_d_ff * num_shared_experts``)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    specs: Dict[str, ParamSpec] = {}
    if cfg.mlp_gated:
        specs["w_gate"] = ((d, ff), "normal", None, (None, "model"))
    specs["w_up"] = ((d, ff), "normal", None, (None, "model"))
    specs["w_down"] = ((ff, d), "normal", None, ("model", None))
    return specs


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:  # non-gated (GPT-BigCode style, e.g. granite-20b)
        # jax.nn.gelu's default is the tanh form; torch's is the exact erf form
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
