"""Dense feed-forward (SwiGLU) block."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if not cfg.mlp_gated:
        raise NotImplementedError(f"{cfg.name}: only the gated (SwiGLU) MLP is ported")
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ((d, ff), "normal", None),
        "w_up": ((d, ff), "normal", None),
        "w_down": ((ff, d), "normal", None),
    }


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
