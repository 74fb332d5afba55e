"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port's own copy of the JAX package's registry, holding all ten of its
architectures: qwen3-8b, phi4-mini-3.8b and llama3-405b (dense GQA),
mamba2-370m (pure SSM), zamba2-1.2b (Mamba2 with a shared attention
block), granite-20b (dense, MQA, GELU MLP), internvl2-1b (vlm) and
musicgen-large (audio), the dense block stack fed by a stub frontend, and
deepseek-v2-236b and deepseek-v3-671b (MoE with MLA attention).  Each
module cites its source model card; ``smoke`` variants are reduced
same-family configs used by the CPU tests.
:func:`long_context_variant` is the reference's sliding-window variant,
which gives ring caches.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-8b": "qwen3_8b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-20b": "granite_20b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "llama3-405b": "llama3_405b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-large": "musicgen_large",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch_id: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg: ModelConfig = mod.SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """The sliding-window variant the reference uses for its ``long_500k``
    shape on architectures whose attention is otherwise full: decode then
    keeps a ring of ``window`` cache rows.  SSM archs need no change;
    hybrids window only their shared-attention block."""
    if cfg.arch_type == "ssm":
        return cfg
    return dataclasses.replace(cfg, sliding_window=window)
