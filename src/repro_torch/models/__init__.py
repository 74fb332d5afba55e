"""PyTorch model code: the decoder models (dense GQA, also behind the vlm
and audio stub frontends, DeepSeek MoE with MLA, Mamba2 SSM, Zamba2
hybrid) and their building blocks."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model

__all__ = ["Model", "ModelConfig"]
