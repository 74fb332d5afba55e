"""PyTorch model code: the dense GQA decoder and its building blocks."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model

__all__ = ["Model", "ModelConfig"]
