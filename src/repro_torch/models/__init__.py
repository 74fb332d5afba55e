"""PyTorch model code: the decoder models (dense GQA, also behind the vlm
and audio stub frontends, DeepSeek MoE with MLA, Mamba2 SSM, Zamba2
hybrid) and their building blocks.

:class:`ModelConfig` is a plain dataclass (stdlib only) and is exported
eagerly: the config registry (:mod:`repro_torch.configs`) and the
scheduler-side bridge (:mod:`repro_torch.core.arch_bridge`) consume it
without torch.  :class:`Model` pulls in torch and the kernels, so it is
exported lazily (PEP 562), as the JAX package exports its own.
"""

from repro_torch.models.config import ModelConfig

__all__ = ["Model", "ModelConfig"]


def __getattr__(name):
    if name == "Model":
        from repro_torch.models.transformer import Model

        return Model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
