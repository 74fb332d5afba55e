"""Architecture configuration schema.

One :class:`ModelConfig` instance fully describes any of the ten assigned
architectures (dense / MoE / SSM / hybrid / VLM / audio).  Configs live in
:mod:`repro_torch.configs` (one module per architecture, exact numbers cited
from the source papers) and are consumed by :mod:`repro_torch.models.transformer`.

A copy of the JAX package's schema: the port keeps its own so that it
imports nothing of that package.  Keep the two identical field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # -- attention ------------------------------------------------------------
    attention_kind: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None  # ring-cache window (long-context)

    # -- MLA (DeepSeek multi-head latent attention) -----------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    mlp_gated: bool = True  # SwiGLU when True; GELU 2-matrix MLP when False

    # -- MoE --------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # -- SSM (Mamba2 / SSD) --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 128

    # -- hybrid (Zamba2-style shared attention) --------------------------------------
    shared_attn_every: int = 0  # apply one shared GQA block every k SSM layers

    # -- multimodal stub -----------------------------------------------------------
    modality: str = "text"  # text | vision_stub | audio_stub
    frontend_tokens: int = 256  # stub prefix length supplied by input_specs

    # -- training extras --------------------------------------------------------------
    mtp: bool = False  # DeepSeek-V3 multi-token prediction head
    tie_embeddings: bool = False

    # -- numerics ----------------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    vocab_pad: int = 256  # embed/head padded so the vocab dim shards cleanly

    # -- citation (source paper / model card for the exact numbers) ----------------------
    citation: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
            raise ValueError(
                f"{self.name}: unknown arch_type {self.arch_type!r} "
                "(expected dense|moe|ssm|hybrid|vlm|audio)"
            )
        if self.arch_type == "ssm" and self.attention_kind != "none":
            raise ValueError(
                f"{self.name}: pure-SSM configs take attention_kind='none', "
                f"got {self.attention_kind!r}"
            )
        if self.attention_kind == "mla" and self.kv_lora_rank <= 0:
            raise ValueError(
                f"{self.name}: MLA attention needs kv_lora_rank > 0, "
                f"got {self.kv_lora_rank}"
            )

    # -- derived quantities used by profiles / roofline ------------------------------
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def is_attention_layer(self, layer: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.arch_type == "hybrid":
            k = max(self.shared_attn_every, 1)
            return (layer + 1) % k == 0
        return True

    def is_moe_layer(self, layer: int) -> bool:
        return self.num_experts > 0 and layer >= self.first_dense_layers

    def param_count(self) -> float:
        """Approximate total parameter count (used by analytic profiles)."""
        d, v = self.d_model, self.vocab_size
        total = 2.0 * v * d if not self.tie_embeddings else 1.0 * v * d
        for layer in range(self.num_layers):
            total += self._layer_params(layer)
        return total

    def active_param_count(self) -> float:
        """Parameters touched per token (MoE: shared + top-k experts only)."""
        d, v = self.d_model, self.vocab_size
        total = 2.0 * v * d if not self.tie_embeddings else 1.0 * v * d
        for layer in range(self.num_layers):
            total += self._layer_params(layer, active_only=True)
        return total

    def _attention_params(self) -> float:
        d = self.d_model
        if self.attention_kind == "mla":
            qd = self.q_lora_rank or d
            p = 0.0
            if self.q_lora_rank:
                p += d * self.q_lora_rank
            p += qd * self.num_heads * (self.nope_head_dim + self.rope_head_dim)
            p += d * (self.kv_lora_rank + self.rope_head_dim)
            p += self.kv_lora_rank * self.num_heads * (
                self.nope_head_dim + self.v_head_dim
            )
            p += self.num_heads * self.v_head_dim * d
            return p
        hd = self.head_dim
        return d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
            self.num_heads * hd * d
        )

    def _mlp_params(self, layer: int, active_only: bool = False) -> float:
        d = self.d_model
        if self.is_moe_layer(layer):
            n_routed = self.experts_per_token if active_only else self.num_experts
            experts = (n_routed + self.num_shared_experts) * 3 * d * self.moe_d_ff
            router = d * self.num_experts
            return experts + router
        return (3.0 if self.mlp_gated else 2.0) * d * self.d_ff

    def _ssm_params(self) -> float:
        d, di = self.d_model, self.d_inner
        n = self.ssm_state
        # in_proj -> (z, x, B, C, dt), conv, A/D, norm, out_proj
        in_proj = d * (2 * di + 2 * n * 1 + self.ssm_heads)
        conv = (di + 2 * n) * self.conv_width
        out = di * d
        return in_proj + conv + out + 2 * self.ssm_heads + di

    def _layer_params(self, layer: int, active_only: bool = False) -> float:
        p = 2.0 * self.d_model  # norms
        if self.arch_type == "ssm":
            return p + self._ssm_params()
        if self.arch_type == "hybrid":
            p += self._ssm_params()
            if self.is_attention_layer(layer):
                # shared weights: count once over the whole stack
                k = max(self.shared_attn_every, 1)
                p += self._attention_params() / max(1, self.num_layers // k)
            return p
        p += self._attention_params()
        p += self._mlp_params(layer, active_only)
        return p

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> float:
        """Decode-cache bytes appended per generated token per request."""
        if self.arch_type == "ssm":
            return 0.0
        if self.attention_kind == "mla":
            per_layer = self.kv_lora_rank + self.rope_head_dim
        else:
            per_layer = 2 * self.num_kv_heads * self.head_dim
        if self.arch_type == "hybrid":
            k = max(self.shared_attn_every, 1)
            n_attn = self.num_layers // k
        else:
            n_attn = self.num_layers
        return float(n_attn * per_layer * dtype_bytes)
