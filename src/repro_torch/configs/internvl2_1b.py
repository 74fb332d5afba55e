"""internvl2-1b [vlm] — InternViT + InternLM2/Qwen2-0.5B language backbone.
[arXiv:2404.16821]

The vision frontend (InternViT + MLP projector) is a stub, as in the
reference: ``Model.prefill(embeds=)`` takes pre-projected patch embeddings
of shape (batch, frontend_tokens, d_model); this config describes the
language decoder that consumes them.  The engine serves token ids.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    modality="vision_stub",
    frontend_tokens=256,
    rope_theta=1e6,
    citation="arXiv:2404.16821",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    arch_type="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    modality="vision_stub",
    frontend_tokens=16,
    citation="arXiv:2404.16821 (reduced)",
)
