"""granite-20b [dense] — llama-arch code model, MQA (kv=1).  [arXiv:2405.04324]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,  # GPT-BigCode-style GELU MLP
    citation="arXiv:2405.04324",
)

SMOKE = ModelConfig(
    name="granite-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    mlp_gated=False,
    citation="arXiv:2405.04324 (reduced)",
)
