"""phi4-mini-3.8b [dense] — RoPE, SwiGLU, GQA.  [arXiv:2412.08905]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    citation="arXiv:2412.08905",
)

SMOKE = ModelConfig(
    name="phi4-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    citation="arXiv:2412.08905 (reduced)",
)
