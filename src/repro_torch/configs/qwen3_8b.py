"""qwen3-8b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    citation="hf:Qwen/Qwen3-8B",
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    qk_norm=True,
    citation="hf:Qwen/Qwen3-8B (reduced)",
)
