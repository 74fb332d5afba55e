"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.
[arXiv:2405.04434]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    attention_kind="mla",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,  # dense layers' FFN width
    vocab_size=102400,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    citation="arXiv:2405.04434",
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    arch_type="moe",
    attention_kind="mla",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    kv_lora_rank=32,
    q_lora_rank=48,
    rope_head_dim=16,
    nope_head_dim=32,
    v_head_dim=32,
    num_experts=4,
    experts_per_token=2,
    num_shared_experts=1,
    moe_d_ff=64,
    first_dense_layers=1,
    citation="arXiv:2405.04434 (reduced)",
)
