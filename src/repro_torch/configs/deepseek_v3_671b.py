"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    attention_kind="mla",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # dense layers' FFN width
    vocab_size=129280,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    mtp=True,
    citation="arXiv:2412.19437",
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
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
    mtp=True,
    citation="arXiv:2412.19437 (reduced)",
)
