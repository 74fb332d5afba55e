"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    attention_kind="none",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_width=4,
    citation="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    arch_type="ssm",
    attention_kind="none",
    num_layers=2,
    d_model=128,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=32,
    conv_width=4,
    ssm_chunk=16,
    citation="arXiv:2405.21060 (reduced)",
)
