"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242]

38 Mamba2 layers; one *shared* GQA block (single weight set) invoked after
every ``shared_attn_every`` Mamba2 layers.  DESIGN.md §8 records the cadence
simplification (every 2nd layer so the 38-layer stack scans as 19 uniform
superblocks).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_width=4,
    shared_attn_every=2,
    citation="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    arch_type="hybrid",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=32,
    conv_width=4,
    shared_attn_every=2,
    ssm_chunk=16,
    citation="arXiv:2411.15242 (reduced)",
)
