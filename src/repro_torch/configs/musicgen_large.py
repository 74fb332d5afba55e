"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

The EnCodec tokenizer/conv frontend is a stub, as in the reference:
``Model.prefill(embeds=)`` takes frame embeddings; this config is the
decoder backbone (vocab = 2048 codebook entries).  The engine serves
token ids.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    modality="audio_stub",
    frontend_tokens=256,
    citation="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    arch_type="audio",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    modality="audio_stub",
    frontend_tokens=16,
    citation="arXiv:2306.05284 (reduced)",
)
