"""llava-next-mistral-7b — Mistral-7B backbone, anyres tiling VLM.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only: the CLIP vision tower + anyres tiling is a STUB —
``input_specs()`` provides precomputed patch embeddings (anyres grid of up to
5 tiles x 576 patches = 2880 positions) prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention_kind="full",
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    frontend_stub=True,
    stub_embed_len=2880,      # anyres: 5 tiles x 24x24 patches
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, stub_embed_len=16,
)
