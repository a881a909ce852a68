"""musicgen-medium — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings ahead of the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,          # MHA
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    attention_kind="full",
    pos_kind="sinusoidal",
    mlp_kind="gelu",
    frontend_stub=True,
    stub_embed_len=256,       # conditioning frames prepended to the sequence
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, stub_embed_len=8,
)
