"""mixtral-8x7b — 8 experts top-2 MoE, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention_kind="sliding",
    sliding_window=4096,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
)
