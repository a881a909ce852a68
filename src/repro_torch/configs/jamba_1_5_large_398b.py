"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Super-block of 8 layers: one attention layer (local index 3, per the Jamba
block layout), 7 Mamba layers; MoE replaces the MLP on every other layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attention_kind="full",
    pos_kind="none",          # Jamba uses no positional encoding
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  first_moe_layer=1, moe_every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    hybrid_block_size=8,
    attn_layer_idx=(3,),
)

SMOKE = CONFIG.scaled(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  first_moe_layer=1, moe_every=2),
    ssm=SSMConfig(kind="mamba", d_state=8, d_conv=4, expand=2),
)
