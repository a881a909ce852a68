"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 MoE, MTP.
[arXiv:2412.19437; hf]

First 3 layers are dense (d_ff 18432); the remaining 58 are MoE with
per-expert d_ff 2048 (the assigned "d_ff=2048" is the expert hidden dim).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,         # MLA: effective full-head KV via latent cache
    head_dim=128,
    d_ff=2048,                # routed-expert hidden dim (assigned)
    vocab_size=129280,
    attention_kind="mla",
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_moe_layer=3, moe_every=1,
                  router_scale=2.5),
    num_dense_layers=3,
    d_ff_dense=18432,
    mtp_depth=1,
)

SMOKE = CONFIG.scaled(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, first_moe_layer=1, moe_every=1,
                  router_scale=2.5),
    num_dense_layers=1,
    d_ff_dense=128,
    mtp_depth=1,
)
