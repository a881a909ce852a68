"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 MoE, MTP.
[arXiv:2412.19437; hf: deepseek-ai/DeepSeek-V3 config.json, modeling_deepseek.py]

First 3 layers are dense (d_ff 18432); the remaining 58 are MoE with
per-expert d_ff 2048 (the assigned "d_ff=2048" is the expert hidden dim).

The router is the published one (``topk_method: noaux_tc``): sigmoid scores
in float32, plus ``e_score_correction_bias`` for the choice alone, the 4 of
8 expert groups whose two best biased scores sum highest, the top 8 experts
within them, gates from the unbiased scores renormalised
(``norm_topk_prob``) and times ``routed_scaling_factor`` 2.5. MLA's 64 rope
dims take YaRN (factor 40 over 4096 original positions, ``beta_fast`` 32,
``beta_slow`` 1, ``mscale`` = ``mscale_all_dim`` = 1), and its softmax scale
is multiplied by ``mscale(40, 1)**2`` = 1.3689**2. The JAX package routes
by a softmax top-k and runs plain RoPE; tests that hold the port against it
set those explicitly.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, RopeScaling

YARN = RopeScaling(type="yarn", factor=40.0, original_max_position_embeddings=4096,
                   beta_fast=32.0, beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0)

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
    rope_scaling=YARN,
    mlp_kind="swiglu",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_moe_layer=3, moe_every=1,
                  router_scale=2.5, scoring="sigmoid", n_group=8, topk_group=4),
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
                  router_scale=2.5, scoring="sigmoid", n_group=4, topk_group=2),
    num_dense_layers=1,
    d_ff_dense=128,
    mtp_depth=1,
)
