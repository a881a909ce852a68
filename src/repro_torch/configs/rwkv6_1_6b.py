"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # wkv heads = d_model / wkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attention_kind="none",
    pos_kind="none",
    mlp_kind="gelu",           # rwkv channel-mix uses squared relu; see ssm.py
    ssm=SSMConfig(kind="rwkv6", wkv_head_dim=64),
    norm_eps=1e-5,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm=SSMConfig(kind="rwkv6", wkv_head_dim=16),
)
