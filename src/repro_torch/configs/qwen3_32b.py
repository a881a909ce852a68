"""qwen3-32b — dense GQA transformer with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    attention_kind="full",
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
)

# Reduced config of the same family for CPU smoke tests.
SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
