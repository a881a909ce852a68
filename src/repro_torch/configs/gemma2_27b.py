"""gemma2-27b — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attention_kind="local_global",
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_kind="geglu",
    tie_embeddings=True,
    post_norms=True,
    zero_centered_norm=True,
)

SMOKE = CONFIG.scaled(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=16,
)
