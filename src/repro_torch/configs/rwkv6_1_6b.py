"""rwkv6-1.6b: RWKV-6 "Finch" as published, attention-free, with a
data-dependent token shift and decay.

Sources: arXiv:2404.05892 (Eagle and Finch), section 4; the authors'
``RWKV_Tmix_x060`` / ``RWKV_CMix_x060`` (BlinkDL/RWKV-LM); the widths of the
released RWKV-x060-World-1B6: 24 layers, n_embd 2048, head size 64 (32
heads), channel mix int(3.5 x 2048 / 32) x 32 = 7168, vocabulary 65536, an
untied head; token-shift LoRA rank 32 and decay LoRA rank 64 (the x060
code's values below n_embd 4096). The WKV output takes a GroupNorm of 32
groups with eps 1e-5 x 8**2; every block norm (ln1, ln2, ln0 after the
embedding, ln_out before the head) is a LayerNorm with a bias, eps 1e-5.

The JAX package runs a simplified form under the same name (static token
shift, one LayerNorm over the WKV output, bias-free RMSNorm blocks): the
port's tests reach it through ``SSMConfig(token_shift_lora=0,
head_norm_eps=0)``, ``norm_kind="rms"`` and ``embed_norm=False``.
"""
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
    ssm=SSMConfig(kind="rwkv6", wkv_head_dim=64, token_shift_lora=32,
                  head_norm_eps=6.4e-4),      # 1e-5 x head_size_divisor 8, squared
    norm_eps=1e-5,
    norm_kind="layer",
    embed_norm=True,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm=SSMConfig(kind="rwkv6", wkv_head_dim=16, token_shift_lora=8, head_norm_eps=6.4e-4),
)
