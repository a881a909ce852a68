"""Model / run configuration dataclasses covering all assigned arch families.

One ``ModelConfig`` describes any of the 10 assigned architectures:
dense GQA transformers, local+global alternating (gemma2), SWA (mixtral),
MLA + fine-grained MoE (deepseek-v3), hybrid Mamba+attn MoE (jamba),
attention-free RWKV6, and stub-frontend audio/VLM backbones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int                 # per-expert hidden dim
    num_shared_experts: int = 0      # deepseek-style always-on shared experts
    # which layers are MoE: layer i is MoE iff i >= first_moe_layer and
    # (i - first_moe_layer) % moe_every == 0
    first_moe_layer: int = 0
    moe_every: int = 1
    router_scale: float = 1.0        # routed-expert output scaling (deepseek 2.5)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"              # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # rwkv6
    wkv_head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour ---
    attention_kind: str = "full"     # full | sliding | local_global | mla | none
    sliding_window: int = 4096
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    rope_theta: float = 10000.0
    pos_kind: str = "rope"           # rope | sinusoidal | none

    # --- mlp flavour ---
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu

    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # --- hybrid pattern (jamba): within each super-block of size
    # ``hybrid_block_size`` layers, indices in attn_layer_idx are attention,
    # the rest are SSM layers ---
    hybrid_block_size: int = 1
    attn_layer_idx: Tuple[int, ...] = ()

    # --- dense prelude for deepseek (first N layers are dense MLP) ---
    num_dense_layers: int = 0
    d_ff_dense: int = 0              # d_ff of the dense-prelude layers

    # --- heads / embeddings ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    post_norms: bool = False         # gemma2 sandwich norms
    zero_centered_norm: bool = False  # gemma-style (1 + scale) RMSNorm
    mtp_depth: int = 0               # deepseek multi-token-prediction depth

    # --- modality stub (audio/vlm): model consumes precomputed frame/patch
    # embeddings concatenated ahead of token embeddings ---
    frontend_stub: bool = False
    stub_embed_len: int = 0          # number of precomputed embedding positions

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        m = self.moe
        return i >= m.first_moe_layer and (i - m.first_moe_layer) % m.moe_every == 0

    def layer_is_attn(self, i: int) -> bool:
        """For hybrid archs: is layer i an attention layer (vs SSM)."""
        if self.attention_kind == "none":
            return False
        if self.hybrid_block_size <= 1:
            return True
        return (i % self.hybrid_block_size) in self.attn_layer_idx

    def layer_is_global_attn(self, i: int) -> bool:
        """For local_global alternating (gemma2): odd layers are global."""
        if self.attention_kind != "local_global":
            return True
        return i % 2 == 1

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.layer_is_attn(i))

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode has a bounded per-token working set."""
        if self.attention_kind == "none":
            return True
        if self.attention_kind == "sliding":
            return True
        if self.hybrid_block_size > 1:
            # hybrid: attention KV still grows but only on 1/block_size layers;
            # treated as sub-quadratic-enough for the long_500k cell (jamba).
            return True
        return False

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # --- parameter count (analytic, for roofline MODEL_FLOPS) ---
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, analytic."""
        d, V = self.d_model, self.vocab_size
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d  # lm head
        for i in range(self.num_layers):
            total += self._layer_params(i, active_only)
        total += d  # final norm
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention_kind == "mla":
            m = self.mla
            p = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.num_heads * m.v_head_dim * d
            return p
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        d = self.d_model
        s = self.ssm
        if s.kind == "mamba":
            d_in = s.expand * d
            p = d * 2 * d_in                       # in_proj (x, z)
            p += d_in * s.d_conv                   # conv
            p += d_in * (s.d_state * 2 + 1)        # x_proj -> B, C, dt
            p += d_in * s.d_state + d_in           # A_log, D
            p += d_in * d                          # out_proj
            return p
        # rwkv6 time-mix + channel-mix
        p = 4 * d * d + d * d                      # r,k,v,g,o  (approx)
        p += 2 * d * self.d_ff                     # channel mix
        return p

    def _layer_params(self, i: int, active_only: bool) -> int:
        d = self.d_model
        p = 2 * d  # two norms
        if self.attention_kind == "none" or not self.layer_is_attn(i):
            p += self._ssm_params()
        else:
            p += self._attn_params()
        if i < self.num_dense_layers:
            p += self._mlp_params(self.d_ff_dense or self.d_ff)
        elif self.layer_is_moe(i):
            m = self.moe
            n_routed = m.top_k if active_only else m.num_experts
            p += (n_routed + m.num_shared_experts) * self._mlp_params(m.d_ff_expert)
            p += d * m.num_experts  # router
        else:
            p += self._mlp_params(self.d_ff)
        return p


# ----------------------------------------------------------------------
# Input shapes assigned to every LM arch (seq_len, global_batch, kind)
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
