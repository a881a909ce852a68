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

RWKV_DECAY_LORA = 64                  # RWKV-6's decay LoRA rank (Finch below n_embd 4096)

@dataclass(frozen=True)
class MoEConfig:
    """A mixture of experts. The defaults route by a softmax top-k over the
    experts held. DeepSeek-V3's router (``scoring="sigmoid"``) scores with a
    sigmoid, adds a correction bias for the choice alone, keeps the
    ``topk_group`` of ``n_group`` expert groups whose two best biased scores
    sum highest, takes the top k within them, and gates by the unbiased
    scores renormalised. ``num_routed`` is the router's width over all the
    deployment's experts where the layer holds fewer: this layer holds
    experts ``0 .. num_experts - 1`` (expert parallelism's share of rank
    0)."""
    num_experts: int                 # experts this layer holds
    top_k: int
    d_ff_expert: int                 # per-expert hidden dim
    num_shared_experts: int = 0      # deepseek-style always-on shared experts
    # which layers are MoE: layer i is MoE iff i >= first_moe_layer and
    # (i - first_moe_layer) % moe_every == 0
    first_moe_layer: int = 0
    moe_every: int = 1
    router_scale: float = 1.0        # routed-expert output scaling (deepseek 2.5)
    scoring: str = "softmax"         # softmax | sigmoid (with a correction bias)
    n_group: int = 1                 # expert groups of the router
    topk_group: int = 1              # groups a token's experts are taken from
    num_routed: int = 0              # the router's width; 0: num_experts

    def __post_init__(self):
        if self.scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown MoE scoring {self.scoring!r}")
        w = self.router_width
        if not (0 < self.num_experts <= w and w % self.n_group == 0
                and 0 < self.topk_group <= self.n_group):
            raise ValueError(f"inconsistent router: {self}")
        if self.n_group > 1 and self.scoring != "sigmoid":
            raise ValueError("group-limited routing is implemented for sigmoid scoring")

    @property
    def router_width(self) -> int:
        return self.num_routed or self.num_experts


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RopeScaling:
    """YaRN (arXiv:2309.00071) in DeepSeek-V3's form (``modeling_deepseek.py``:
    ``DeepseekV3YarnRotaryEmbedding``, ``yarn_get_mscale``): the inverse
    frequencies ramp from the extrapolated ones (below the correction dim of
    ``beta_fast``) to the interpolated ones, divided by ``factor`` (above
    that of ``beta_slow``); cos and sin are scaled by ``mscale(factor,
    mscale) / mscale(factor, mscale_all_dim)``, and MLA's softmax scale by
    ``mscale(factor, mscale_all_dim)**2``. Field names as in the published
    ``rope_scaling``."""
    type: str = "yarn"
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"rope scaling {self.type!r} is not implemented (yarn is)")


@dataclass(frozen=True)
class SSMConfig:
    """A Mamba or an RWKV-6 mixer. RWKV-6 as published (Finch, arXiv:2404.05892
    section 4) interpolates each token with the one before by a data-dependent
    amount, a LoRA of rank ``token_shift_lora`` on top of the static mixes
    ("ddlerp"), and normalises the WKV output per head (GroupNorm with eps
    ``head_norm_eps``). ``token_shift_lora`` 0 keeps the static mixes alone and
    ``head_norm_eps`` 0 one LayerNorm over all channels with the model's
    ``norm_eps``: the JAX package's form."""
    kind: str = "mamba"              # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # rwkv6
    wkv_head_dim: int = 64
    token_shift_lora: int = 0        # Finch: 32 below n_embd 4096
    head_norm_eps: float = 0.0       # Finch: 1e-5 x 8**2


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
    rope_scaling: Optional[RopeScaling] = None   # YaRN (MLA only); None: plain RoPE

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
    norm_kind: str = "rms"           # rms | layer (LayerNorm with a bias; RWKV only)
    embed_norm: bool = False         # a norm right after the embedding (RWKV's ln0)
    post_norms: bool = False         # gemma2 sandwich norms
    zero_centered_norm: bool = False  # gemma-style (1 + scale) RMSNorm
    mtp_depth: int = 0               # deepseek multi-token-prediction depth

    # --- modality stub (audio/vlm): model consumes precomputed frame/patch
    # embeddings concatenated ahead of token embeddings ---
    frontend_stub: bool = False
    stub_embed_len: int = 0          # number of precomputed embedding positions

    dtype: str = "bfloat16"

    def __post_init__(self):
        # a configuration read from a file gives its sub-configurations as
        # mappings: they become the dataclasses
        for name, kind in (("moe", MoEConfig), ("mla", MLAConfig), ("ssm", SSMConfig),
                           ("rope_scaling", RopeScaling)):
            v = getattr(self, name)
            if isinstance(v, dict):
                object.__setattr__(self, name, kind(**v))
        if self.rope_scaling is not None and self.attention_kind != "mla":
            raise ValueError("rope_scaling (YaRN) is implemented for MLA only")
        if self.norm_kind not in ("rms", "layer"):
            raise ValueError(f"unknown norm_kind {self.norm_kind!r}")
        if (self.norm_kind == "layer" or self.embed_norm) and self.attention_kind != "none":
            raise ValueError("LayerNorm blocks and an embedding norm are implemented "
                             "for RWKV only")

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
        if self._rwkv_published:      # the final norm's bias; the embedding norm
            per_norm = 2 * d if self.norm_kind == "layer" else d
            total += per_norm - d + (per_norm if self.embed_norm else 0)
        return total

    @property
    def _rwkv_published(self) -> bool:
        """An RWKV-6 model in Finch's form, whose count is exact: the sum over
        the parameter tree. The JAX package's form keeps its approximate
        count, which both packages share."""
        return (self.ssm is not None and self.ssm.kind == "rwkv6"
                and self.ssm.token_shift_lora > 0)

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
        if self._rwkv_published:
            # time mix: maa_x and the 5 static mixes, the token-shift LoRA,
            # r/k/v/g/o, the decay base and LoRA, the bonus, the GroupNorm's
            # scale and bias; channel mix: its 2 mixes, key, value and
            # receptance; the two block norms' scales and biases
            r = s.token_shift_lora
            p = 6 * d + 2 * 5 * r * d + 5 * d * d + d + 2 * RWKV_DECAY_LORA * d + 3 * d
            p += 2 * d + 2 * d * self.d_ff + d * d
            return p + (4 if self.norm_kind == "layer" else 2) * d
        # rwkv6 time-mix + channel-mix
        p = 4 * d * d + d * d                      # r,k,v,g,o  (approx)
        p += 2 * d * self.d_ff                     # channel mix
        return p

    def _layer_params(self, i: int, active_only: bool) -> int:
        d = self.d_model
        if self._rwkv_published:      # the block whole, counted once
            return self._ssm_params()
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
            p += d * m.router_width  # router
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
