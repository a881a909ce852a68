"""Attention variants: GQA (full / sliding-window / local+global) and MLA.

Two execution paths per variant:
  * dense path — full-sequence (train / prefill), causal (+window) mask;
  * decode path — one query token against a preallocated KV cache.

The einsum implementation here is the reference path (``use_kernel=False``);
the CUDA kernels in ``repro_torch.kernels`` are swapped in via
``repro_torch.kernels.ops`` when enabled. The projections stay ``einsum``:
they lie outside the kernels, as in the JAX package. MLA (DeepSeek-V3) has
no kernel behind it in the JAX package either: it is einsums only, with
fp32 score products on the model-dtype operands.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.distributed.ctx import shard_activation
from repro_torch.models.layers import (ParamSpec, apply_rope, resolve_device,
                                       rms_norm, softcap, yarn_get_mscale)

NEG_INF = -2.3819763e38  # large negative for masking (bf16-safe)


class KVCache(NamedTuple):
    """Per-layer KV cache. For sliding layers the seq dim is the window and
    writes wrap (ring buffer; keys stored post-RoPE)."""
    k: torch.Tensor        # (B, S_cache, KV, D)
    v: torch.Tensor        # (B, S_cache, KV, D)


def attn_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    specs = {
        "wq": ParamSpec((d, cfg.num_heads, cfg.head_dim),
                        ("d_model", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.num_kv_heads, cfg.head_dim),
                        ("d_model", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.num_kv_heads, cfg.head_dim),
                        ("d_model", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.num_heads, cfg.head_dim, d),
                        ("heads", "head_dim", "d_model")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((cfg.head_dim,), (None,), init="ones")
        specs["k_norm"] = ParamSpec((cfg.head_dim,), (None,), init="ones")
    return specs


def layer_window(cfg: ModelConfig, is_global: bool) -> int | None:
    """The sliding window of a layer, or None for full attention."""
    if cfg.attention_kind == "sliding" or (
            cfg.attention_kind == "local_global" and not is_global):
        return cfg.sliding_window
    return None


def _causal_mask(s_q: int, s_k: int, window: int | None, device=None) -> torch.Tensor:
    """(s_q, s_k) boolean mask; query i at absolute pos i+(s_k-s_q)."""
    qi = torch.arange(s_q, device=device)[:, None] + (s_k - s_q)
    kj = torch.arange(s_k, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def gqa_scores_softmax(q, k, v, mask, attn_softcap: float, scale: float):
    """q:(B,Sq,H,D) k,v:(B,Sk,KV,D) mask:(B|1,Sq,Sk) -> (B,Sq,H,D).
    Scores are computed in fp32 from the operands (as the JAX package's
    ``preferred_element_type=float32`` does: no bf16 rounding of the scores),
    softmax in fp32; the probabilities go back to ``v.dtype`` for the second
    product."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = shard_activation(scores, ("batch", "kv_heads", "heads", "scores_seq", None))
    scores = softcap(scores, attn_softcap)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention_dense(cfg: ModelConfig, p, x: torch.Tensor,
                        positions: torch.Tensor, *, is_global: bool,
                        use_kernel: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence causal attention. Returns output and the (roped) K/V
    to seed a decode cache."""
    s = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x, positions)
    window = layer_window(cfg, is_global)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, window=window,
                                   attn_softcap=cfg.attn_logit_softcap,
                                   scale=scale)
    else:
        mask = _causal_mask(s, s, window, x.device)[None]
        out = gqa_scores_softmax(q, k, v, mask, cfg.attn_logit_softcap, scale)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, KVCache(k=k, v=v)


def gqa_attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                         cache: KVCache, lengths: torch.Tensor, *,
                         is_global: bool,
                         use_kernel: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d_model); lengths: (B,) tokens already in
    cache (the new token's absolute position).

    The new K/V row is written into ``cache`` **in place** before attending
    (``index_put_`` touches B rows only); the returned cache is the same
    storage. This replaces the buffer donation of the JAX engine."""
    s_cache = cache.k.shape[1]
    window = layer_window(cfg, is_global)
    q, k, v = _project_qkv(cfg, p, x, lengths[:, None])

    # ring-buffer write for windowed layers, linear write otherwise
    write_idx = lengths % s_cache if window is not None else lengths
    rows = torch.arange(x.shape[0], device=x.device)
    cache.k[rows, write_idx] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, write_idx] = v[:, 0].to(cache.v.dtype)

    # valid slots: slot < min(len+1, S) (ring buffer holds last S positions)
    n_valid = torch.clamp(lengths + 1, max=s_cache)
    slot = torch.arange(s_cache, device=x.device)[None, :]
    mask = slot < n_valid[:, None]                              # (B, S)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, cache.k, cache.v, mask,
                                    attn_softcap=cfg.attn_logit_softcap,
                                    scale=scale)
    else:
        out = gqa_scores_softmax(q, cache.k, cache.v, mask[:, None, :],
                                 cfg.attn_logit_softcap, scale)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, cache


def place_kv(x: torch.Tensor, dst: torch.Tensor, seq_len: int,
             window: int | None) -> torch.Tensor:
    """Copy a prompt's K or V, (..., S, KV, D), into the decode slots ``dst``,
    (..., S_cache, KV, D), and return ``dst``: slot i holds position i; in a
    sliding window's ring buffer, once the prompt fills it, slot p % S_cache
    holds position p of the last S_cache positions. Slots past the prompt
    keep what they held."""
    s, s_cache = x.shape[-3], dst.shape[-3]
    if window is None or s < s_cache:
        dst[..., :s, :, :].copy_(x)
    else:
        r = seq_len % s_cache
        dst[..., r:, :, :].copy_(x[..., s - s_cache:s - r, :, :])
        dst[..., :r, :, :].copy_(x[..., s - r:, :, :])
    return dst


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  is_global: bool, dtype=torch.bfloat16, device=None) -> KVCache:
    """Zeroed decode buffers on ``device`` (None: the card)."""
    device = resolve_device(device)
    s = max_len
    if layer_window(cfg, is_global) is not None:
        s = min(max_len, cfg.sliding_window)
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ----------------------------------------------------------------------
# MLA (DeepSeek-V3): latent KV cache + decode-time weight absorption.
class MLACache(NamedTuple):
    latent: torch.Tensor   # (B, S, kv_lora_rank)  — compressed KV
    k_rope: torch.Tensor   # (B, S, qk_rope_head_dim) — shared rope key


def mla_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, m, h = cfg.d_model, cfg.mla, cfg.num_heads
    return {
        "w_dq": ParamSpec((d, m.q_lora_rank), ("d_model", "lora_out")),
        "q_norm": ParamSpec((m.q_lora_rank,), (None,), init="ones"),
        "w_uq": ParamSpec((m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
                          ("lora", "heads", "head_dim")),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("d_model", "lora_out")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                          ("lora", "heads", "head_dim")),
        "w_uv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                          ("lora", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "d_model")),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    """``1 / sqrt(nope + rope)``, times YaRN's ``mscale(factor,
    mscale_all_dim)**2`` where the rope dims take YaRN (DeepSeek-V3's
    ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)
    rs = cfg.rope_scaling
    if rs is not None and rs.mscale_all_dim:
        scale *= yarn_get_mscale(rs.factor, rs.mscale_all_dim) ** 2
    return scale


def _mla_qkv_latent(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """Shared projection work: returns roped q_nope/q_rope and the cacheable
    (latent, k_rope). RoPE covers the last ``qk_rope_head_dim`` dims of q
    only; ``k_rope`` is one head shared by every query head."""
    m = cfg.mla
    q_l = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsl,lhk->bshk", q_l, p["w_uq"].to(x.dtype))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta,
                        cfg.rope_scaling)

    dkv = x @ p["w_dkv"].to(x.dtype)
    latent = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta, cfg.rope_scaling)[..., 0, :]   # (B,S,rope)
    return q_nope, q_rope, latent, k_rope


def _mla_probs(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)


def mla_attention_dense(cfg: ModelConfig, p, x: torch.Tensor,
                        positions: torch.Tensor) -> Tuple[torch.Tensor, MLACache]:
    """Full-sequence MLA (train / prefill): decompress K/V directly. Both
    score products are fp32 on the model-dtype operands (the JAX package's
    ``preferred_element_type=float32``); the probabilities go back to
    ``v.dtype`` for the value product. Runs inside the span ``attn.mla``."""
    with trace.span("attn.mla"):
        return _mla_dense(cfg, p, x, positions)


def _mla_dense(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    s = x.shape[1]
    q_nope, q_rope, latent, k_rope = _mla_qkv_latent(cfg, p, x, positions)
    k_nope = torch.einsum("bsl,lhk->bshk", latent, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsl,lhk->bshk", latent, p["w_uv"].to(x.dtype))
    scores = (torch.einsum("bshk,bthk->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope.float())
              ) * _mla_scale(cfg)
    probs = _mla_probs(scores, _causal_mask(s, s, None, x.device)[None, None])
    out = torch.einsum("bhst,bthk->bshk", probs.to(v.dtype), v)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, MLACache(latent=latent, k_rope=k_rope)


def mla_attention_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: MLACache,
                         lengths: torch.Tensor) -> Tuple[torch.Tensor, MLACache]:
    """One-token MLA decode with weight absorption: ``w_uk`` is folded into
    the query (``q_lat``, in the model dtype), so scores and values are
    computed in the rank-``kv_lora`` latent space (MQA-style) and ``w_uv``
    decompresses the attended latent once a step. x: (B, 1, d_model);
    lengths: (B,) tokens already in the cache, the new token's position.

    The new latent and ``k_rope`` rows are written into ``cache`` **in
    place** at ``lengths`` before attending (the mask is ``slot <=
    lengths``); the returned cache is the same storage. Runs inside the span
    ``attn.mla``."""
    with trace.span("attn.mla"):
        return _mla_decode(cfg, p, x, cache, lengths)


def _mla_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: MLACache,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, MLACache]:
    s_cache = cache.latent.shape[1]
    q_nope, q_rope, latent_t, k_rope_t = _mla_qkv_latent(cfg, p, x, lengths[:, None])
    # absorb w_uk into q: (B,1,H,nope) @ (lora,H,nope) -> (B,1,H,lora)
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p["w_uk"].to(x.dtype))

    rows = torch.arange(x.shape[0], device=x.device)
    cache.latent[rows, lengths] = latent_t[:, 0].to(cache.latent.dtype)
    cache.k_rope[rows, lengths] = k_rope_t[:, 0].to(cache.k_rope.dtype)

    scores = (torch.einsum("bshl,btl->bhst", q_lat.float(), cache.latent.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(), cache.k_rope.float())
              ) * _mla_scale(cfg)
    slot = torch.arange(s_cache, device=x.device)[None, :]
    probs = _mla_probs(scores, (slot <= lengths[:, None])[:, None, None])
    # attend in latent space, then decompress once per step
    out_lat = torch.einsum("bhst,btl->bshl", probs.to(cache.latent.dtype), cache.latent)
    out = torch.einsum("bshl,lhk->bshk", out_lat, p["w_uv"].to(x.dtype))
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return proj, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    """Zeroed latent and rope-key buffers on ``device`` (None: the card)."""
    device = resolve_device(device)
    m = cfg.mla
    return MLACache(
        latent=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                           device=device))
