"""GQA attention (full / sliding-window / local+global).

Two execution paths:
  * dense path — full-sequence (prefill), causal (+window) mask;
  * decode path — one query token against a preallocated KV cache.

The einsum implementation here is the reference path (``use_kernel=False``);
the CUDA kernels in ``repro_torch.kernels`` are swapped in via
``repro_torch.kernels.ops`` when enabled. The projections stay ``einsum``:
they lie outside the kernels, as in the JAX package. MLA is not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamSpec, apply_rope, resolve_device,
                                       rms_norm, softcap)

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
