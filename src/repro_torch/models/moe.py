"""Mixture-of-Experts: top-k router + sort-based ragged dispatch.

Dispatch is sort based (a stable argsort by expert, a fixed per-expert
capacity, a grouped product over the ``(E, C, d)`` expert buffer), as in the
JAX package: the one-hot ``(T, E, C)`` dispatch einsum would cost
O(T.E.C.d) FLOPs. Tokens past an expert's capacity are dropped by a mask,
and ``index_add_`` combines the kept expert outputs, weighted by their
renormalised gates.

Covers mixtral (8e top-2), jamba (16e top-2, every other layer) and the MoE
layers of deepseek-v3 (1 shared + 256 routed top-8, router_scale). One
device: there is no expert sharding (``shard_activation`` places nothing).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import shard_activation
from repro_torch.models.layers import ParamSpec, ParamTree

CAPACITY_FACTOR = 1.25


def capacity(num_tokens: int, num_experts: int, top_k: int,
             factor: float = CAPACITY_FACTOR) -> int:
    """Slots per expert: ``ceil(T k factor / E)`` rounded up to a multiple
    of 8, at least 8 (the JAX package's rounding: it decides which tokens
    are dropped)."""
    c = int(math.ceil(num_tokens * top_k * factor / num_experts))
    return max(8, ((c + 7) // 8) * 8)


def moe_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    specs = {
        "w_router": ParamSpec((d, e), ("d_model", None), scale=0.1),
        "we_gate": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff")),
        "we_up": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff")),
        "we_down": ParamSpec((e, f, d), ("experts", "expert_ff", "d_model")),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        specs.update({
            "ws_gate": ParamSpec((d, fs), ("d_model", "d_ff")),
            "ws_up": ParamSpec((d, fs), ("d_model", "d_ff")),
            "ws_down": ParamSpec((fs, d), ("d_ff", "d_model")),
        })
    return specs


def _topk(probs: torch.Tensor, k: int):
    """Top k along the last dim, ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(cfg: ModelConfig, router_logits: torch.Tensor):
    """Top-k gating with renormalised weights. Returns (gates, idx): (T,k)."""
    m = cfg.moe
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = _topk(probs, m.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return gate_vals * m.router_scale, gate_idx


def moe_apply(cfg: ModelConfig, p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    e, k = m.num_experts, m.top_k

    router_logits = x2 @ p["w_router"].to(x.dtype)
    gates, idx = route_topk(cfg, router_logits)                 # (T,k)

    c = capacity(t, e, k)
    flat_e = idx.reshape(t * k)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_g = gates.reshape(t * k)

    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    first = torch.searchsorted(se, torch.arange(e, device=x.device), side="left")
    pos = torch.arange(t * k, device=x.device) - first[se]
    keep = pos < c
    slot = torch.where(keep, se * c + pos, torch.full_like(se, e * c - 1))

    # gather the kept tokens into the expert buffer (E*C, d)
    buf = x.new_zeros((e * c, d))
    buf[slot[keep]] = x2[st[keep]]
    buf = shard_activation(buf.reshape(e, c, d), ("experts", None, None))

    # grouped expert FFN
    h = F.silu(torch.bmm(buf, p["we_gate"].to(x.dtype)))
    h = h * torch.bmm(buf, p["we_up"].to(x.dtype))
    y = torch.bmm(h, p["we_down"].to(x.dtype)).reshape(e * c, d)

    # combine back, weighted by the (renormalised) gates; a dropped slot
    # reads a kept row and is weighted by 0
    contrib = y[slot] * (sg * keep).to(x.dtype)[:, None]
    out = x.new_zeros((t, d)).index_add_(0, st, contrib)

    if m.num_shared_experts:
        hs = F.silu(x2 @ p["ws_gate"].to(x.dtype)) * (x2 @ p["ws_up"].to(x.dtype))
        out = out + hs @ p["ws_down"].to(x.dtype)
    return out.reshape(b, s, d)


def aux_load_balance_loss(cfg: ModelConfig, router_logits: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance aux loss (training)."""
    m = cfg.moe
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, idx = _topk(probs, m.top_k)
    e = m.num_experts
    lead = tuple(range(idx.ndim - 1))
    frac_tokens = F.one_hot(idx, e).float().sum(dim=-2).mean(dim=lead)
    frac_probs = probs.mean(dim=tuple(range(probs.ndim - 1)))
    return e * (frac_tokens * frac_probs).sum()
