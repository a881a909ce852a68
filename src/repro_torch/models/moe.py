"""Mixture-of-Experts: top-k router + sort-based ragged dispatch.

Dispatch is sort based (a stable argsort by expert, a fixed per-expert
capacity, a grouped product over the ``(E, C, d)`` expert buffer), as in the
JAX package: the one-hot ``(T, E, C)`` dispatch einsum would cost
O(T.E.C.d) FLOPs. Tokens past an expert's capacity are dropped, and
``index_add_`` combines the kept expert outputs, weighted by their
renormalised gates.

Covers mixtral (8e top-2), jamba (16e top-2, every other layer) and the MoE
layers of deepseek-v3 (1 shared + 256 routed top-8, router_scale, its
sigmoid group-limited router with a correction bias: ``route_grouped``).

Expert parallelism's share. Where the router is wider than the experts held
(``MoEConfig.num_routed``), the layer routes every token over all of them and
computes only its own experts' part for the pairs routed to them, with the
capacity of an expert from the router's width, as one rank of an EP
deployment does without its exchange; the shared expert is computed as
always, and the absent experts' part is left out. One device:
``shard_activation`` places nothing.

No host sync. Every tensor of the dispatch has a size fixed by the tokens,
the experts held, top-k and the capacity, so the host never waits for the
device in it, and a decode step with MoE layers can be captured in a CUDA
graph (``serving/decode_graph.py``). The kept pairs' token indices and gates
are scattered into their slots, and the pairs dropped at capacity or routed
to an absent expert into one spare entry that nothing reads; an empty slot
gathers a zero row and weighs its expert's output (0) by a gate of 0.

Counts. Each call adds the (token, expert) pairs routed, those routed to
experts held here and those of them dropped at capacity to its device's
running sums (:func:`pair_counts`), in place on the device, so that a
replayed graph counts too; ``Engine.generate`` reads them at the syncs it
makes anyway.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
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
        "w_router": ParamSpec((d, m.router_width), ("d_model", None), scale=0.1),
        "we_gate": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff")),
        "we_up": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff")),
        "we_down": ParamSpec((e, f, d), ("experts", "expert_ff", "d_model")),
    }
    if m.scoring == "sigmoid":       # e_score_correction_bias: the choice's alone
        specs["router_bias"] = ParamSpec((m.router_width,), (None,), init="zeros")
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


def route_grouped(cfg: ModelConfig, router_logits: torch.Tensor, bias: torch.Tensor):
    """DeepSeek-V3's router (``noaux_tc``), all in float32: sigmoid scores;
    the choice adds ``bias`` to them; each of ``n_group`` groups scores the
    sum of its two best biased scores, and the ``topk_group`` best groups
    are kept; the top k experts of the kept groups are taken (ties to the
    lower index); their gates are the unbiased scores, renormalised where k
    > 1 (``norm_topk_prob``), times ``router_scale``. Returns (gates, idx):
    (T, k)."""
    m = cfg.moe
    scores = torch.sigmoid(router_logits.float())
    choice = scores + bias.float()
    if m.n_group > 1:
        t = choice.shape[0]
        grouped = choice.view(t, m.n_group, -1)
        group_scores = _topk(grouped, 2)[0].sum(dim=-1)             # (T, G)
        _, groups = _topk(group_scores, m.topk_group)
        kept = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(1, groups, True)
        choice = choice.masked_fill(~kept[:, :, None].expand_as(grouped).reshape(t, -1),
                                    float("-inf"))
    _, idx = _topk(choice, m.top_k)
    gates = scores.gather(1, idx)
    if m.top_k > 1:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
    return gates * m.router_scale, idx


def moe_apply(cfg: ModelConfig, p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). The layer holds experts ``0 ..
    num_experts - 1`` of the router's ``router_width``."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    e, k = m.num_experts, m.top_k

    with trace.span("moe.route"):
        if m.scoring == "sigmoid":
            router_logits = x2.float() @ p["w_router"].float()
            gates, idx = route_grouped(cfg, router_logits, p["router_bias"])
        else:
            router_logits = x2 @ p["w_router"].to(x.dtype)
            gates, idx = route_topk(cfg, router_logits)             # (T,k)

    with trace.span("moe.dispatch"):
        out = _dispatch(p, x2, gates, idx, e, k, m.router_width)

    if m.num_shared_experts:
        hs = F.silu(x2 @ p["ws_gate"].to(x.dtype)) * (x2 @ p["ws_up"].to(x.dtype))
        out = out + hs @ p["ws_down"].to(x.dtype)
    return out.reshape(b, s, d)


def _dispatch(p, x2, gates, idx, e: int, k: int, width: int) -> torch.Tensor:
    """The pairs routed to the ``e`` experts held here (``0 .. e - 1`` of the
    router's ``width``) go through them, up to each expert's capacity; the
    rest are left out. With every expert held (``width == e``) this is the
    whole layer. The work on rows of ``d`` is bounded by the ``e * c``
    slots, whatever share of the pairs is dropped or absent."""
    t, d = x2.shape
    c = capacity(t, width, k)
    dev = x2.device
    flat_e = idx.reshape(t * k).clamp(max=e)          # every absent expert sorts last
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], order // k, gates.reshape(t * k)[order]
    first = torch.searchsorted(se, torch.arange(e + 1, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - first[se]
    keep = (se < e) & (pos < c)
    held = first[e]
    pair_counts(dev).add_(torch.stack([torch.full_like(held, t * k), held, held - keep.sum()]))
    # each kept pair into its slot, every other pair into the spare last entry;
    # an empty slot takes token t (a zero row) and a gate of 0
    slot = torch.where(keep, se * c + pos, e * c)
    src = torch.full((e * c + 1,), t, dtype=torch.long, device=dev).scatter_(0, slot, st)[:-1]
    w = sg.new_zeros(e * c + 1).scatter(0, slot, sg)[:-1]

    buf = F.pad(x2, (0, 0, 0, 1))[src]
    buf = shard_activation(buf.reshape(e, c, d), ("experts", None, None))

    # grouped expert FFN
    h = F.silu(torch.bmm(buf, p["we_gate"].to(x2.dtype)))
    h = h * torch.bmm(buf, p["we_up"].to(x2.dtype))
    y = torch.bmm(h, p["we_down"].to(x2.dtype)).reshape(e * c, d)
    # combine back, weighted by the (renormalised) gates; empty slots into row t
    out = x2.new_zeros((t + 1, d)).index_add_(0, src, y * w.to(x2.dtype)[:, None])
    return out[:t]


# the running sums of each device: (token, expert) pairs routed, routed to
# the experts held, dropped of those at capacity
_PAIRS: Dict[torch.device, torch.Tensor] = {}


def pair_counts(device) -> torch.Tensor:
    """The (3,) int64 running sums on ``device`` of the pairs routed, held
    and dropped by every MoE call there, which each call adds to in place.
    A reader takes a snapshot with ``clone()`` (no sync) and brings the
    numbers back at a sync it makes anyway. Made at the first call, which
    comes before any capture: a prefill runs before its decode step is
    captured."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counts = _PAIRS.get(device)
    if counts is None:
        with torch.inference_mode(False):     # a tensor training may add to too
            counts = _PAIRS[device] = torch.zeros(3, dtype=torch.long, device=device)
    return counts


def aux_load_balance_loss(cfg: ModelConfig, router_logits: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance aux loss (training)."""
    m = cfg.moe
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, idx = _topk(probs, m.top_k)
    e = m.router_width
    lead = tuple(range(idx.ndim - 1))
    frac_tokens = F.one_hot(idx, e).float().sum(dim=-2).mean(dim=lead)
    frac_probs = probs.mean(dim=tuple(range(probs.ndim - 1)))
    return e * (frac_tokens * frac_probs).sum()
