"""Plain float32 reference of DeepSeek-V3's decoder (arXiv:2412.19437 and the
published ``modeling_deepseek.py``), for the port's tests: plain ``torch``
operations, no kernel, cache or batching, and nothing of the port or of JAX.

The layer equations:

    h = x + MLA(RMSNorm(x)) ;  x' = h + FFN(RMSNorm(h))
    MLA:  c_q = RMSNorm(h W_dq);  [q_nope | q_pe] = c_q W_uq (per head)
          [c_kv | k_pe] = h W_dkv;  c_kv = RMSNorm(c_kv)
          k_nope = c_kv W_uk, v = c_kv W_uv (per head); k_pe is one head
          shared by all; q_pe and k_pe take RoPE with YaRN's frequencies
          scores = (q_nope k_nope^T + q_pe k_pe^T) * mscale^2 / sqrt(nope + rope)
          causal softmax, out = p v, then W_o
    FFN:  dense SwiGLU on the first ``num_dense_layers`` layers; then the MoE:
          s = sigmoid(h W_r) (float32); the choice adds the correction bias
          b; each of ``n_group`` groups scores the sum of its two best
          biased scores; the ``topk_group`` best groups are kept; the top k
          experts of those; gates g = s at them / their sum (k > 1), times
          ``router_scale``; y = shared(h) + sum over the k of g_e expert_e(h)
    logits = RMSNorm(x_L) W_head

YaRN, as ``DeepseekV3YarnRotaryEmbedding``: with d the rope dims, the
correction dim of r rotations is d ln(L0 / (2 pi r)) / (2 ln theta) for the
original context L0; between those of ``beta_fast`` (floored) and
``beta_slow`` (ceiled) the inverse frequency ramps linearly from theta^(-2i/d)
to theta^(-2i/d) / factor; cos and sin are scaled by mscale(factor, mscale)
/ mscale(factor, mscale_all_dim), with mscale(s, m) = 0.1 m ln(s) + 1.

Departures, each also the port's documented semantics:
- the rope dims rotate as split halves; the checkpoint interleaves them,
  which with random weights is a fixed permutation of the rope columns of
  ``w_uq`` and ``w_dkv``;
- an expert takes at most ``capacity`` pairs of one call (``ceil(T k 1.25 /
  W)`` for the router's width W, rounded up to a multiple of 8, at least 8;
  pairs in token-major order); later pairs are dropped. A call is the prompt
  or one decode step. The published model drops nothing;
- expert parallelism's share: where the layer holds experts ``0 ..
  num_experts - 1`` of the router's width (``num_routed``), the routing is
  over all of them and only the held experts' part is added (the shared
  expert is added as always).

``score_dtype`` and ``router_dtype`` round the attention scores or the
router's operands to another type: the tests use them to show that their
tolerances catch bfloat16 there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CAPACITY_FACTOR = 1.25


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(dim: int, theta: float, rs) -> torch.Tensor:
    """Rope inverse frequencies (dim/2,), YaRN's where ``rs`` (a mapping) is set."""
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    if rs is None:
        return base

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    return base / rs["factor"] * ramp + base * (1 - ramp)


def rope(x, positions, freq, cs_scale):
    """x (B, T, heads, d): split halves rotate against each other."""
    ang = positions.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None] * cs_scale, torch.sin(ang)[:, None] * cs_scale
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(x, w, sz, score_dtype):
    b, t, _ = x.shape
    m, h, eps = sz["mla"], sz["num_heads"], sz["norm_eps"]
    nope, rdim, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["kv_lora_rank"]
    rs = sz["rope_scaling"]
    freq = inv_freq(rdim, sz["rope_theta"], rs)
    cs = 1.0 if rs is None else (mscale(rs["factor"], rs["mscale"])
                                 / mscale(rs["factor"], rs["mscale_all_dim"]))
    scale = 1.0 / math.sqrt(nope + rdim)
    if rs is not None and rs["mscale_all_dim"]:
        scale *= mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    pos = torch.arange(t)
    q = torch.einsum("btl,lhk->bthk", rms_norm(x @ w["w_dq"], w["q_norm"], eps), w["w_uq"])
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, freq, cs)
    dkv = x @ w["w_dkv"]
    c_kv = rms_norm(dkv[..., :r], w["kv_norm"], eps)
    k_pe = rope(dkv[..., None, r:], pos, freq, cs)[:, :, 0]
    k_nope = torch.einsum("btl,lhk->bthk", c_kv, w["w_uk"])
    v = torch.einsum("btl,lhk->bthk", c_kv, w["w_uv"])
    s = (torch.einsum("bqhk,bthk->bhqt", q_nope, k_nope)
         + torch.einsum("bqhk,btk->bhqt", q_pe, k_pe)) * scale
    s = s.to(score_dtype).float()
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqt,bthk->bqhk", p, v)
    return torch.einsum("bqhk,hkd->bqd", out, w["wo"])


def capacity(tokens: int, width: int, k: int) -> int:
    c = int(math.ceil(tokens * k * CAPACITY_FACTOR / width))
    return max(8, ((c + 7) // 8) * 8)


def route(x, w, moe, router_dtype=torch.float32):
    """(gates, idx), each (T, k), of the sigmoid group-limited router."""
    logits = (x.to(router_dtype) @ w["w_router"].to(router_dtype)).float()
    scores = torch.sigmoid(logits)
    choice = scores + w["router_bias"]
    t, width = choice.shape
    g = moe["n_group"]
    if g > 1:
        grouped = choice.view(t, g, width // g)
        gscore = grouped.sort(dim=-1, descending=True, stable=True).values[..., :2].sum(-1)
        keep = gscore.sort(dim=-1, descending=True, stable=True).indices[:, :moe["topk_group"]]
        mask = torch.zeros(t, g, dtype=torch.bool).scatter_(1, keep, True)
        choice = choice.masked_fill(~mask.repeat_interleave(width // g, dim=1), float("-inf"))
    idx = choice.sort(dim=-1, descending=True, stable=True).indices[:, :moe["top_k"]]
    gates = scores.gather(1, idx)
    if moe["top_k"] > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    return gates * moe["router_scale"], idx


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def moe_layer(h, w, moe, calls, router_dtype=torch.float32):
    """h (B, T, d); ``calls``: the position ranges that run as one call each."""
    b, _, d = h.shape
    width = moe["num_routed"] or moe["num_experts"]
    out = swiglu(h, w["ws_gate"], w["ws_up"], w["ws_down"])
    for sl in calls:
        x = h[:, sl].reshape(-1, d)                              # batch-major
        gates, idx = route(x, w, moe, router_dtype)
        c = capacity(x.shape[0], width, moe["top_k"])
        y = torch.zeros_like(x)
        for e in range(moe["num_experts"]):
            tok, rank = (idx == e).nonzero(as_tuple=True)      # in token order
            tok, rank = tok[:c], rank[:c]
            y.index_add_(0, tok, swiglu(x[tok], w["we_gate"][e], w["we_up"][e],
                                        w["we_down"][e]) * gates[tok, rank, None])
        out[:, sl] += y.reshape(b, -1, d)
    return out


def forward(sz: dict, params: dict, tokens: torch.Tensor, n_prompt: int, *,
            score_dtype=torch.float32, router_dtype=torch.float32) -> torch.Tensor:
    """Float32 logits (B, T, V) of ``tokens`` (B, T), whose first ``n_prompt``
    positions are the prompt and each later one a decode step (the calls of
    the experts' capacity). ``sz``: the configuration as a mapping (the
    port's field names); ``params``: the port's parameter tree."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(sz, params, tokens, n_prompt, score_dtype, router_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _forward(sz, params, tokens, n_prompt, score_dtype, router_dtype):
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.float()  # noqa: E731
                        for k, v in tree.items()}
    params = f32(params)
    eps, t = sz["norm_eps"], tokens.shape[1]
    calls = [slice(0, n_prompt)] + [slice(p, p + 1) for p in range(n_prompt, t)]
    x = params["embed"]["embedding"][tokens]
    layers = [("dense_layers", u) for u in range(sz["num_dense_layers"])]
    layers += [("layers", u) for u in range(sz["num_layers"] - sz["num_dense_layers"])]
    for group, u in layers:
        w = {k: (v[u] if not isinstance(v, dict) else {kk: vv[u] for kk, vv in v.items()})
             for k, v in params[group]["sub0"].items()}
        x = x + mla(rms_norm(x, w["norm_mixer"], eps), w["attn"], sz, score_dtype)
        a = rms_norm(x, w["norm_mlp"], eps)
        if group == "dense_layers":
            x = x + swiglu(a, w["mlp"]["w_gate"], w["mlp"]["w_up"], w["mlp"]["w_down"])
        else:
            x = x + moe_layer(a, w["moe"], sz["moe"], calls, router_dtype)
    return rms_norm(x, params["final_norm"], eps) @ params["embed"]["lm_head"]
