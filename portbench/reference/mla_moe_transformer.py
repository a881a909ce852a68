"""Plain float32 reference of DeepSeek-V3's decoder layers (arXiv:2412.19437;
the published ``modeling_deepseek.py``): multi-head latent attention with
YaRN'd rope dims, and a mixture of experts behind the sigmoid group-limited
router, of which this chip holds a share (deepseek-v3-4l).

The layer equations:

    h = x + MLA(RMSNorm(x)) ;  x' = h + MoE(RMSNorm(h))
    MLA:  c_q = RMSNorm(h W_dq);  [q_nope | q_pe] = c_q W_uq (per head)
          [c_kv | k_pe] = h W_dkv;  c_kv = RMSNorm(c_kv)
          k_nope = c_kv W_uk, v = c_kv W_uv (per head); k_pe is one head shared
          by every query head; q_pe and k_pe take RoPE with YaRN's frequencies
          scores = (q_nope k_nope^T + q_pe k_pe^T) mscale^2 / sqrt(nope + rope),
          causal softmax, p v, then W_o
    MoE:  s = sigmoid(h W_r); the choice adds the correction bias b; each of
          ``n_group`` groups scores the sum of its two best biased scores,
          the ``topk_group`` best groups are kept and the top k experts of
          those taken; gates = s at them / their sum (k > 1), times
          ``router_scale``; out = shared(h) + sum of the held experts' gated
          SwiGLU outputs
    logits = RMSNorm(x_L) W_head (untied)

YaRN as ``DeepseekV3YarnRotaryEmbedding``: the inverse frequency of rope pair
i ramps, between the correction dims of ``beta_fast`` (floored) and
``beta_slow`` (ceiled), from theta^(-2i/d) to theta^(-2i/d) / factor, where
the correction dim of r rotations is d ln(L0 / (2 pi r)) / (2 ln theta) for
the original context L0; cos and sin are scaled by mscale(factor, mscale) /
mscale(factor, mscale_all_dim), with mscale(s, m) = 0.1 m ln s + 1.

Departures, each also the system's documented semantics:
- the rope dims rotate as split halves; the checkpoint interleaves them,
  which with random weights is a fixed permutation of the rope columns of
  ``w_uq`` and ``w_dkv``;
- this chip holds experts ``0 .. num_experts - 1`` of the router's
  ``num_routed`` (one rank of expert parallelism): the routing is over all
  of them, and only the held experts' part is added (the shared expert as
  always). What the absent experts give is left out, here as in the program;
- an expert takes at most ``capacity`` pairs of one call (``ceil(T k 1.25 /
  num_routed)`` rounded up to a multiple of 8, at least 8; pairs in
  token-major order), and later pairs are dropped. A call is the prompt of a
  batch or one decode step of it. The published model drops nothing.

Everything is computed in float32 from the weights handed in, with TF32 off,
layer by layer, and the attention in blocks of query rows. ``quant="fp8"``
is the control: every product with a weight (the router's included) takes
both operands rounded to float8 e4m3, as in ``gqa_transformer``.

Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import ladder
from portbench.reference.gqa_transformer import _Mat, capacity, leaf, rms_norm

# the correction bias is not part of a configuration; random, it moves a
# token's k-th choice (the scores of its top picks lie some 0.005 apart) and
# an expert's load by some 20 %, as a trained bias balances the loads
BIAS_STD = 0.01

SUPPORTED = {"attention_kind": "mla", "mlp_kind": "swiglu", "pos_kind": "rope",
             "tie_embeddings": False, "num_dense_layers": 0, "mtp_depth": 0,
             "post_norms": False, "zero_centered_norm": False,
             "attn_logit_softcap": 0.0, "final_logit_softcap": 0.0}
MOE_SUPPORTED = {"scoring": "sigmoid", "first_moe_layer": 0, "moe_every": 1,
                 "num_shared_experts": 1}


def check_supported(sizes: dict) -> None:
    """Raises where a configuration asks for what this reference lacks."""
    bad = {k: sizes.get(k) for k, v in SUPPORTED.items() if sizes.get(k, v) != v}
    moe = sizes.get("moe") or {}
    bad.update({f"moe.{k}": moe.get(k) for k, v in MOE_SUPPORTED.items() if moe.get(k) != v})
    rs = sizes.get("rope_scaling")
    if rs is not None and rs.get("type") != "yarn":
        bad["rope_scaling"] = rs
    if bad:
        raise ValueError(f"the mla_moe_transformer reference does not compute {bad}")


def _width(moe: dict) -> int:
    return moe.get("num_routed") or moe["num_experts"]


def layout(sizes: dict) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Leaf path -> (shape, std); std None is a norm scale of ones. Leaves of
    the layer stack carry the layer count first; each product's weight has
    std 1/sqrt(its fan-in). The untied embedding has std 1, as in
    ``gqa_transformer``: each token's own vector leads the residual stream,
    and the router spreads the tokens over its experts."""
    d, n, vocab = sizes["d_model"], sizes["num_layers"], sizes["vocab_size"]
    h, m, moe = sizes["num_heads"], sizes["mla"], sizes["moe"]
    ql, kl = m["q_lora_rank"], m["kv_lora_rank"]
    nope, rope_d, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    e, f, w = moe["num_experts"], moe["d_ff_expert"], _width(moe)
    fs = f * moe["num_shared_experts"]
    pre = "layers.sub0."
    return {
        "embed.embedding": ((vocab, d), 1.0),
        "embed.lm_head": ((d, vocab), 1 / math.sqrt(d)),
        "final_norm": ((d,), None),
        pre + "norm_mixer": ((n, d), None),
        pre + "attn.w_dq": ((n, d, ql), 1 / math.sqrt(d)),
        pre + "attn.q_norm": ((n, ql), None),
        pre + "attn.w_uq": ((n, ql, h, nope + rope_d), 1 / math.sqrt(ql)),
        pre + "attn.w_dkv": ((n, d, kl + rope_d), 1 / math.sqrt(d)),
        pre + "attn.kv_norm": ((n, kl), None),
        pre + "attn.w_uk": ((n, kl, h, nope), 1 / math.sqrt(kl)),
        pre + "attn.w_uv": ((n, kl, h, vd), 1 / math.sqrt(kl)),
        pre + "attn.wo": ((n, h, vd, d), 1 / math.sqrt(h * vd)),
        pre + "norm_mlp": ((n, d), None),
        pre + "moe.w_router": ((n, d, w), 1 / math.sqrt(d)),
        pre + "moe.router_bias": ((n, w), BIAS_STD),
        pre + "moe.we_gate": ((n, e, d, f), 1 / math.sqrt(d)),
        pre + "moe.we_up": ((n, e, d, f), 1 / math.sqrt(d)),
        pre + "moe.we_down": ((n, e, f, d), 1 / math.sqrt(f)),
        pre + "moe.ws_gate": ((n, d, fs), 1 / math.sqrt(d)),
        pre + "moe.ws_up": ((n, d, fs), 1 / math.sqrt(d)),
        pre + "moe.ws_down": ((n, fs, d), 1 / math.sqrt(fs)),
    }


def level_layout(sizes: dict, level: int):
    """The layout of accuracy level ``level`` (its widths from the ladder)."""
    return layout(ladder.level_sizes(sizes, level))


def check_weights(params: dict, sizes: dict) -> None:
    for path, (shape, _) in layout(sizes).items():
        got = tuple(leaf(params, path).shape)
        if got != shape:
            raise ValueError(f"weight {path} is {got}, the reference expects {shape}")


# ----------------------------------------------------------------------
# Rope with YaRN
def mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(dim: int, theta: float, rs: Optional[dict], device) -> torch.Tensor:
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    if rs is None:
        return base

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    return base / rs["factor"] * ramp + base * (1 - ramp)


def rope(x, positions, freq, cs_scale):
    """x (B, T, heads, d): the two halves of d rotate against each other."""
    ang = positions.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None] * cs_scale, torch.sin(ang)[:, None] * cs_scale
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope_consts(sizes: dict, device):
    m, rs = sizes["mla"], sizes.get("rope_scaling")
    nope, rope_d = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    freq = inv_freq(rope_d, sizes["rope_theta"], rs, device)
    cs, scale = 1.0, 1.0 / math.sqrt(nope + rope_d)
    if rs is not None:
        cs = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"], rs["mscale_all_dim"])
        if rs["mscale_all_dim"]:
            scale *= mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return freq, cs, scale


def mla(a, w, sizes, mat, q_block):
    """a (B, T, d) -> the attention's output (B, T, d), causal."""
    b, t, d = a.shape
    m, h, eps = sizes["mla"], sizes["num_heads"], sizes["norm_eps"]
    nope, kl, vd = m["qk_nope_head_dim"], m["kv_lora_rank"], m["v_head_dim"]
    freq, cs, scale = _rope_consts(sizes, a.device)
    pos = torch.arange(t, device=a.device)
    c_q = rms_norm(mat(a, w["w_dq"]), w["q_norm"], eps)
    q = mat(c_q, w["w_uq"].reshape(c_q.shape[-1], -1)).reshape(b, t, h, -1)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, freq, cs)
    dkv = mat(a, w["w_dkv"])
    c_kv = rms_norm(dkv[..., :kl], w["kv_norm"], eps)
    k_pe = rope(dkv[..., None, kl:], pos, freq, cs)[:, :, 0]
    k_nope = mat(c_kv, w["w_uk"].reshape(kl, -1)).reshape(b, t, h, nope)
    v = mat(c_kv, w["w_uv"].reshape(kl, -1)).reshape(b, t, h, vd)
    del q, dkv, c_kv
    out = torch.empty((b, t, h, vd), device=a.device)
    cols = torch.arange(t, device=a.device)
    for i0 in range(0, t, q_block):
        i1 = min(t, i0 + q_block)
        s = (torch.einsum("bqhk,bthk->bhqt", q_nope[:, i0:i1], k_nope[:, :i1])
             + torch.einsum("bqhk,btk->bhqt", q_pe[:, i0:i1], k_pe[:, :i1])) * scale
        allowed = cols[None, :i1] <= torch.arange(i0, i1, device=a.device)[:, None]
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        del s
        out[:, i0:i1] = torch.einsum("bhqt,bthk->bqhk", p, v[:, :i1])
        del p
    return mat(out.reshape(b, t, h * vd), w["wo"].reshape(h * vd, d))


# ----------------------------------------------------------------------
# The router and the experts held
def route(x, w, moe, mat):
    """The sigmoid group-limited router over ``x`` (T, d), in float32.
    Returns the gates and experts (T, k), and per token the routing margin:
    how far the held experts' choice lies from changing, in score units
    (inf where no held expert is near either cut). It is the smallest of:
    each held expert's biased score less the best one left out, if it is
    chosen, or the k-th chosen less it, if not (within the kept groups);
    each held group's score less the best group left out, if it is kept, or
    the last kept group less it, if not; and, where a held expert is chosen,
    the last kept group less the first left out (a group that comes in
    brings candidates that may push it out). A flip between two absent
    experts, or two groups of absent experts, leaves the held ones' choice
    as it is; it moves their gates only through the renormalisation, by the
    scores' differences over their sum of about k x 0.7, which no served
    token's logit feels at the limits used."""
    e, k, width = moe["num_experts"], moe["top_k"], _width(moe)
    g, tg = moe["n_group"], moe["topk_group"]
    gs = width // g
    scores = torch.sigmoid(mat(x, w["w_router"]))
    choice = scores + w["router_bias"]
    t = choice.shape[0]
    inf = torch.full((t,), float("inf"), device=x.device)
    group_margin, group_tie = inf, inf
    if g > 1:
        grouped = choice.view(t, g, gs)
        gscore = grouped.sort(dim=-1, descending=True, stable=True).values[..., :2].sum(-1)
        gval, gidx = gscore.sort(dim=-1, descending=True, stable=True)
        kept = torch.zeros(t, g, dtype=torch.bool, device=x.device).scatter_(1, gidx[:, :tg], True)
        choice = choice.masked_fill(~kept.repeat_interleave(gs, dim=1), float("-inf"))
        if tg < g:
            hg = -(-e // gs)                                     # the groups holding experts here
            last, first_out = gval[:, tg - 1, None], gval[:, tg, None]
            held_g = gscore[:, :hg]
            group_margin = torch.where(kept[:, :hg], held_g - first_out,
                                       last - held_g).min(-1).values
            group_tie = (last - first_out)[:, 0]
    vals, order = choice.sort(dim=-1, descending=True, stable=True)
    idx = order[:, :k]
    gates = scores.gather(1, idx)
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    is_chosen = (idx[:, :, None] == torch.arange(e, device=x.device)).any(1)     # (T, e)
    held = choice[:, :e]                                         # -inf where not kept
    expert_margin = torch.where(is_chosen, held - vals[:, k, None],
                                vals[:, k - 1, None] - held).min(-1).values
    chosen = is_chosen.any(-1)
    margin = torch.minimum(torch.minimum(expert_margin, group_margin),
                           torch.where(chosen, group_tie, inf))
    return gates * moe["router_scale"], idx, margin


def swiglu(x, wg, wu, wd, mat):
    return mat(F.silu(mat(x, wg)) * mat(x, wu), wd)


def moe(h: torch.Tensor, w: dict, moe_sizes: dict, calls: List[slice], mat: _Mat,
        near: float = 0.0) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """h (B, T, d). ``calls``: the position ranges that the program runs as
    one call each (capacity is per call, tokens taken batch-major). Returns
    the shared expert plus the held experts' part, the held pairs dropped at
    capacity, each token's routing margin (inf where no flip touches a held
    expert), and ``unsure`` (B, T): the tokens whose held experts, or whose
    place in a held expert's queue, a flip of a token of margin under
    ``near`` could change (a flip of an earlier token of the call moves a
    pair's place by one, as in ``gqa_transformer``)."""
    b, t, d = h.shape
    e, k, width = moe_sizes["num_experts"], moe_sizes["top_k"], _width(moe_sizes)
    out = swiglu(h, w["ws_gate"], w["ws_up"], w["ws_down"], mat)
    margin = torch.full((b, t), float("inf"), device=h.device)
    unsure = torch.zeros((b, t), dtype=torch.bool, device=h.device)
    dropped = 0
    for sl in calls:
        x = h[:, sl].reshape(-1, d)                              # batch-major
        gates, idx, m = route(x, w, moe_sizes, mat)
        margin[:, sl] = m.reshape(b, -1)
        c = capacity(x.shape[0], width, k)
        flat_e = idx.reshape(-1)                                 # order (token, rank)
        flat_t = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
        flat_g = gates.reshape(-1)
        onehot = F.one_hot(flat_e.clamp(max=e), e + 1)[:, :e]    # absent experts: no row
        place = (onehot.cumsum(0) - onehot).gather(1, flat_e.clamp(max=e - 1)[:, None])[:, 0]
        tie = m < near
        reach = (tie.long().cumsum(0) - tie.long()).repeat_interleave(k)
        moved = ((flat_e < e) & (place + reach >= c) & (place - reach < c)).reshape(-1, k)
        unsure[:, sl] = (tie | moved.any(-1)).reshape(b, -1)
        y = torch.zeros_like(x)
        for ex in range(e):
            sel = (flat_e == ex).nonzero()[:, 0]
            dropped += max(0, sel.numel() - c)
            sel = sel[:c]
            if sel.numel():
                y.index_add_(0, flat_t[sel], swiglu(x[flat_t[sel]], w["we_gate"][ex],
                                                    w["we_up"][ex], w["we_down"][ex], mat)
                             * flat_g[sel, None])
        out[:, sl] += y.reshape(b, -1, d)
    return out, dropped, margin, unsure


# ----------------------------------------------------------------------
# The model
def _layer_weights(params: dict, i: int) -> dict:
    """Layer ``i``'s weights upcast to float32."""
    sub = leaf(params, "layers.sub0")
    out = {}
    for part in ("attn", "moe"):
        out[part] = {k: v[i].float() for k, v in sub[part].items()}
    out["norm_mixer"], out["norm_mlp"] = sub["norm_mixer"][i].float(), sub["norm_mlp"][i].float()
    return out


@torch.no_grad()
def logits_at(sizes: dict, params: dict, tokens: torch.Tensor, n_prompt: int,
              positions: Iterable[int], *, quant: Optional[str] = None,
              near: float = 0.0, q_block: int = 256) -> Tuple[torch.Tensor, dict]:
    """Float32 logits (B, P, V) at ``positions`` of ``tokens`` (B, T): the
    prompt is ``tokens[:, :n_prompt]``, each later position one decode step
    (the program's calls, for the experts' capacity). ``sizes`` are the
    level's own. Returns the logits and ``info``: ``dropped`` (held pairs
    dropped at capacity), ``route_margin`` (B, P) and ``unsure`` (B, P), as
    ``gqa_transformer.logits_at``."""
    check_weights(params, sizes)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(sizes, params, tokens, n_prompt, list(positions), _Mat(quant),
                          near, q_block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits_at(sizes, params, tokens, n_prompt, positions, mat, near, q_block):
    b, t = tokens.shape
    eps = sizes["norm_eps"]
    calls = [slice(0, n_prompt)] + [slice(p, p + 1) for p in range(n_prompt, t)]
    x = leaf(params, "embed.embedding")[tokens].float()
    dropped = 0
    margin = torch.full((b, t), float("inf"), device=tokens.device)
    unsure = torch.zeros((b, t), dtype=torch.bool, device=tokens.device)
    for i in range(sizes["num_layers"]):
        w = _layer_weights(params, i)
        x = x + mla(rms_norm(x, w["norm_mixer"], eps), w["attn"], sizes, mat, q_block)
        y, n_drop, m, u = moe(rms_norm(x, w["norm_mlp"], eps), w["moe"], sizes["moe"],
                              calls, mat, near)
        x = x + y
        dropped += n_drop
        margin = torch.minimum(margin, m)
        unsure |= u
        del w, y
    x = rms_norm(x[:, positions], leaf(params, "final_norm").float(), eps)
    logits = mat(x, leaf(params, "embed.lm_head").float())
    return logits, {"dropped": dropped, "route_margin": margin[:, positions],
                    "unsure": unsure[:, positions]}
