"""Plain float32 reference of a decoder of GQA attention and SwiGLU MLPs,
dense or with a top-k mixture of experts (phi4-mini, mixtral).

The layer equations, from the published descriptions:

    h = x + Attn(RMSNorm(x)) ;  x' = h + MLP(RMSNorm(h))
    Attn: q, k, v = h Wq, h Wk, h Wv; RoPE (split halves, base ``rope_theta``)
          on q and k; causal softmax(q k^T / sqrt(head_dim)) v over the
          head's kv group (and the sliding window, where one is set); out Wo
    MLP:  (silu(h Wg) * (h Wu)) Wd
    MoE:  softmax over the router's logits, the top k experts per token,
          their gates renormalised to sum to 1, each expert a SwiGLU MLP
    logits = RMSNorm(x_L) E^T (tied) or RMSNorm(x_L) W_head

Departures, each also the system's documented semantics: an expert takes at
most ``capacity`` tokens of one call (the slots per expert are
``ceil(T k 1.25 / E)`` rounded up to a multiple of 8, at least 8, for the T
tokens of the call), and the tokens past it, in token-major order, are
dropped; a call is the prompt of a batch, or one decode step of it. The
published Mixtral drops nothing; at a decode step (T <= 8) nothing can drop.

Everything is computed in float32 from the weights handed in, with TF32
off, layer by layer (each layer's weights are upcast when it runs) and the
attention in blocks of query rows. ``quant="fp8"`` is the control: every
product with a weight takes both operands rounded to float8 e4m3 (scaled
per row of the activations and per output column of the weight).

Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from portbench.reference import ladder

CAPACITY_FACTOR = 1.25
FP8_MAX = 448.0          # largest finite float8 e4m3fn


# ----------------------------------------------------------------------
# What this reference computes, and the tree the weights are made in
SUPPORTED = {"qk_norm": False, "attn_logit_softcap": 0.0, "final_logit_softcap": 0.0,
             "pos_kind": "rope", "mlp_kind": "swiglu", "post_norms": False,
             "zero_centered_norm": False}


def check_supported(sizes: dict) -> None:
    """Raises where a configuration asks for what this reference lacks."""
    bad = {k: sizes.get(k) for k, v in SUPPORTED.items() if sizes.get(k) != v}
    if sizes.get("attention_kind") not in ("full", "sliding"):
        bad["attention_kind"] = sizes.get("attention_kind")
    moe = sizes.get("moe")
    if moe and (moe.get("num_shared_experts", 0) or moe.get("router_scale", 1.0) != 1.0
                or moe.get("first_moe_layer", 0) or moe.get("moe_every", 1) != 1):
        bad["moe"] = moe
    if bad:
        raise ValueError(f"the gqa_transformer reference does not compute {bad}")


def layout(sizes: dict) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Leaf path -> (shape, std); std None is a norm scale of ones. Leaves of
    the layer stack carry the layer count first. Each product's weight has
    std 1/sqrt(its fan-in), so the logits are of about unit size. A tied
    embedding is the head too and has std 1/sqrt(d_model). An untied one has
    std 1: each token's own vector then leads the residual stream, and a
    router spreads the tokens over its experts as a trained router does (with
    1/sqrt(d_model), the near-uniform attention of random weights gives every
    token the same direction, a few experts take most tokens and pass their
    capacity, and which tokens drop turns on rounding; see PERF.md)."""
    d, n_layers = sizes["d_model"], sizes["num_layers"]
    h, kv, hd = sizes["num_heads"], sizes["num_kv_heads"], sizes["head_dim"]
    vocab = sizes["vocab_size"]
    tied = sizes["tie_embeddings"]
    out = {"embed.embedding": ((vocab, d), 1 / math.sqrt(d) if tied else 1.0)}
    if not tied:
        out["embed.lm_head"] = ((d, vocab), 1 / math.sqrt(d))
    out["final_norm"] = ((d,), None)
    pre = "layers.sub0."
    out[pre + "norm_mixer"] = ((n_layers, d), None)
    out[pre + "attn.wq"] = ((n_layers, d, h, hd), 1 / math.sqrt(d))
    out[pre + "attn.wk"] = ((n_layers, d, kv, hd), 1 / math.sqrt(d))
    out[pre + "attn.wv"] = ((n_layers, d, kv, hd), 1 / math.sqrt(d))
    out[pre + "attn.wo"] = ((n_layers, h, hd, d), 1 / math.sqrt(h * hd))
    out[pre + "norm_mlp"] = ((n_layers, d), None)
    moe = sizes.get("moe")
    if moe:
        e, f = moe["num_experts"], moe["d_ff_expert"]
        out[pre + "moe.w_router"] = ((n_layers, d, e), 1 / math.sqrt(d))
        out[pre + "moe.we_gate"] = ((n_layers, e, d, f), 1 / math.sqrt(d))
        out[pre + "moe.we_up"] = ((n_layers, e, d, f), 1 / math.sqrt(d))
        out[pre + "moe.we_down"] = ((n_layers, e, f, d), 1 / math.sqrt(f))
    else:
        f = sizes["d_ff"]
        out[pre + "mlp.w_gate"] = ((n_layers, d, f), 1 / math.sqrt(d))
        out[pre + "mlp.w_up"] = ((n_layers, d, f), 1 / math.sqrt(d))
        out[pre + "mlp.w_down"] = ((n_layers, f, d), 1 / math.sqrt(f))
    return out


def leaf(tree: dict, path: str) -> torch.Tensor:
    for part in path.split("."):
        tree = tree[part]
    return tree


# ----------------------------------------------------------------------
# Arithmetic
def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Mat:
    """Products with weights, in float32 or (the control) in float8."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n), both float32."""
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, heads, hd); the two halves of hd rotate against each other."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.float()[:, None] * freqs                      # (T, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: Optional[int], q_block: int) -> torch.Tensor:
    """q (B,T,H,hd), k/v (B,T,KV,hd), causal (and windowed); -> (B,T,H,hd)."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    out = torch.empty_like(qg)
    scale = 1.0 / math.sqrt(hd)
    cols = torch.arange(t, device=q.device)
    for i0 in range(0, t, q_block):
        i1 = min(t, i0 + q_block)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg[:, i0:i1], k[:, :i1]) * scale
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        allowed = cols[None, :i1] <= rows
        if window is not None:
            allowed &= cols[None, :i1] > rows - window
        s = s.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, i0:i1] = torch.einsum("bkgqt,btkd->bqkgd", p, v[:, :i1])
    return out.reshape(b, t, h, hd)


def capacity(num_tokens: int, num_experts: int, top_k: int) -> int:
    c = int(math.ceil(num_tokens * top_k * CAPACITY_FACTOR / num_experts))
    return max(8, ((c + 7) // 8) * 8)


def moe(h: torch.Tensor, w: dict, moe_sizes: dict, calls: List[slice],
        mat: _Mat, near: float = 0.0) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """h (B, T, d). ``calls``: the position ranges that the program runs as
    one call each (capacity is per call, tokens taken batch-major). Returns
    the experts' sum, the number of (token, expert) pairs dropped, each
    token's routing margin (B, T): the router logit of its k-th expert less
    that of the first expert it does not take, and ``unsure`` (B, T): the
    tokens whose experts, or whose place in an expert's queue, a flip of a
    token of margin under ``near`` could change. A flip of an earlier token
    of the call moves a pair's place by one, so a pair whose place lies
    within that many of the capacity may be kept on one side and dropped
    on the other."""
    b, t, d = h.shape
    e, k = moe_sizes["num_experts"], moe_sizes["top_k"]
    out = torch.zeros_like(h)
    margin = torch.full((b, t), float("inf"), device=h.device)
    unsure = torch.zeros((b, t), dtype=torch.bool, device=h.device)
    dropped = 0
    for sl in calls:
        x = h[:, sl].reshape(-1, d)                              # batch-major
        logits = x @ w["w_router"]
        if k < e:
            top = torch.topk(logits, k + 1, dim=-1).values
            margin[:, sl] = (top[:, k - 1] - top[:, k]).reshape(b, -1)
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :k], idx[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        c = capacity(x.shape[0], e, k)
        y = torch.zeros_like(x)
        flat_e = idx.reshape(-1)                         # order (token, rank)
        flat_t = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
        flat_g = gates.reshape(-1)
        onehot = torch.nn.functional.one_hot(flat_e, e)
        place = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
        tie = margin[:, sl].reshape(-1) < near
        reach = (tie.long().cumsum(0) - tie.long()).repeat_interleave(k)
        moved = ((place + reach >= c) & (place - reach < c)).reshape(-1, k).any(-1)
        unsure[:, sl] = (tie | moved).reshape(b, -1)
        for ex in range(e):
            sel = (flat_e == ex).nonzero()[:, 0]
            dropped += max(0, sel.numel() - c)
            sel = sel[:c]
            if sel.numel() == 0:
                continue
            xt = x[flat_t[sel]]
            hid = torch.nn.functional.silu(mat(xt, w["we_gate"][ex])) * mat(xt, w["we_up"][ex])
            y.index_add_(0, flat_t[sel], mat(hid, w["we_down"][ex]) * flat_g[sel, None])
        out[:, sl] = y.reshape(b, -1, d)
    return out, dropped, margin, unsure


def _layer_weights(params: dict, sizes: dict, i: int) -> dict:
    """Layer ``i``'s weights upcast to float32 in (k, n) product layout."""
    d = sizes["d_model"]
    g = lambda p: leaf(params, "layers.sub0." + p)[i].float()     # noqa: E731
    w = {"norm_mixer": g("norm_mixer"), "norm_mlp": g("norm_mlp"),
         "wq": g("attn.wq").reshape(d, -1), "wk": g("attn.wk").reshape(d, -1),
         "wv": g("attn.wv").reshape(d, -1), "wo": g("attn.wo").reshape(-1, d)}
    if sizes.get("moe"):
        w.update({n: g("moe." + n) for n in ("w_router", "we_gate", "we_up", "we_down")})
    else:
        w.update({n: g("mlp." + n) for n in ("w_gate", "w_up", "w_down")})
    return w


def check_weights(params: dict, sizes: dict) -> None:
    """The weights handed in have the layout that ``sizes`` implies."""
    for path, (shape, _) in layout(sizes).items():
        got = tuple(leaf(params, path).shape)
        if got != shape:
            raise ValueError(f"weight {path} is {got}, the reference expects {shape}")


@torch.no_grad()
def logits_at(sizes: dict, params: dict, tokens: torch.Tensor, n_prompt: int,
              positions: Iterable[int], *, quant: Optional[str] = None,
              near: float = 0.0, q_block: int = 256) -> Tuple[torch.Tensor, dict]:
    """Float32 logits (B, P, V) at ``positions`` of ``tokens`` (B, T): the
    prompt is ``tokens[:, :n_prompt]``, each later position one decode step
    (the program's calls, for the experts' capacity). ``sizes`` are the
    level's own (``ladder.level_sizes``). Returns the logits and ``info``:
    ``dropped``, the (token, expert) pairs that the capacity dropped, and
    ``route_margin`` (B, P), each position's smallest routing margin over
    the layers (inf without experts), and ``unsure`` (B, P): the positions
    that ``moe`` finds unsure at some layer for a margin of ``near``."""
    check_weights(params, sizes)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(sizes, params, tokens, n_prompt, list(positions),
                          _Mat(quant), near, q_block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits_at(sizes, params, tokens, n_prompt, positions, mat, near, q_block):
    b, t = tokens.shape
    h, kv, hd = sizes["num_heads"], sizes["num_kv_heads"], sizes["head_dim"]
    eps, theta = sizes["norm_eps"], sizes["rope_theta"]
    window = sizes["sliding_window"] if sizes["attention_kind"] == "sliding" else None
    calls = [slice(0, n_prompt)] + [slice(p, p + 1) for p in range(n_prompt, t)]
    pos = torch.arange(t, device=tokens.device)
    x = leaf(params, "embed.embedding")[tokens].float()
    dropped = 0
    margin = torch.full((b, t), float("inf"), device=tokens.device)
    unsure = torch.zeros((b, t), dtype=torch.bool, device=tokens.device)
    for i in range(sizes["num_layers"]):
        w = _layer_weights(params, sizes, i)
        a = rms_norm(x, w["norm_mixer"], eps)
        q = rope(mat(a, w["wq"]).reshape(b, t, h, hd), pos, theta)
        k = rope(mat(a, w["wk"]).reshape(b, t, kv, hd), pos, theta)
        v = mat(a, w["wv"]).reshape(b, t, kv, hd)
        x = x + mat(attention(q, k, v, window, q_block).reshape(b, t, h * hd), w["wo"])
        a = rms_norm(x, w["norm_mlp"], eps)
        if sizes.get("moe"):
            y, n_drop, m, u = moe(a, w, sizes["moe"], calls, mat, near)
            dropped += n_drop
            margin = torch.minimum(margin, m)
            unsure |= u
        else:
            y = mat(torch.nn.functional.silu(mat(a, w["w_gate"])) * mat(a, w["w_up"]),
                    w["w_down"])
        x = x + y
        del w, a, q, k, v, y
    x = rms_norm(x[:, positions], leaf(params, "final_norm").float(), eps)
    if sizes["tie_embeddings"]:
        head = leaf(params, "embed.embedding").float().T
    else:
        head = leaf(params, "embed.lm_head").float()
    return mat(x, head), {"dropped": dropped, "route_margin": margin[:, positions],
                          "unsure": unsure[:, positions]}


def level_layout(sizes: dict, level: int):
    """The layout of accuracy level ``level`` (its widths from the ladder)."""
    return layout(ladder.level_sizes(sizes, level))
