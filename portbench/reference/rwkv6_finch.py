"""Plain float32 reference of RWKV-6 "Finch" (rwkv6-1.6b), from the published
description (arXiv:2404.05892 section 4) and the authors' ``RWKV_Tmix_x060``
and ``RWKV_CMix_x060``.

The block equations (LN: LayerNorm with scale and bias):

    x = LN0(embedding[tokens])                               (before block 0)
    x = x + TimeMix(LN1(x)) ;  x = x + ChannelMix(LN2(x))
    logits = LN_out(x_L) W_head                              (untied)

    TimeMix: xx = x_{t-1} - x_t (x_{-1} = 0)
             m = tanh((x + xx maa_x) W1) W2: a rank-R slice of W1's columns
                 and one W2[i] for each of r, k, v, w, g ("ddlerp")
             x_i = x + xx (mix_i + m_i)
             r, k, v, g = x_r W_r, x_k W_k, x_v W_v, silu(x_g W_g)
             w = exp(-exp(w0 + tanh(x_w A) B)), per channel in (0, 1)
             per head, a Dk x Dv state S from zero:
                 y_t = r_t (S + diag(u) k_t^T v_t);  S = diag(w_t) S + k_t^T v_t
             out = (GroupNorm_H(y) * g) W_o
    ChannelMix: x_k = x + xx cm_mix_0, x_r = x + xx cm_mix_1
             out = sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)

The recurrence runs in chunks of ``CHUNK`` tokens: within a chunk every
decay product is the exponential of a difference of cumulative log-decays
that is at most 0 (no quotient of small numbers), and the state carries
from chunk to chunk; ``wkv_loop`` is the token-by-token form it is held
against. Nothing routes, so every served token is counted (``unsure`` all
False) and nothing drops.

Everything is computed in float32 from the weights handed in, with TF32 off,
layer by layer (each layer's weights are upcast when it runs).
``quant="fp8"`` is the control: every product with a weight takes both
operands rounded to float8 e4m3 (scaled per row of the activations and per
output column of the weight), the LoRAs' and the head's included.

Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import ladder
from portbench.reference.gqa_transformer import _Mat, leaf

CHUNK = 32
DECAY_LORA = 64          # the decay LoRA's rank (x060 below n_embd 4096)

# the random weights' spread (std of a normal around 0); see ``layout``
MIX_STD = 0.5            # mix, maa_x, cm_mix: token-shift interpolation weights
DECAY_W0_STD = 0.5       # decay base w0
DECAY_B_STD = 0.5 / math.sqrt(DECAY_LORA)
BONUS_STD = 0.5          # bonus u
BIAS_STD = 0.1           # LayerNorm and GroupNorm biases
KEY_GATE_GAIN = 0.1      # w_k and w_g: the x060 init's gain for key and gate


# ----------------------------------------------------------------------
# What this reference computes, and the tree the weights are made in
SUPPORTED = {"attention_kind": "none", "pos_kind": "none", "norm_kind": "layer",
             "embed_norm": True, "tie_embeddings": False, "frontend_stub": False,
             "final_logit_softcap": 0.0}


def check_supported(sizes: dict) -> None:
    """Raises where a configuration asks for what this reference lacks."""
    bad = {k: sizes.get(k) for k, v in SUPPORTED.items() if sizes.get(k, v) != v}
    for k in ("norm_kind", "embed_norm"):
        if k not in sizes:
            bad[k] = None
    ssm = sizes.get("ssm") or {}
    if (ssm.get("kind") != "rwkv6" or not ssm.get("token_shift_lora")
            or not ssm.get("head_norm_eps")
            or sizes["d_model"] % ssm.get("wkv_head_dim", 0)):
        bad["ssm"] = ssm
    if sizes.get("moe") or sizes.get("hybrid_block_size", 1) > 1:
        bad["layers"] = {"moe": sizes.get("moe"),
                         "hybrid_block_size": sizes.get("hybrid_block_size")}
    if bad:
        raise ValueError(f"the rwkv6_finch reference does not compute {bad}")


def layout(sizes: dict) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Leaf path -> (shape, std); std None is a norm scale of ones. Leaves of
    the layer stack carry the layer count first. Each product's weight has
    std 1/sqrt(its fan-in) (a LoRA's second factor 1/sqrt(rank), the decay
    LoRA's 0.5/sqrt(rank)), so r, v and the logits are of about unit size,
    but key and gate take ``KEY_GATE_GAIN`` times that, the x060 init's gain
    for them: at gain 1 the random model is chaotic in bfloat16, and a
    rounding grows through 24 layers into other tokens. The untied
    embedding has std 1 (ln0 normalises it). The others, as
    ``assumed`` in the configuration file says: interpolation weights
    ``MIX_STD``, the decay base ``DECAY_W0_STD`` (with the LoRA term, w0 + ...
    has a spread of about 0.6, so exp(-exp(.)) lies in about (0.04, 0.74) at
    two standard deviations: inside (0, 1) and away from both ends), the
    bonus ``BONUS_STD`` and every norm's bias ``BIAS_STD``."""
    d, n = sizes["d_model"], sizes["num_layers"]
    f, vocab = sizes["d_ff"], sizes["vocab_size"]
    hd = sizes["ssm"]["wkv_head_dim"]
    rank = sizes["ssm"]["token_shift_lora"]
    out = {"embed.embedding": ((vocab, d), 1.0),
           "embed.lm_head": ((d, vocab), 1 / math.sqrt(d)),
           "final_norm": ((d,), None), "final_norm_bias": ((d,), BIAS_STD),
           "embed_norm": ((d,), None), "embed_norm_bias": ((d,), BIAS_STD)}
    pre = "layers.sub0."
    for name in ("norm_mixer", "norm_mlp"):
        out[pre + name] = ((n, d), None)
        out[pre + name + "_bias"] = ((n, d), BIAS_STD)
    tm = pre + "rwkv."
    out.update({
        tm + "mix": ((n, 5, d), MIX_STD),
        tm + "maa_x": ((n, d), MIX_STD),
        tm + "maa_w1": ((n, d, 5 * rank), 1 / math.sqrt(d)),
        tm + "maa_w2": ((n, 5, rank, d), 1 / math.sqrt(rank)),
        tm + "w_r": ((n, d, d), 1 / math.sqrt(d)),
        tm + "w_k": ((n, d, d), KEY_GATE_GAIN / math.sqrt(d)),
        tm + "w_v": ((n, d, d), 1 / math.sqrt(d)),
        tm + "w_g": ((n, d, d), KEY_GATE_GAIN / math.sqrt(d)),
        tm + "w_o": ((n, d, d), 1 / math.sqrt(d)),
        tm + "decay_w0": ((n, d), DECAY_W0_STD),
        tm + "decay_a": ((n, d, DECAY_LORA), 1 / math.sqrt(d)),
        tm + "decay_b": ((n, DECAY_LORA, d), DECAY_B_STD),
        tm + "bonus_u": ((n, d // hd, hd), BONUS_STD),
        tm + "ln_scale": ((n, d), None),
        tm + "ln_bias": ((n, d), BIAS_STD),
        tm + "cm_mix": ((n, 2, d), MIX_STD),
        tm + "cm_k": ((n, d, f), 1 / math.sqrt(d)),
        tm + "cm_v": ((n, f, d), 1 / math.sqrt(f)),
        tm + "cm_r": ((n, d, d), 1 / math.sqrt(d)),
    })
    return out


def level_layout(sizes: dict, level: int):
    """The layout of accuracy level ``level`` (its widths from the ladder)."""
    return layout(ladder.level_sizes(sizes, level))


def check_weights(params: dict, sizes: dict) -> None:
    """The weights handed in have the layout that ``sizes`` implies."""
    for path, (shape, _) in layout(sizes).items():
        got = tuple(leaf(params, path).shape)
        if got != shape:
            raise ValueError(f"weight {path} is {got}, the reference expects {shape}")


# ----------------------------------------------------------------------
# Arithmetic
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def group_norm(y: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``torch.nn.GroupNorm(groups, C)`` over the channels of y (..., C)."""
    yh = y.unflatten(-1, (groups, -1))
    mu = yh.mean(-1, keepdim=True)
    var = (yh - mu).square().mean(-1, keepdim=True)
    return ((yh - mu) * torch.rsqrt(var + eps)).flatten(-2) * scale + bias


def wkv_loop(r, k, v, log_w, u) -> torch.Tensor:
    """The recurrence token by token: r, k, log_w (B, T, H, Dk), v (B, T, H,
    Dv), u (H, Dk), the state zero at the start; returns y (B, T, H, Dv)."""
    b, t, h, dk = r.shape
    s = torch.zeros(b, h, dk, v.shape[-1], device=r.device)
    w = torch.exp(log_w)
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        ys.append((r[:, i, :, :, None] * (s + u[:, :, None] * kv)).sum(2))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(ys, 1)


def wkv_chunked(r, k, v, log_w, u, chunk: int = CHUNK) -> torch.Tensor:
    """``wkv_loop``'s recurrence in chunks of ``chunk`` tokens. Within a
    chunk, with c the cumulative log-decay (inclusive) and c' = c - log w
    (exclusive): y_t = (r_t e^{c'_t}) S_0 + sum_{s<t} (sum_k r_tk k_sk
    e^{c'_tk - c_sk}) v_s + (r_t u k_t) v_t, and the state at the chunk's end
    is e^{c_end} S_0 + sum_s (k_s e^{c_end - c_s})^T v_s; every exponent is
    at most 0. The cumulative sums and their differences are taken in
    float64, so that an exponent is as exact as the loop's running product
    (in float32 they lose some 1e-5 of a unit output); the rest is float32."""
    b, t, h, dk = r.shape
    s = torch.zeros(b, h, dk, v.shape[-1], device=r.device)
    y = torch.empty(b, t, h, v.shape[-1], device=r.device)
    bonus = (r * u * k).sum(-1, keepdim=True) * v                     # s == t
    for c0 in range(0, t, chunk):
        sl = slice(c0, min(t, c0 + chunk))
        rc, kc, vc = r[:, sl], k[:, sl], v[:, sl]
        lw = log_w[:, sl].double()
        cum = lw.cumsum(1)
        excl = cum - lw
        n = rc.shape[1]
        earlier = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
        diff = (excl[:, :, None] - cum[:, None, :]).masked_fill(
            ~earlier[None, :, :, None, None], float("-inf"))            # (B, t, s, H, Dk)
        decay = torch.exp(diff).float()
        a = (rc[:, :, None] * kc[:, None, :] * decay).sum(-1)           # (B, t, s, H)
        y[:, sl] = (torch.einsum("bthk,bhkv->bthv", rc * torch.exp(excl).float(), s)
                    + torch.einsum("btsh,bshv->bthv", a, vc) + bonus[:, sl])
        to_end = torch.exp(cum[:, -1:] - cum).float()
        s = (torch.exp(cum[:, -1]).float()[..., None] * s
             + torch.einsum("bshk,bshv->bhkv", kc * to_end, vc))
    return y


def _prev(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def time_mix(x: torch.Tensor, w: dict, sizes: dict, mat: _Mat) -> torch.Tensor:
    b, t, d = x.shape
    hd = sizes["ssm"]["wkv_head_dim"]
    heads, rank = d // hd, sizes["ssm"]["token_shift_lora"]
    xx = _prev(x) - x
    m = torch.tanh(mat(x + xx * w["maa_x"], w["maa_w1"]))               # (B, T, 5R)
    xr, xk, xv, xw, xg = (x + xx * (w["mix"][i] + mat(m[..., i * rank:(i + 1) * rank],
                                                       w["maa_w2"][i]))
                          for i in range(5))
    r = mat(xr, w["w_r"]).unflatten(-1, (heads, hd))
    k = mat(xk, w["w_k"]).unflatten(-1, (heads, hd))
    v = mat(xv, w["w_v"]).unflatten(-1, (heads, hd))
    g = F.silu(mat(xg, w["w_g"]))
    log_w = -torch.exp(w["decay_w0"] + mat(torch.tanh(mat(xw, w["decay_a"])), w["decay_b"]))
    y = wkv_chunked(r, k, v, log_w.unflatten(-1, (heads, hd)), w["bonus_u"]).flatten(-2)
    y = group_norm(y, heads, w["ln_scale"], w["ln_bias"], sizes["ssm"]["head_norm_eps"])
    return mat(y * g, w["w_o"])


def channel_mix(x: torch.Tensor, w: dict, mat: _Mat) -> torch.Tensor:
    xx = _prev(x) - x
    xk = x + xx * w["cm_mix"][0]
    xr = x + xx * w["cm_mix"][1]
    return torch.sigmoid(mat(xr, w["cm_r"])) * mat(torch.relu(mat(xk, w["cm_k"])).square(),
                                                   w["cm_v"])


@torch.no_grad()
def logits_at(sizes: dict, params: dict, tokens: torch.Tensor, n_prompt: int,
              positions: Iterable[int], *, quant: Optional[str] = None,
              near: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """Float32 logits (B, P, V) at ``positions`` of ``tokens`` (B, T); the
    prompt is ``tokens[:, :n_prompt]`` and each later position one decode
    step, which a recurrence computes as the full sequence does. ``sizes``
    are the level's own (``ladder.level_sizes``). ``info``: ``dropped`` 0 and
    ``unsure`` (B, P) all False (nothing routes; ``near`` is not used)."""
    check_weights(params, sizes)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(sizes, params, tokens, list(positions), _Mat(quant))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits_at(sizes, params, tokens, positions, mat):
    eps = sizes["norm_eps"]
    f = lambda p: leaf(params, p).float()                                 # noqa: E731
    x = leaf(params, "embed.embedding")[tokens].float()
    x = layer_norm(x, f("embed_norm"), f("embed_norm_bias"), eps)
    for i in range(sizes["num_layers"]):
        w = {k: v[i].float() for k, v in leaf(params, "layers.sub0.rwkv").items()}
        ln = {k: f("layers.sub0." + k)[i] for k in ("norm_mixer", "norm_mixer_bias",
                                                     "norm_mlp", "norm_mlp_bias")}
        x = x + time_mix(layer_norm(x, ln["norm_mixer"], ln["norm_mixer_bias"], eps),
                         w, sizes, mat)
        x = x + channel_mix(layer_norm(x, ln["norm_mlp"], ln["norm_mlp_bias"], eps), w, mat)
        del w
    x = layer_norm(x[:, positions], f("final_norm"), f("final_norm_bias"), eps)
    b = tokens.shape[0]
    return mat(x, f("embed.lm_head")), {
        "dropped": 0, "unsure": torch.zeros((b, len(positions)), dtype=torch.bool,
                                             device=tokens.device)}
