"""Plain float32 reference of RWKV-6 "Finch" (arXiv:2404.05892 section 4, the
authors' ``RWKV_Tmix_x060`` and ``RWKV_CMix_x060``), for the port's tests:
plain ``torch`` operations, a loop over time, no kernel, state cache or
batching, and nothing of the port or of JAX.

The block equations (LN: LayerNorm with scale and bias):

    x = LN0(embedding[tokens])                           (before block 0)
    x = x + TimeMix(LN1(x)) ;  x = x + ChannelMix(LN2(x))
    logits = LN_out(x) W_head                            (untied)

    TimeMix: xx = x_{t-1} - x_t (x_{-1} = 0)
             m = tanh((x + xx maa_x) W1) W2, one slice m_i for each of
                 r, k, v, w, g (W1 (d, 5 R) cut into 5 blocks of R columns,
                 W2 (5, R, d))
             x_i = x + xx (maa_i + m_i)
             r, k, v, g = x_r W_r, x_k W_k, x_v W_v, silu(x_g W_g)
             w = exp(-exp(w0 + tanh(x_w A) B))           (per channel, (0, 1))
             per head, over its Dk x Dv state S (zero at the start):
                 y_t = r_t (S + diag(u) k_t^T v_t);  S = diag(w_t) S + k_t^T v_t
             out = (GroupNorm_H(y) * g) W_o              (eps ``head_norm_eps``)
    ChannelMix: x_k = x + xx cm_mix_0, x_r = x + xx cm_mix_1
             out = sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)

The parameters are read by the port's names (``maa_x``, ``mix`` in the order
r, k, v, w, g, ``maa_w1``, ``maa_w2``, ``decay_*``, ``bonus_u``, ``ln_*`` for
the GroupNorm, ``cm_*``; ``norm_mixer`` / ``norm_mlp`` and their ``_bias``,
``embed_norm``, ``final_norm``); a layer's are ``leaf[i]`` of the stacked
tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def group_norm(y, heads, scale, bias, eps):
    """``torch.nn.GroupNorm(heads, C)`` over the channels of y (..., C)."""
    yh = y.reshape(*y.shape[:-1], heads, -1)
    mu = yh.mean(-1, keepdim=True)
    var = (yh - mu).square().mean(-1, keepdim=True)
    return ((yh - mu) / torch.sqrt(var + eps)).reshape(y.shape) * scale + bias


def _prev(x):
    """x_{t-1} for every t, zero before the first token."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def time_mix(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    b, t, d = x.shape
    hd = cfg["ssm"]["wkv_head_dim"]
    heads, rank = d // hd, cfg["ssm"]["token_shift_lora"]
    xx = _prev(x) - x
    m = torch.tanh((x + xx * p["maa_x"]) @ p["maa_w1"])                  # (B, T, 5R)
    lerp = [x + xx * (p["mix"][i] + m[..., i * rank:(i + 1) * rank] @ p["maa_w2"][i])
            for i in range(5)]
    xr, xk, xv, xw, xg = lerp
    r = (xr @ p["w_r"]).reshape(b, t, heads, hd)
    k = (xk @ p["w_k"]).reshape(b, t, heads, hd)
    v = (xv @ p["w_v"]).reshape(b, t, heads, hd)
    g = F.silu(xg @ p["w_g"])
    w = torch.exp(-torch.exp(p["decay_w0"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]))
    w = w.reshape(b, t, heads, hd)
    u = p["bonus_u"]                                                     # (H, Dk)
    state = torch.zeros(b, heads, hd, hd, device=x.device)
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]                   # (B, H, Dk, Dv)
        ys.append((r[:, i, :, :, None] * (state + u[:, :, None] * kv)).sum(2))
        state = w[:, i, :, :, None] * state + kv
    y = torch.stack(ys, 1).reshape(b, t, d)
    y = group_norm(y, heads, p["ln_scale"], p["ln_bias"], cfg["ssm"]["head_norm_eps"])
    return (y * g) @ p["w_o"]


def channel_mix(p: dict, x: torch.Tensor) -> torch.Tensor:
    xx = _prev(x) - x
    xk = x + xx * p["cm_mix"][0]
    xr = x + xx * p["cm_mix"][1]
    return torch.sigmoid(xr @ p["cm_r"]) * (torch.relu(xk @ p["cm_k"]).square() @ p["cm_v"])


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Float32 logits (B, T, V) of every position of ``tokens`` (B, T), with
    TF32 off. ``cfg``: ``dataclasses.asdict`` of the model's configuration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        eps = cfg["norm_eps"]
        f = lambda t: t.float()                                       # noqa: E731
        x = f(params["embed"]["embedding"])[tokens]
        x = layer_norm(x, f(params["embed_norm"]), f(params["embed_norm_bias"]), eps)
        sub = params["layers"]["sub0"]
        for i in range(cfg["num_layers"]):
            p = {k: f(v[i]) for k, v in sub["rwkv"].items()}
            ln = {k: f(v[i]) for k, v in sub.items() if k != "rwkv"}
            x = x + time_mix(cfg, p, layer_norm(x, ln["norm_mixer"], ln["norm_mixer_bias"], eps))
            x = x + channel_mix(p, layer_norm(x, ln["norm_mlp"], ln["norm_mlp_bias"], eps))
        x = layer_norm(x, f(params["final_norm"]), f(params["final_norm_bias"]), eps)
        return x @ f(params["embed"]["lm_head"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
