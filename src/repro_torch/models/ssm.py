"""State-space / linear-recurrence mixers: Mamba (jamba) and RWKV6 (Finch).

The recurrences run as a Python loop over time with the state vectorised
over (batch, channels) on the reference path (``use_kernel=False``, and every
decode step); the prefill of the serving path hands them to the CUDA kernels
``repro_torch.kernels.ssm_scan`` (K3) and ``rwkv6_wkv`` (K4) through
``kernels.ops``.

Decode is a single recurrence step against a carried state, O(1) in the
sequence length.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKV_DECAY_LORA, ModelConfig
from repro_torch.core import trace
from repro_torch.models.layers import (ParamSpec, ParamTree, layer_norm,
                                       resolve_device)


# ======================================================================
# Mamba (selective scan, mamba1-style as used by Jamba)
class MambaState(NamedTuple):
    h: torch.Tensor         # (B, d_in, N) SSM state, fp32
    conv: torch.Tensor      # (B, d_conv-1, d_in) rolling conv window


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def mamba_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    r = _dt_rank(cfg)
    return {
        "w_in": ParamSpec((d, 2 * d_in), ("d_model", "d_ff")),
        "w_conv": ParamSpec((s.d_conv, d_in), (None, "d_ff")),
        "b_conv": ParamSpec((d_in,), ("d_ff",), init="zeros"),
        "w_x": ParamSpec((d_in, r + 2 * s.d_state), ("d_ff", None)),
        "w_dt": ParamSpec((r, d_in), (None, "d_ff")),
        "b_dt": ParamSpec((d_in,), ("d_ff",), init="zeros"),
        "a_log": ParamSpec((d_in, s.d_state), ("d_ff", None), init="ones"),
        "d_skip": ParamSpec((d_in,), ("d_ff",), init="ones"),
        "w_out": ParamSpec((d_in, d), ("d_ff", "d_model")),
    }


def _mamba_inner(cfg: ModelConfig, p: ParamTree, xz: torch.Tensor,
                 conv_state: torch.Tensor | None):
    """Shared projections for a window of tokens.
    xz: (B, S, 2*d_in); conv_state: (B, d_conv-1, d_in), None for zeros.
    Returns (u, dt, Bm, Cm, z, new_conv_state)."""
    s = cfg.ssm
    r = _dt_rank(cfg)
    x_part, z = xz.chunk(2, dim=-1)
    seq = x_part.shape[1]

    # depthwise causal conv over time, seeded with the carried window
    xc = (F.pad(x_part, (0, 0, s.d_conv - 1, 0)) if conv_state is None
          else torch.cat([conv_state, x_part], dim=1))          # (B, S+c-1, d_in)
    w = p["w_conv"].to(xz.dtype)                                # (c, d_in)
    u = xc[:, 0:seq] * w[0]
    for i in range(1, s.d_conv):
        u = u + xc[:, i:i + seq] * w[i]
    u = F.silu(u + p["b_conv"].to(xz.dtype))
    new_conv = xc[:, seq:]                                      # the last c-1 tokens

    proj = u @ p["w_x"].to(xz.dtype)                            # (B,S,r+2N)
    dt = F.softplus(proj[..., :r] @ p["w_dt"].to(xz.dtype)
                    + p["b_dt"].to(xz.dtype))                   # (B,S,d_in)
    bm = proj[..., r:r + s.d_state].float()                     # (B,S,N)
    cm = proj[..., r + s.d_state:].float()                      # (B,S,N)
    return u, dt, bm, cm, z, new_conv


def mamba_apply_dense(cfg: ModelConfig, p: ParamTree, x: torch.Tensor,
                      state: MambaState | None = None, use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence selective scan. x: (B, S, d); ``state`` None is the
    zero state.

    ``use_kernel`` routes the recurrence through the K3 kernel when the state
    is fresh (None) and there is more than one token (the engine always
    prefills from scratch); the kernel adds the skip term in fp32 before its
    cast, the loop path adds it in ``x.dtype`` after the cast, as in the JAX
    package."""
    b, seq, _ = x.shape
    xz = x @ p["w_in"].to(x.dtype)
    u, dt, bm, cm, z, new_conv = _mamba_inner(cfg, p, xz,
                                              None if state is None else state.conv)

    a = -torch.exp(p["a_log"].float())                          # (d_in, N)

    if use_kernel and state is None and seq > 1:
        from repro_torch.kernels import ops as kops
        y, h_final = kops.ssm_scan(u, dt, bm, cm, a, p["d_skip"].float())
        y = y.to(x.dtype)
    else:
        h = (torch.zeros((b,) + a.shape, dtype=torch.float32, device=x.device)
             if state is None else state.h.float())
        dtf = dt.float()
        ys = []
        for t in range(seq):
            da = torch.exp(dtf[:, t, :, None] * a)              # (B,d_in,N)
            h = da * h + (dtf[:, t] * u[:, t].float())[..., None] * bm[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
        h_final = h
        y = torch.stack(ys, dim=1).to(x.dtype)                  # (B,S,d_in)
        y = y + u * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["w_out"].to(x.dtype)
    return out, MambaState(h=h_final, conv=new_conv)


def mamba_apply_decode(cfg: ModelConfig, p: ParamTree, x: torch.Tensor,
                       state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step. x: (B, 1, d)."""
    return mamba_apply_dense(cfg, p, x, state)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> MambaState:
    """Zeroed state on ``device`` (None: the card)."""
    device = resolve_device(device)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, d_in, s.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype, device=device))


# ======================================================================
# RWKV6 (Finch): data-dependent token shift and decay, time-mix + channel-mix
#
# As published (arXiv:2404.05892 section 4; ``RWKV_Tmix_x060``): with xx the
# previous token less this one, each of r, k, v, w, g reads
# x + xx * (maa + m), where m is a LoRA of x + xx * maa_x ("ddlerp"); the
# decay is w = exp(-exp(w0 + tanh(x_w A) B)); the recurrence gives
# y = r . (S + u k^T v), then S = w S + k^T v, per head; y is normalised per
# head (GroupNorm), times silu(g), then W_o. ``SSMConfig.token_shift_lora`` 0
# and ``head_norm_eps`` 0 give the JAX package's form: the static mixes
# alone, and one LayerNorm over all channels.
class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, Dk, Dv) per-head state, fp32
    shift_t: torch.Tensor   # (B, d) last token (time-mix shift)
    shift_c: torch.Tensor   # (B, d) last token (channel-mix shift)


# token-layers whose recurrence ran through K4 ("kernel") and through the
# one-step update ("step"), from shapes on the host; only grows
wkv_tokens: Dict[str, int] = {"kernel": 0, "step": 0}


def rwkv_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.ssm.wkv_head_dim
    nh = d // h
    specs = {
        # token-shift interpolation weights (static part) for r,k,v,w,g
        "mix": ParamSpec((5, d), (None, "d_model"), init="zeros"),
        "w_r": ParamSpec((d, d), ("d_model", "heads_flat")),
        "w_k": ParamSpec((d, d), ("d_model", "heads_flat")),
        "w_v": ParamSpec((d, d), ("d_model", "heads_flat")),
        "w_g": ParamSpec((d, d), ("d_model", "heads_flat")),
        "w_o": ParamSpec((d, d), ("heads_flat", "d_model")),
        # data-dependent per-channel decay lora: w = exp(-exp(w0 + tanh(x A) B))
        "decay_w0": ParamSpec((d,), ("d_model",), init="zeros"),
        "decay_a": ParamSpec((d, RWKV_DECAY_LORA), ("d_model", None)),
        "decay_b": ParamSpec((RWKV_DECAY_LORA, d), (None, "d_model")),
        "bonus_u": ParamSpec((nh, h), (None, None), init="zeros"),
        # the WKV output's norm (per head where head_norm_eps is set)
        "ln_scale": ParamSpec((d,), ("d_model",), init="ones"),
        "ln_bias": ParamSpec((d,), ("d_model",), init="zeros"),
        # channel mix
        "cm_mix": ParamSpec((2, d), (None, "d_model"), init="zeros"),
        "cm_k": ParamSpec((d, cfg.d_ff), ("d_model", "d_ff")),
        "cm_v": ParamSpec((cfg.d_ff, d), ("d_ff", "d_model")),
        "cm_r": ParamSpec((d, d), ("d_model", "d_model_out")),
    }
    rank = cfg.ssm.token_shift_lora
    if rank:
        # ddlerp: m = tanh((x + xx maa_x) W1) W2, one rank-``rank`` slice of
        # W1's columns and one W2[i] for each of r,k,v,w,g (``mix``'s order)
        specs["maa_x"] = ParamSpec((d,), ("d_model",), init="zeros")
        specs["maa_w1"] = ParamSpec((d, 5 * rank), ("d_model", None))
        specs["maa_w2"] = ParamSpec((5, rank, d), (None, None, "d_model"),
                                    scale=math.sqrt(5 / rank))   # std 1/sqrt(rank)
    return specs


def _shift(x: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """x_{t-1} sequence: carry is the token before x[:, 0]."""
    return torch.cat([carry[:, None, :], x[:, :-1, :]], dim=1)


def _token_shift(cfg: ModelConfig, p: ParamTree, x: torch.Tensor,
                 prev: torch.Tensor):
    """The inputs of r, k, v, w and g: each token interpolated with the one
    before, by the static mixes, plus Finch's data-dependent LoRA term where
    ``token_shift_lora`` is set."""
    xx = prev - x
    mix = p["mix"].to(x.dtype)
    rank = cfg.ssm.token_shift_lora
    if not rank:
        return [x + xx * mix[i] for i in range(5)]
    m = torch.tanh((x + xx * p["maa_x"].to(x.dtype)) @ p["maa_w1"].to(x.dtype))
    m = torch.einsum("bsir,ird->ibsd", m.unflatten(-1, (5, rank)),
                     p["maa_w2"].to(x.dtype))                   # (5, B, S, d)
    return [x + xx * (mix[i] + m[i]) for i in range(5)]


def _wkv_norm(cfg: ModelConfig, p: ParamTree, y: torch.Tensor, nh: int) -> torch.Tensor:
    """The WKV output y (B, S, d) fp32, normalised: per head over its
    channels with eps ``head_norm_eps`` (Finch's GroupNorm of ``nh``
    groups), else by one LayerNorm over all channels with ``norm_eps``; the
    scale and bias are per channel either way."""
    eps = cfg.ssm.head_norm_eps
    scale, bias = p["ln_scale"].float(), p["ln_bias"].float()
    if not eps:
        return layer_norm(y, scale, bias, cfg.norm_eps)
    yh = y.unflatten(-1, (nh, -1))
    mu = yh.mean(dim=-1, keepdim=True)
    var = (yh - mu).square().mean(dim=-1, keepdim=True)
    return ((yh - mu) * torch.rsqrt(var + eps)).flatten(-2) * scale + bias


def rwkv_time_mix(cfg: ModelConfig, p: ParamTree, x: torch.Tensor,
                  state: RWKVState, use_kernel: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_wkv, new_shift). x: (B, S, d).

    ``use_kernel`` (and more than one token) runs the recurrence through the
    K4 kernel from a zero state, which is what prefill starts from; else
    one-step updates in a loop over the tokens, from ``state``. Profiler
    ranges ``rwkv.time_mix`` and, inside it, ``rwkv.wkv`` (the recurrence);
    ``wkv_tokens`` counts the token-layers of each route."""
    d = cfg.d_model
    hd = cfg.ssm.wkv_head_dim
    nh = d // hd
    b, seq, _ = x.shape
    with trace.span("rwkv.time_mix"):
        xr, xk, xv, xw, xg = _token_shift(cfg, p, x, _shift(x, state.shift_t))
        r = (xr @ p["w_r"].to(x.dtype)).reshape(b, seq, nh, hd)
        k = (xk @ p["w_k"].to(x.dtype)).reshape(b, seq, nh, hd)
        v = (xv @ p["w_v"].to(x.dtype)).reshape(b, seq, nh, hd)
        g = F.silu(xg @ p["w_g"].to(x.dtype))
        # data-dependent per-channel decay in (0,1)
        ww = p["decay_w0"].float() + torch.tanh(
            xw.float() @ p["decay_a"].float()) @ p["decay_b"].float()
        w = torch.exp(-torch.exp(ww)).reshape(b, seq, nh, hd)    # (B,S,H,Dk)
        u = p["bonus_u"].float()                                 # (H, Dk)

        with trace.span("rwkv.wkv"):
            if use_kernel and seq > 1:
                from repro_torch.kernels import ops as kops

                wkv_tokens["kernel"] += b * seq
                # the kernel reads r, k, v (model dtype) and w (fp32) in place and
                # writes y in fp32 as (B, S, H, Dv): no fold or unfold copy
                y4, s_final = kops.rwkv6_wkv_model(r, k, v, w, u)
                y = y4.reshape(b, seq, d)
            else:
                wkv_tokens["step"] += b * seq
                s = state.wkv.float()
                rf, kf, vf = r.float(), k.float(), v.float()
                ys = []
                for t in range(seq):
                    kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B,H,Dk,Dv)
                    ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                           s + u[None, :, :, None] * kv))
                    s = w[:, t, :, :, None] * s + kv
                s_final = s
                y = torch.stack(ys, dim=1).reshape(b, seq, d)        # (B,S,d)
        y = _wkv_norm(cfg, p, y, nh)
        out = (y.to(x.dtype) * g) @ p["w_o"].to(x.dtype)
    return out, s_final, x[:, -1, :]


def rwkv_channel_mix(cfg: ModelConfig, p: ParamTree, x: torch.Tensor,
                     state: RWKVState) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v) with static mixes, in the
    profiler range ``rwkv.channel_mix``. Returns (out, new_shift)."""
    with trace.span("rwkv.channel_mix"):
        prev = _shift(x, state.shift_c)
        mix = p["cm_mix"].to(x.dtype)
        xk = x + (prev - x) * mix[0]
        xr = x + (prev - x) * mix[1]
        k = torch.square(torch.relu(xk @ p["cm_k"].to(x.dtype)))
        out = torch.sigmoid(xr @ p["cm_r"].to(x.dtype)) * (k @ p["cm_v"].to(x.dtype))
    return out, x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None) -> RWKVState:
    """Zeroed state on ``device`` (None: the card)."""
    device = resolve_device(device)
    d = cfg.d_model
    hd = cfg.ssm.wkv_head_dim
    nh = d // hd
    return RWKVState(
        wkv=torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_c=torch.zeros((batch, d), dtype=dtype, device=device))
