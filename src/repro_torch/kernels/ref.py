"""Pure-PyTorch oracles for the kernels (the allclose ground truth): fp32
math, ``-inf`` masking, cast back to the input dtype. They mirror
``repro/kernels/ref.py`` line for line; an all-masked attention row is NaN
here, which no caller on the serving path produces."""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,D); k/v: (B,KV,S,D) -> (B,H,S,D)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kv, g, s, d).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, vf)
    return out.reshape(b, h, s, d).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None, softcap: float = 0.0,
                            scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention_ref` by torch autograd, in fp32,
    cast back to the inputs' dtypes."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, *, softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,KV,G,D); k/v: (B,KV,S,D); mask: (B,S) -> (B,KV,G,D)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v.float())
    return out.to(q.dtype)


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor):
    """r/k/w: (BH,S,Dk); v: (BH,S,Dv); u: (BH,Dk) ->
    (y (BH,S,Dv) in r.dtype, s_final (BH,Dk,Dv) fp32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    s = torch.zeros((r.shape[0], r.shape[2], v.shape[2]), dtype=torch.float32,
                    device=r.device)
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]              # (BH,Dk,Dv)
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t], s + uf[..., :, None] * kv))
        s = wf[:, t, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor):
    """u/dt: (B,S,d); bm/cm: (B,S,N); a: (d,N); d_skip: (d,) ->
    (y (B,S,d) in u.dtype, h_final (B,d,N) fp32)."""
    uf, dtf = u.float(), dt.float()
    bf, cf, af = bm.float(), cm.float(), a.float()
    h = torch.zeros((u.shape[0], u.shape[2], a.shape[1]), dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * af)
        h = da * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1)
    return (y + uf * d_skip.float()).to(u.dtype), h
