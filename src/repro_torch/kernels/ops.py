"""Dispatch of model-layout calls onto the kernels.

On a CUDA tensor the wrappers launch the hand-written kernels; on a CPU
tensor they run the kernels' plain PyTorch versions. ``force_ref()`` routes
everything to the fp32 oracles in ``ref`` instead (tests use it to
cross-check the dispatch layer itself). One device, so there are no
sharded branches here.

``flash_attention`` is differentiable: its forward is the flash kernel (K1)
with the log-sum-exp kept, its backward the flash backward kernels (K5), as
the JAX package's ``custom_vjp`` pairs them. Decode attention, the WKV
recurrence and the selective scan have no backward kernel (the JAX package
defines none) and raise under autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import flash_attention_bwd as fab_k
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as wkv_k
from repro_torch.kernels import ssm_scan as ssm_k

_FORCE_REF = False
# each kernel's module by the name of its launch counter; ROUTED: those that
# also count their launches by route
KERNELS = {"flash_attention": fa_k, "decode_attention": dec_k, "ssm_scan": ssm_k,
           "rwkv6_wkv": wkv_k, "flash_attention_bwd": fab_k}
ROUTED = {"flash_attention": fa_k, "ssm_scan": ssm_k, "flash_attention_bwd": fab_k}


def launch_counts():
    """Every kernel's launch count, and its counts by route where it has routes."""
    return {"launches": {k: m.launches for k, m in KERNELS.items()},
            "routes": {k: dict(m.launches_by_route) for k, m in ROUTED.items()}}


def force_ref(on: bool = True):
    global _FORCE_REF
    _FORCE_REF = on


class _Flash(torch.autograd.Function):
    """K1 forward (saving ``lse``), K5 backward, on (B, H, S, D) views."""

    @staticmethod
    def forward(ctx, qt, kt, vt, window, softcap, scale):
        out, lse = fa_k.flash_attention(qt, kt, vt, causal=True, window=window,
                                        softcap=softcap, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.opts = (window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, out, lse = ctx.saved_tensors
        window, softcap, scale = ctx.opts
        # delta = rowsum(dout * out) is computed inside K5 (its dq kernel on
        # the wgmma route), not in a separate pass
        dq, dk, dv = fab_k.flash_attention_bwd(qt, kt, vt, dout, lse, out=out,
                                               causal=True, window=window,
                                               softcap=softcap, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, attn_softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Model layout q: (B,S,H,D), k/v: (B,S,KV,D) -> (B,S,H,D). The kernels
    read the transposed views through their strides: no copy is made, and
    the gradients come back in the model's layout."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _FORCE_REF:
        out = ref.flash_attention_ref(qt, kt, vt, causal=True, window=window,
                                      softcap=attn_softcap, scale=scale)
    else:
        out = _Flash.apply(qt, kt, vt, window, attn_softcap, scale)
    return out.transpose(1, 2)


def _no_grad(x: torch.Tensor, what: str, *more: torch.Tensor):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *more)):
        raise RuntimeError(
            f"ops.{what} has no backward: the JAX package defines no backward "
            f"kernel for it (serving only); train with use_kernels=False")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, *, attn_softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Model layout q: (B,1,H,D), k/v: (B,S,KV,D), mask: (B,S) -> (B,1,H,D).
    The kernel consumes the cache's native layout; the split over S and the
    merge of the partial softmax stats happen inside its wrapper."""
    _no_grad(q, "decode_attention")
    b, _, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qd = q[:, 0].reshape(b, kv, g, d)
    if _FORCE_REF:
        out = ref.decode_attention_ref(qd, k.transpose(1, 2), v.transpose(1, 2),
                                       mask, softcap=attn_softcap, scale=scale)
    else:
        out = dec_k.decode_attention(qd, k, v, mask, softcap=attn_softcap,
                                     scale=scale)
    return out.reshape(b, 1, h, d)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """Folded layout r/k/w: (BH,S,Dk), v: (BH,S,Dv), u: (BH,Dk) ->
    (y (BH,S,Dv), s_final (BH,Dk,Dv) fp32)."""
    _no_grad(r, "rwkv6_wkv")
    if _FORCE_REF:
        return ref.rwkv6_wkv_ref(r, k, v, w, u)
    return wkv_k.rwkv6_wkv(r, k, v, w, u)


def rwkv6_wkv_model(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor):
    """Model layout r/k (B,S,H,Dk), v (B,S,H,Dv) in the model's dtype, w
    (B,S,H,Dk) fp32, u (H,Dk) fp32 -> (y (B,S,H,Dv) fp32, s_final (B,H,Dk,Dv)
    fp32). The kernel reads the tensors in place: no fold copy."""
    _no_grad(r, "rwkv6_wkv_model")
    if _FORCE_REF:
        b, seq, nh, dk = r.shape

        def fold(t):
            return t.float().transpose(1, 2).reshape(b * nh, seq, t.shape[-1])
        y, s = ref.rwkv6_wkv_ref(fold(r), fold(k), fold(v), fold(w),
                                 u.float().repeat(b, 1))
        return (y.reshape(b, nh, seq, -1).transpose(1, 2),
                s.reshape(b, nh, dk, -1))
    return wkv_k.rwkv6_wkv_model(r, k, v, w, u)


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor):
    """u/dt: (B,S,d_in), bm/cm: (B,S,N), a: (d_in,N), d_skip: (d_in,) ->
    (y (B,S,d_in) in u.dtype, h_final (B,d_in,N) fp32), from a zero state."""
    _no_grad(u, "ssm_scan", dt, bm, cm)
    if _FORCE_REF:
        return ref.ssm_scan_ref(u, dt, bm, cm, a, d_skip)
    return ssm_k.ssm_scan(u, dt, bm, cm, a, d_skip)
