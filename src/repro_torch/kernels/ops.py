"""Dispatch of model-layout calls onto the kernels.

On a CUDA tensor the wrappers launch the hand-written kernels; on a CPU
tensor they run the kernels' plain PyTorch versions. ``force_ref()`` routes
everything to the fp32 oracles in ``ref`` instead (tests use it to
cross-check the dispatch layer itself). One device, so there are no
sharded branches here. Inference only: the backward kernels are not ported
yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as wkv_k

_FORCE_REF = False


def force_ref(on: bool = True):
    global _FORCE_REF
    _FORCE_REF = on


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, attn_softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Model layout q: (B,S,H,D), k/v: (B,S,KV,D) -> (B,S,H,D). The kernel
    reads the transposed views through their strides: no copy is made."""
    assert not (torch.is_grad_enabled() and q.requires_grad), \
        "ops.flash_attention is inference only"
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _FORCE_REF:
        out = ref.flash_attention_ref(qt, kt, vt, causal=True, window=window,
                                      softcap=attn_softcap, scale=scale)
    else:
        out = fa_k.flash_attention(qt, kt, vt, causal=True, window=window,
                                   softcap=attn_softcap, scale=scale)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, *, attn_softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Model layout q: (B,1,H,D), k/v: (B,S,KV,D), mask: (B,S) -> (B,1,H,D).
    The kernel consumes the cache's native layout; the split over S and the
    merge of the partial softmax stats happen inside its wrapper."""
    assert not (torch.is_grad_enabled() and q.requires_grad), \
        "ops.decode_attention is inference only"
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
    if _FORCE_REF:
        return ref.rwkv6_wkv_ref(r, k, v, w, u)
    return wkv_k.rwkv6_wkv(r, k, v, w, u)
