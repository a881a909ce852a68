"""Flash-attention backward for the H100: wrapper of the hand-written CUDA
kernels ``csrc/flash_attention_bwd.cu`` and, beside it, the plain PyTorch
version.

Recompute form: from q, k, v, dout, the forward's ``lse`` and
``delta = rowsum(dout * out)``, with ``p = exp(q k^T scale - lse)``:
``dv = p^T dout``, ``ds = p (dout v^T - delta) scale`` (times
``1 - tanh^2`` under a soft cap), ``dk = ds^T q``, ``dq = ds k``; dk and dv
are summed over the G query heads of each kv head.

Replaces the TPU kernels ``repro/kernels/flash_attention_bwd.py::
flash_attention_bwd`` (``_dq_kernel``, ``_dkv_kernel``). The kernels' design
notes are at the top of the ``.cu`` source.

Device rule: a CUDA tensor launches the kernels or raises; the plain version
runs only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, _aligned_view,
                                                 _resolve_scale)

launches = 0          # wrapper calls that launched the kernels (two each)
copied_bytes = 0      # bytes of operands the wrapper had to copy first

_I64, _INT, _F32, _PTR = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p)
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load().flash_attention_bwd
        fn.argtypes = ([_PTR] * 9 + [_INT] * 6 + [_I64] * 21
                       + [_F32, _F32, _INT, _INT, _INT, _INT, _PTR])
        fn.restype = _INT
        _fn = fn
    return _fn


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, *, causal: bool = True,
                              window: Optional[int] = None, softcap: float = 0.0,
                              scale: Optional[float] = None, q_offset: int = 0):
    """The TPU kernels' arithmetic in plain PyTorch, in fp32:
    ``p = where(mask, exp(s - lse), 0)``, ``ds = p * (dout v^T - delta) *
    scale`` times ``1 - tanh^2`` under the soft cap. Same signature and
    outputs as :func:`flash_attention_bwd`."""
    b, h, sq, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    scale = _resolve_scale(scale, d)
    qf = q.float().reshape(b, kv, g, sq, d)
    dof = dout.float().reshape(b, kv, g, sq, d)
    kf, vf = k.float(), v.float()
    s_raw = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
    dcap = None
    if softcap > 0:
        t = torch.tanh(s_raw / softcap)
        scores = t * softcap
        dcap = 1.0 - t * t
    else:
        scores = s_raw
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((sq, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    p = torch.where(mask, torch.exp(scores - lse.reshape(b, kv, g, sq, 1)), 0.0)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = p * (dp - delta.reshape(b, kv, g, sq, 1)) * scale
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf).reshape(b, h, sq, d)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _operand(x: torch.Tensor) -> torch.Tensor:
    global copied_bytes
    y = _aligned_view(x)
    if y is not x:
        copied_bytes += y.numel() * y.element_size()
    return y


def _grad_like(x: torch.Tensor) -> torch.Tensor:
    """An output in ``x``'s memory layout when that is dense (the transposed
    views of the model's (B, S, H, D) tensors give gradients in that layout)."""
    out = torch.empty_like(x)
    return out if out.stride(-1) == 1 else torch.empty(x.shape, dtype=x.dtype,
                                                       device=x.device)


def flash_attention_bwd(q, k, v, dout, lse, delta, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: Optional[float] = None, q_offset: int = 0):
    """q/dout: (B, H, Sq, D); k/v: (B, KV, S, D); lse/delta: (B, H, Sq) fp32.
    Returns (dq, dk, dv) in the inputs' dtype with dk/dv summed over each kv
    head's G query heads to (B, KV, S, D). Operands may be views whose last
    dim is contiguous (the transposes of the model's tensors are read in
    place); outputs take the inputs' memory layout. bf16 runs on the tensor
    cores (D <= 128), fp32 as fp32 FMAs."""
    global launches
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale, q_offset=q_offset)
    b, h, sq, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, got {q.dtype}")
    if not all(t.dtype == q.dtype and t.device == q.device for t in (k, v, dout)):
        raise TypeError("q, k, v, dout must share dtype and device")
    if h % kv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or dout.shape != q.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} dout{tuple(dout.shape)}")
    if lse.shape != (b, h, sq) or delta.shape != (b, h, sq):
        raise ValueError(f"lse{tuple(lse.shape)} / delta{tuple(delta.shape)} "
                         f"!= {(b, h, sq)}")
    q, k, v, dout = (_operand(t) for t in (q, k, v, dout))
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, kv, sq, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            _resolve_scale(scale, d), float(softcap), int(causal),
            int(window) if window is not None else 0, int(q_offset),
            1 if q.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed (code {err})")
    launches += 1
    return dq, dk, dv
