"""Flash attention (prefill) for the H100: wrapper of the hand-written CUDA
kernels and, beside them, the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
Three routes, chosen by :func:`route` from the dtype and the head dim alone:

* ``wgmma``: bf16 at D = 64, 128 and 256 (the serving and training shapes,
  gemma2's head dim), ``csrc/flash_attention_sm90.cu``: TMA-fed K/V ring,
  both products on ``wgmma``; a producer warpgroup ahead of two consumer
  warpgroups at D 64 / 128, the two consumers issuing their own copies at
  D 256;
* ``mma``: bf16 at D = 16 (the smoke configs), ``csrc/flash_attention.cu``,
  ``mma.sync`` with ``cp.async`` copies;
* ``fma``: fp32, ``csrc/flash_attention.cu``, FMAs on the CUDA cores.

The kernels' design notes (what bounds them on the card and what the design
does about it) are at the top of the ``.cu`` sources.

Device rule: a CUDA tensor launches the kernel or raises; the plain version
runs only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128, 256)

ROUTES = ("fma", "mma", "wgmma")    # the C entry point's route codes 0, 1, 2

launches = 0          # kernel launches made by :func:`flash_attention`
launches_by_route = dict.fromkeys(ROUTES, 0)

_I64, _INT, _F32, _PTR = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p)
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load().flash_attention_fwd
        fn.argtypes = ([_PTR] * 5 + [_INT] * 6 + [_I64] * 12
                       + [_F32, _F32, _INT, _INT, _INT, _INT, _INT, _PTR])
        fn.restype = _INT
        _fn = fn
    return _fn


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a (dtype, head dim) runs on. Nothing else decides it: a
    build or launch error raises, it never moves a call to another route."""
    if dtype == torch.bfloat16:
        return "wgmma" if d in (64, 128, 256) else "mma"
    return "fma"


def blind_rows(sq: int, s: int, window: Optional[int], q_offset: int = 0,
               device=None) -> torch.Tensor:
    """(Sq,) bool: the query rows that see no column, whatever the causal
    flag: a window hides every one of the S columns (``row - window >= S -
    1``). The TPU kernel gives such a row the mean of V and ``lse = NEG_INF +
    log S``; so do :func:`flash_attention_plain` and every CUDA route."""
    if window is None:
        return torch.zeros(sq, dtype=torch.bool, device=device)
    return q_offset + torch.arange(sq, device=device) - window >= s - 1


def _resolve_scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: float = 0.0, scale: Optional[float] = None,
                          q_offset: int = 0, return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch: fp32 scores, soft cap before
    masking, ``NEG_INF`` masking, ``denom = max(l, 1e-30)``,
    ``lse = m + log(denom)``. Same signature and outputs as
    :func:`flash_attention`."""
    b, h, sq, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    scale = _resolve_scale(scale, d)
    qg = q.float().reshape(b, kv, g, sq, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((sq, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / denom
    out = out.reshape(b, h, sq, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom)).reshape(b, h, sq)
    return out


def _aligned_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it in place (last dim contiguous,
    every row start 16-byte aligned), else a contiguous copy."""
    es = x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all((st * es) % 16 == 0 for st in x.stride()[:-1]))
    return x if ok else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """q: (B, H, Sq, D); k/v: (B, KV, S, D), any views whose last dim is
    contiguous (a ``transpose(1, 2)`` of the model's (B, S, H, D) tensors is
    read in place). Returns (B, H, Sq, D) in ``q.dtype`` with q's memory
    layout, plus the per-row log-sum-exp (B, H, Sq) fp32 when ``return_lse``.

    ``q_offset``: global position of q row 0 (K/V stay whole). bf16 runs on
    the tensor cores, fp32 as fp32 FMAs (:func:`route`)."""
    global launches
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset, return_lse=return_lse)
    assert not (torch.is_grad_enabled() and q.requires_grad), \
        "flash_attention has no backward kernel yet (inference only)"
    b, h, sq, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if not (k.dtype == v.dtype == q.dtype and k.device == v.device == q.device):
        raise TypeError("q, k, v must share dtype and device")
    if h % kv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    q, k, v = _aligned_view(q), _aligned_view(k), _aligned_view(v)
    out = torch.empty_like(q)           # keeps q's strides when q is dense
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rt = route(q.dtype, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, kv, sq, s, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            _resolve_scale(scale, d), float(softcap), int(causal),
            int(window) if window is not None else 0, int(q_offset),
            int(q.dtype == torch.bfloat16), ROUTES.index(rt), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (route {rt}, code {err})")
    launches += 1
    launches_by_route[rt] += 1
    return (out, lse) if return_lse else out
