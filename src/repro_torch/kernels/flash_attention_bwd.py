"""Flash-attention backward for the H100: wrapper of the hand-written CUDA
kernels ``csrc/flash_attention_bwd.cu`` and, beside it, the plain PyTorch
version.

Recompute form: from q, k, v, dout, the forward's ``lse`` and
``delta = rowsum(dout * out)``, with ``p = exp(q k^T scale - lse)``:
``dv = p^T dout``, ``ds = p (dout v^T - delta) scale`` (times
``1 - tanh^2`` under a soft cap), ``dk = ds^T q``, ``dq = ds k``; dk and dv
are summed over the G query heads of each kv head.

Replaces the TPU kernels ``repro/kernels/flash_attention_bwd.py::
flash_attention_bwd`` (``_dq_kernel``, ``_dkv_kernel``). Three routes, chosen
by :func:`route` from the dtype and the head dim alone:

* ``wgmma``: bf16 at D = 64, 128 and 256 (the training shapes),
  ``csrc/flash_attention_bwd_sm90.cu``: TMA rings, producer and consumer
  warpgroups, every product on ``wgmma``;
* ``mma``: bf16 at D = 16 (the smoke configs), ``csrc/flash_attention_bwd.cu``,
  ``mma.sync`` with ``cp.async`` copies;
* ``fma``: fp32, ``csrc/flash_attention_bwd.cu``, FMAs on the CUDA cores.

The kernels' design notes are at the top of the ``.cu`` sources.

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

ROUTES = ("fma", "mma", "wgmma")    # the C entry point's route codes 0, 1, 2

launches = 0          # wrapper calls that launched the kernels (two each)
launches_by_route = dict.fromkeys(ROUTES, 0)
copied_bytes = 0      # bytes of operands the wrapper had to copy first

_I64, _INT, _F32, _PTR = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p)
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load().flash_attention_bwd
        fn.argtypes = ([_PTR] * 10 + [_INT] * 6 + [_I64] * 24
                       + [_F32, _F32] + [_INT] * 6 + [_PTR])
        fn.restype = _INT
        _fn = fn
    return _fn


def route(dtype: torch.dtype, d: int) -> str:
    """The kernels a (dtype, head dim) runs on. Nothing else decides it: a
    build or launch error raises, it never moves a call to another route."""
    if dtype == torch.bfloat16 and d in (64, 128, 256):
        return "wgmma"
    if dtype == torch.bfloat16 and d == 16:
        return "mma"
    return "fma"


def delta_of(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * out)`` in fp32, (B, H, Sq): what the backward
    needs of the forward's output."""
    return (dout.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, dout, lse, delta=None, *, out=None,
                              causal: bool = True, window: Optional[int] = None,
                              softcap: float = 0.0, scale: Optional[float] = None,
                              q_offset: int = 0):
    """The TPU kernels' arithmetic in plain PyTorch, in fp32:
    ``p = where(mask, exp(s - lse), 0)``, ``ds = p * (dout v^T - delta) *
    scale`` times ``1 - tanh^2`` under the soft cap. Same signature and
    outputs as :func:`flash_attention_bwd`."""
    if delta is None:
        delta = delta_of(dout, out)
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
    """``x`` as the kernels read it: in place where its last dim is
    contiguous and its rows start on 16 bytes (:func:`_aligned_view`), else
    a contiguous copy, counted in ``copied_bytes``. A dim of size 1 addresses
    nothing, so its stride is first set to the tensor's span: autograd hands
    over the dout of a (1, S, H, D) output's transpose with a batch stride
    of 1 element, which would otherwise fail the 16-byte test and be
    copied."""
    global copied_bytes
    if any(n == 1 for n in x.shape[:-1]):
        span = max([st * n for st, n in zip(x.stride(), x.shape) if n > 1], default=1)
        x = x.as_strided(x.shape, [span if n == 1 else st for st, n in
                                   zip(x.stride()[:-1], x.shape[:-1])] + [x.stride(-1)])
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


def flash_attention_bwd(q, k, v, dout, lse, delta=None, *, out=None,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: float = 0.0, scale: Optional[float] = None,
                        q_offset: int = 0):
    """q/dout: (B, H, Sq, D); k/v: (B, KV, S, D); lse/delta: (B, H, Sq) fp32.
    Returns (dq, dk, dv) in the inputs' dtype with dk/dv summed over each kv
    head's G query heads to (B, KV, S, D). Operands may be views whose last
    dim is contiguous (the transposes of the model's tensors are read in
    place); outputs take the inputs' memory layout. bf16 runs on the tensor
    cores, fp32 as fp32 FMAs (:func:`route`).

    ``delta=None`` with the forward's output ``out`` (B, H, Sq, D): delta =
    rowsum(dout * out) is part of the call. The ``wgmma`` route computes it
    in its dq kernel, from the dout tile it stages anyway (no separate pass);
    the other routes run :func:`delta_of` first."""
    if delta is None and (out is None or out.shape != q.shape):
        raise ValueError("flash_attention_bwd needs delta, or the forward's output "
                         "of q's shape to compute it from")
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, out=out, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale, q_offset=q_offset)
    return _launch(q, k, v, dout, lse, delta, out, causal=causal, window=window,
                   softcap=softcap, scale=scale, q_offset=q_offset)


def _launch(q, k, v, dout, lse, delta, out, *, causal: bool, window: Optional[int],
            softcap: float, scale: Optional[float], q_offset: int):
    """:func:`flash_attention_bwd` on CUDA tensors, on :func:`route`'s route;
    the C entry point refuses (-4) a route that does not take the dtype or
    head dim."""
    global launches
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
    rt = route(q.dtype, d)
    from_out = delta is None and rt == "wgmma"
    if delta is None and not from_out:
        delta = delta_of(dout, out)
    if lse.shape != (b, h, sq) or (delta is not None and delta.shape != (b, h, sq)):
        raise ValueError(f"lse{tuple(lse.shape)} / delta != {(b, h, sq)}")
    q, k, v, dout = (_operand(t) for t in (q, k, v, dout))
    lse = lse.to(torch.float32).contiguous()
    if from_out:
        if out.dtype != q.dtype or out.device != q.device:
            raise TypeError("out must share q's dtype and device")
        out = _operand(out)
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    else:
        delta = delta.to(torch.float32).contiguous()
        out = q                    # not read
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), out.data_ptr(), b, h, kv, sq, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], *out.stride()[:3],
            _resolve_scale(scale, d), float(softcap), int(causal),
            int(window) if window is not None else 0, int(q_offset), int(from_out),
            1 if q.dtype == torch.bfloat16 else 0, ROUTES.index(rt), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed (route {rt}, code {err})")
    launches += 1
    launches_by_route[rt] += 1
    return dq, dk, dv
