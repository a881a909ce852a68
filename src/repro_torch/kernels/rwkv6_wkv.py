"""RWKV6 (Finch) WKV recurrence for the H100: wrapper of the hand-written CUDA
kernel ``csrc/rwkv6_wkv.cu`` and, beside it, the plain PyTorch version.

Per folded (batch x head):  y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),
                            S_t = diag(w_t) S_{t-1} + k_t v_t^T.

Replaces the TPU kernel ``repro/kernels/rwkv6_wkv.py::rwkv6_wkv``. The
kernel's design notes are at the top of the ``.cu`` source. Unlike the TPU
kernel, no row past ``S`` reaches the state, whatever ``S`` is.

Device rule: a CUDA tensor launches the kernel or raises; the plain version
runs only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_DK = 128          # a thread keeps Dk/8 keys of two state columns in registers

launches = 0          # kernel launches made by :func:`rwkv6_wkv`

_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load().rwkv6_wkv_fwd
        fn.argtypes = [_PTR] * 7 + [_INT] * 5 + [_PTR]
        fn.restype = _INT
        _fn = fn
    return _fn


def rwkv6_wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor):
    """The kernel's arithmetic in plain PyTorch, a loop over t: fp32 state,
    ``kv = k v^T``, ``y = sum_k r (S + u kv)``, ``S = w S + kv``. Same
    signature and outputs as :func:`rwkv6_wkv`."""
    bh, seq, dk = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[:, :, None]
    s = torch.zeros((bh, dk, v.shape[2]), dtype=torch.float32, device=r.device)
    y = torch.empty((bh, seq, v.shape[2]), dtype=torch.float32, device=r.device)
    for t in range(seq):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        y[:, t] = (rf[:, t, :, None] * (uf * kv + s)).sum(dim=1)
        s = wf[:, t, :, None] * s + kv
    return y.to(r.dtype), s


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """r/k/w: (BH, S, Dk); v: (BH, S, Dv); u: (BH, Dk) bonus. Returns
    (y (BH, S, Dv) in ``r.dtype``, s_final (BH, Dk, Dv) fp32), from a zero
    state. Caller folds (batch, heads) into BH. float32 or bfloat16 inputs
    (u may be either), fp32 arithmetic; Dk up to ``MAX_DK``, any Dv and S."""
    global launches
    if not r.is_cuda:
        return rwkv6_wkv_plain(r, k, v, w, u)
    assert not (torch.is_grad_enabled() and r.requires_grad), \
        "rwkv6_wkv is inference only"
    bh, seq, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rwkv6_wkv takes float32 or bfloat16, got {r.dtype}")
    if not (k.dtype == v.dtype == w.dtype == r.dtype
            and k.device == v.device == w.device == u.device == r.device):
        raise TypeError("r, k, v, w must share dtype and device (u: device)")
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (bh, seq, dv)
            or u.shape != (bh, dk)):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)} u{tuple(u.shape)}")
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"Dk {dk} outside 1..{MAX_DK}")
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    y = torch.empty((bh, seq, dv), dtype=r.dtype, device=r.device)
    s_final = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            bh, seq, dk, dv, 1 if r.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed (code {err})")
    launches += 1
    return y, s_final
