"""RWKV6 (Finch) WKV recurrence for the H100: wrappers of the hand-written
CUDA kernel ``csrc/rwkv6_wkv.cu`` and, beside each, its plain PyTorch
version.

Per (batch, head):  y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),
                    S_t = diag(w_t) S_{t-1} + k_t v_t^T.

Two entries launch the same kernel:

* :func:`rwkv6_wkv` keeps the TPU kernel's signature
  ``repro/kernels/rwkv6_wkv.py::rwkv6_wkv``: folded (B*H, S, D) tensors;
* :func:`rwkv6_wkv_model` takes the model's own (B, S, H, D) tensors in
  place (r, k, v in the model's dtype, w in fp32) and returns y in fp32 as
  (B, S, H, Dv), so the model makes no fold or unfold copy.

The kernel's design notes are at the top of the ``.cu`` source. Unlike the
TPU kernel, no row past ``S`` reaches the state, whatever ``S`` is.

Device rule: a CUDA tensor launches the kernel or raises; the plain versions
run only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _aligned_view

MAX_DK = 128          # a column's keys are held by 2 or 4 lanes, 32 keys a lane

launches = 0          # kernel launches made by either entry

_DT = {torch.float32: 0, torch.bfloat16: 1}
_I64, _INT, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load().rwkv6_wkv_fwd
        fn.argtypes = [_PTR] * 7 + [_INT] * 5 + [_I64] * 17 + [_INT] * 3 + [_PTR]
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


def rwkv6_wkv_model_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor):
    """:func:`rwkv6_wkv_plain`'s loop read through the model's layout:
    r/k/w (B, S, H, Dk), v (B, S, H, Dv), u (H, Dk). Same outputs as
    :func:`rwkv6_wkv_model`, equal bit for bit to the folded call on the same
    values in fp32."""
    b, seq, nh, dk = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = torch.zeros((b, nh, dk, v.shape[3]), dtype=torch.float32, device=r.device)
    y = torch.empty((b, seq, nh, v.shape[3]), dtype=torch.float32, device=r.device)
    for t in range(seq):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = (rf[:, t, :, :, None] * (uf * kv + s)).sum(dim=2)
        s = wf[:, t, :, :, None] * s + kv
    return y, s


def _launch(r, k, v, w, u, y, s_final, b, nh, strides, u_strides):
    """One launch over (B, S, H, D) views; ``strides`` gives each of r, k, v,
    w, y as (batch, step, head) element strides."""
    global launches
    seq, dk, dv = r.shape[1], r.shape[-1], v.shape[-1]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            y.data_ptr(), s_final.data_ptr(), b, nh, seq, dk, dv,
            *(st for t in strides for st in t), *u_strides,
            _DT[r.dtype], _DT[w.dtype], _DT[y.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed (code {err})")
    launches += 1


def _check_dims(dk: int, dv: int):
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"Dk {dk} outside 1..{MAX_DK}")
    if dk % 8 or dv % 8:
        raise ValueError(f"the kernel stages whole 16-byte rows: Dk {dk} and Dv {dv} "
                         f"must be multiples of 8")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """r/k/w: (BH, S, Dk); v: (BH, S, Dv); u: (BH, Dk) bonus. Returns
    (y (BH, S, Dv) in ``r.dtype``, s_final (BH, Dk, Dv) fp32), from a zero
    state. Caller folds (batch, heads) into BH. float32 or bfloat16 inputs
    of one dtype (u may be either), fp32 arithmetic; on the card Dk up to
    ``MAX_DK``, Dk and Dv multiples of 8, any S."""
    if not r.is_cuda:
        return rwkv6_wkv_plain(r, k, v, w, u)
    assert not (torch.is_grad_enabled() and r.requires_grad), \
        "rwkv6_wkv is inference only"
    bh, seq, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in _DT:
        raise TypeError(f"rwkv6_wkv takes float32 or bfloat16, got {r.dtype}")
    if not (k.dtype == v.dtype == w.dtype == r.dtype
            and k.device == v.device == w.device == u.device == r.device):
        raise TypeError("r, k, v, w must share dtype and device (u: device)")
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (bh, seq, dv)
            or u.shape != (bh, dk)):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)} u{tuple(u.shape)}")
    _check_dims(dk, dv)
    r, k, v, w = (_aligned_view(t) for t in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    y = torch.empty((bh, seq, dv), dtype=r.dtype, device=r.device)
    s_final = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    # a (BH, S, D) tensor is a (B, S, H, D) view with H = 1
    _launch(r, k, v, w, u, y, s_final, bh, 1,
            [(t.stride(0), t.stride(1), 0) for t in (r, k, v, w, y)], (dk, 0))
    return y, s_final


def rwkv6_wkv_model(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor):
    """The model's layout, read in place: r/k (B, S, H, Dk) and v (B, S, H,
    Dv) in one dtype (float32 or bfloat16), w (B, S, H, Dk) float32, u (H, Dk)
    float32; any views whose last dim is contiguous. Returns (y (B, S, H, Dv)
    float32, s_final (B, H, Dk, Dv) float32), from a zero state."""
    if r.dim() != 4 or v.dim() != 4 or w.dim() != 4:
        raise ValueError("rwkv6_wkv_model takes (B, S, H, D) tensors")
    b, seq, nh, dk = r.shape
    dv = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (b, seq, nh, dv)
            or u.shape != (nh, dk)):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)} u{tuple(u.shape)}")
    if r.dtype not in _DT or not k.dtype == v.dtype == r.dtype:
        raise TypeError(f"r, k, v must share a dtype, float32 or bfloat16: "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32, got {w.dtype}, {u.dtype}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w, u)):
        raise ValueError("the last dim of r, k, v, w and u must be contiguous")
    if not r.is_cuda:
        return rwkv6_wkv_model_plain(r, k, v, w, u)
    assert not (torch.is_grad_enabled() and r.requires_grad), \
        "rwkv6_wkv is inference only"
    if not all(t.device == r.device for t in (k, v, w, u)):
        raise TypeError("r, k, v, w, u must share a device")
    _check_dims(dk, dv)
    r, k, v, w = (_aligned_view(t) for t in (r, k, v, w))
    u = u.contiguous()
    y = torch.empty((b, seq, nh, dv), dtype=torch.float32, device=r.device)
    s_final = torch.empty((b, nh, dk, dv), dtype=torch.float32, device=r.device)
    _launch(r, k, v, w, u, y, s_final, b, nh,
            [(t.stride(0), t.stride(1), t.stride(2)) for t in (r, k, v, w, y)], (0, dk))
    return y, s_final
