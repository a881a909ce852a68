"""Mamba selective scan for the H100: wrapper of the hand-written CUDA
kernels ``csrc/ssm_scan_sm90.cu`` (the ``tma`` route) and ``csrc/ssm_scan.cu``
(the ``simple`` route) and, beside them, the plain PyTorch version.

Per batch row and channel d, from a zero state:
    h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t,    y_t = C_t . h_t + u_t d_skip.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py::ssm_scan``. The
kernels' design notes are at the top of the ``.cu`` sources. Unlike the TPU
kernel, no row past ``S`` reaches the state, whatever ``S`` is.

Device rule: a CUDA tensor launches a kernel or raises; the plain version
runs only for a tensor that lies on the CPU. The route is a function of
(dtype, d_in, N) alone (:func:`route`): a build or launch error raises, it
never moves a call to the other route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_N = 16            # a thread keeps its channel's N states in registers
ROUTES = ("simple", "tma")

launches = 0          # kernel launches made by :func:`ssm_scan`
launches_by_route = dict.fromkeys(ROUTES, 0)

_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_ENTRY = {"simple": "ssm_scan_fwd", "tma": "ssm_scan_tma_fwd"}
_fns = {}


def _kernel_fn(rt: str):
    if rt not in _fns:
        fn = getattr(_build.load(), _ENTRY[rt])
        fn.argtypes = [_PTR] * 8 + [_INT] * 5 + [_PTR]
        fn.restype = _INT
        _fns[rt] = fn
    return _fns[rt]


def route(dtype: torch.dtype, d_in: int, n: int) -> str:
    """The kernel a (u dtype, d_in, N) runs on. ``"tma"`` where TMA can
    address every row: the rows of u, dt and y (d_in elements) and of B and
    C (N fp32) are multiples of 16 bytes; ``"simple"`` otherwise. Nothing
    else decides it."""
    row_bytes = d_in * (2 if dtype == torch.bfloat16 else 4)
    return "tma" if row_bytes % 16 == 0 and n % 4 == 0 else "simple"


def ssm_scan_plain(u: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor):
    """The kernel's arithmetic in plain PyTorch, a loop over t on
    (B, d_in, N) fp32 tensors: ``da = exp(dt a)``, ``h = da h + (dt u) B``,
    ``y = sum_n h C``; the skip term ``u d_skip`` is added in fp32 before the
    cast. Same signature and outputs as :func:`ssm_scan`."""
    b, seq, d_in = u.shape
    uf, dtf = u.float(), dt.float()
    bf, cf, af = bm.float(), cm.float(), a.float()
    h = torch.zeros((b, d_in, a.shape[1]), dtype=torch.float32, device=u.device)
    y = torch.empty((b, seq, d_in), dtype=torch.float32, device=u.device)
    for t in range(seq):
        da = torch.exp(dtf[:, t, :, None] * af)
        h = da * h + (dtf[:, t] * uf[:, t])[:, :, None] * bf[:, t, None, :]
        y[:, t] = (h * cf[:, t, None, :]).sum(dim=-1)
    return (y + uf * d_skip.float()).to(u.dtype), h


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor):
    """u, dt: (B, S, d_in) in the model dtype (float32 or bfloat16, the
    same for both); bm, cm: (B, S, N); a: (d_in, N), negative; d_skip:
    (d_in,). bm, cm, a and d_skip are used in fp32. Returns (y (B, S, d_in)
    in ``u.dtype``, h_final (B, d_in, N) fp32), from a zero state. N up to
    ``MAX_N``; any S and d_in."""
    global launches
    if not u.is_cuda:
        return ssm_scan_plain(u, dt, bm, cm, a, d_skip)
    assert not (torch.is_grad_enabled() and u.requires_grad), \
        "ssm_scan is inference only"
    b, seq, d_in = u.shape
    n = a.shape[-1]
    if u.dtype not in (torch.float32, torch.bfloat16) or dt.dtype != u.dtype:
        raise TypeError(f"ssm_scan takes u and dt both float32 or both bfloat16, "
                        f"got {u.dtype} and {dt.dtype}")
    if not all(t.device == u.device for t in (dt, bm, cm, a, d_skip)):
        raise TypeError("u, dt, bm, cm, a and d_skip must share a device")
    if (dt.shape != u.shape or bm.shape != (b, seq, n) or cm.shape != (b, seq, n)
            or a.shape != (d_in, n) or d_skip.shape != (d_in,)):
        raise ValueError(f"bad shapes u{tuple(u.shape)} dt{tuple(dt.shape)} "
                         f"bm{tuple(bm.shape)} cm{tuple(cm.shape)} a{tuple(a.shape)} "
                         f"d_skip{tuple(d_skip.shape)}")
    if not 1 <= n <= MAX_N or seq < 1:
        raise ValueError(f"N {n} outside 1..{MAX_N} or empty sequence (S {seq})")
    rt = route(u.dtype, d_in, n)
    u, dt = u.contiguous(), dt.contiguous()
    bm, cm, a, d_skip = (t.to(torch.float32).contiguous() for t in (bm, cm, a, d_skip))
    if rt == "tma":   # TMA and 16-byte vector operands start 16-byte aligned
        u, dt, bm, cm, a = (t if t.data_ptr() % 16 == 0 else t.clone()
                            for t in (u, dt, bm, cm, a))
    y = torch.empty((b, seq, d_in), dtype=u.dtype, device=u.device)
    h_final = torch.empty((b, d_in, n), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(rt)(
            u.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            b, seq, d_in, n, 1 if u.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed on route {rt} (code {err})")
    launches += 1
    launches_by_route[rt] += 1
    return y, h_final
