"""Single-token GQA decode attention (flash-decode) for the H100: wrapper of
the hand-written CUDA kernel ``csrc/decode_attention.cu`` and, beside it, the
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``.
One launch a call: the blocks of a (batch, kv head) form a thread-block
cluster, each takes a share of the row's valid slots and they merge through
distributed shared memory. Two instances, by dtype (:func:`route`): bf16 runs
q.k and P V as ``mma.sync`` tensor-core products (``mma``), fp32 as FMAs on
the CUDA cores (``fma``). The kernel's design notes (what bounds it; what the
design does about it) are at the top of the ``.cu`` source.

Device rule: a CUDA tensor launches the kernel or raises; the plain version
runs only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, NEG_INF,
                                                 _aligned_view, _resolve_scale)

MAX_GROUP = 8
MAX_CLUSTER = 8       # the portable thread-block cluster size
MIN_ROWS_PER_SPLIT = 512
BLOCKS_PER_SM = 1     # how many blocks per SM the split aims for

launches = 0          # kernel launches made by :func:`decode_attention`

_I64, _INT, _F32, _PTR = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p)
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load().decode_attention_fwd
        fn.argtypes = ([_PTR] * 7 + [_INT] * 7 + [_I64] * 8
                       + [_F32, _F32, _INT, _PTR])
        fn.restype = _INT
        _fn = fn
    return _fn


def route(dtype: torch.dtype) -> str:
    """The kernel instance a dtype runs on: ``mma`` (tensor cores) for
    bf16, ``fma`` (CUDA cores) for fp32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, *, softcap: float = 0.0,
                           scale: Optional[float] = None,
                           return_stats: bool = False):
    """The kernel's arithmetic in plain PyTorch (fp32, ``NEG_INF`` masking,
    ``max(l, 1e-30)`` clamp). Same signature and outputs as
    :func:`decode_attention`."""
    scale = _resolve_scale(scale, q.shape[-1])
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / l.clamp_min(1e-30)
    out = out.to(q.dtype)
    return (out, m, l) if return_stats else out


def num_splits(batch: int, kv_heads: int, s: int, sm_count: int) -> int:
    """Shares the valid slots of a row are cut into, one block each: about
    ``BLOCKS_PER_SM`` blocks for every SM, at most one cluster
    (``MAX_CLUSTER``), no share that could only hold fewer than
    ``MIN_ROWS_PER_SPLIT`` of the S slots, and a power of two, so that no
    block of the cluster is idle. One block an SM, each streaming its share
    by TMA, reads faster than two (on an H100, qwen3-32b's decode over 32768
    slots: 0.392 ms at 2 splits, 128 blocks, against 0.512 at 4; PERF.md),
    and a share of a few hundred rows does not pay for its block's fixed
    costs (the mask count, the pipeline's first stage, the cluster merge:
    gemma2-2b's decode over 1024 slots, 520 valid, 0.0223 ms at 2 splits
    against 0.0293 at 4)."""
    want = math.ceil(BLOCKS_PER_SM * sm_count / (batch * kv_heads))
    n = max(1, min(want, MAX_CLUSTER, math.ceil(s / MIN_ROWS_PER_SPLIT)))
    return 1 << (n.bit_length() - 1)


def cluster_size(nsplit: int) -> int:
    """Blocks of one (batch, kv head): the power of two that holds
    ``nsplit`` shares (the blocks past ``nsplit`` take an empty share)."""
    if not 1 <= nsplit <= MAX_CLUSTER:
        raise ValueError(f"splits must be in 1..{MAX_CLUSTER} (one cluster), got {nsplit}")
    return 1 << (nsplit - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, *, softcap: float = 0.0,
                     scale: Optional[float] = None,
                     return_stats: bool = False,
                     splits: Optional[int] = None):
    """q: (B, KV, G, D), one query token per head group; k/v: (B, S, KV, D),
    the cache's native layout (any view whose last dim is contiguous);
    mask: (B, S) bool, the valid cache slots. Returns (B, KV, G, D), plus the
    merged online-softmax stats (m, l), each (B, KV, G, 1) fp32, when
    ``return_stats``. ``splits`` (1..8) overrides the number of shares the
    valid slots are cut into. A row with no valid slot gives what the TPU
    kernel gives: the mean of V, m = -1e30 and l = S."""
    global launches
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, mask, softcap=softcap,
                                      scale=scale, return_stats=return_stats)
    assert not (torch.is_grad_enabled() and q.requires_grad), \
        "decode_attention is inference only"
    b, kv, g, d = q.shape
    s = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"group size {g} outside 1..{MAX_GROUP}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention takes float32 or bfloat16, got {q.dtype}")
    if not (k.dtype == v.dtype == q.dtype and k.device == v.device == q.device
            and mask.device == q.device):
        raise TypeError("q, k, v must share dtype and device (mask: device)")
    if mask.dtype != torch.bool or mask.shape != (b, s):
        raise TypeError(f"mask must be bool (B, S), got {mask.dtype} {tuple(mask.shape)}")
    if k.shape != (b, s, kv, d) or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    q = q.contiguous()
    k, v = _aligned_view(k), _aligned_view(v)
    if splits is None:
        splits = num_splits(b, kv, s, _sm_count(q.device))
    cluster = cluster_size(int(splits))
    dev = q.device
    out = torch.empty((b, kv, g, d), dtype=q.dtype, device=dev)
    m_out = l_out = None
    if return_stats:
        m_out = torch.empty((b, kv, g, 1), dtype=torch.float32, device=dev)
        l_out = torch.empty((b, kv, g, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), m_out.data_ptr() if return_stats else None,
            l_out.data_ptr() if return_stats else None,
            b, s, kv, g, d, int(splits), cluster,
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            mask.stride(0), mask.stride(1),
            _resolve_scale(scale, d), float(softcap),
            1 if q.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code {err})")
    launches += 1
    return (out, m_out, l_out) if return_stats else out
