#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --phase kernels     # or: main, train, profile [--arch ...]
    python3 chip_smoke.py --phase profile --arch deepseek-v3-671b

Phases, each of which fails the run with a non-zero exit code:

1. print the card (name, power limit) and build the CUDA kernels from the
   sources under ``src/repro_torch/kernels/csrc`` (time printed as set-up);
2. kernels: flash attention (prefill), decode attention, the Mamba
   selective scan, the RWKV6 WKV recurrence and the flash-attention
   backward against their plain PyTorch versions on the card, bf16
   (tolerance 2e-2) and fp32 (tolerance 1e-4: the kernels sum in another
   order than ATen and use expf/tanhf, on values of order 1; 5e-5 for the
   backward, the reference's own), four times both for the two recurrences
   as in the reference's tests, at the serving
   paths' shapes and at awkward ones. The absolute part of a tolerance is
   scaled by the largest reference value where that is below 1 (a decode
   output averaged over hundreds of slots is of order 0.1); each kernel is
   timed (CUDA events, L2 flushed before every launch, median) beside its
   plain version, one library call where there is one, and its roofline
   bound. Flash attention and its backward run on three routes each, chosen
   by (dtype, head dim): each case prints its route, and the serving- and
   training-shape timings must run on the ``wgmma`` + TMA kernels; rows that
   see no column (a window and a ``q_offset`` past ``S - 1 + window``) must
   give the mean of V and ``lse = -1e30`` on every route. The backward is
   checked with delta given and with delta computed inside from the
   forward's output (as ``ops`` calls it). The WKV recurrence runs through
   both entries: the folded one of the reference's signature, and the
   model-layout one on (B, S, H, D) views in bf16 / fp32, which must equal
   the folded entry bit for bit. Flash and decode attention, the backward and
   the WKV call also report the time of a call as its caller sees it (the
   device idle before it) and the device time of their kernels
   (``torch.profiler``), beside the library call's where there is one (the
   SDPA backward alone: ``torch.autograd.grad`` after one forward);
3. main paths at full width through ``repro_torch.launch.serve``, one after
   the other, each a gateway start-up and a short request trace with a node
   disconnect in the middle, every share run through the engine of its
   accuracy level (batch 8, prompt 512, 16 decode steps, max_len 1024, bf16):
   phi4-mini-3.8b (flash and decode attention), then rwkv6-1.6b (the WKV
   recurrence in every prefill), then jamba-1.5-large at every published
   width, cut to one 8-layer super-block and 8 of 16 experts to fit the card
   (the selective scan in each of its 7 Mamba layers of every prefill, flash
   and decode attention in its attention layer; one engine resident at a
   time), then deepseek-v3-671b at every published width (MLA with the
   weight-absorbed decode, 256 routed experts top-8 and one shared, the MTP
   head), cut to its 3 dense layers and one MoE layer, two engines resident
   where they fit (MLA has no kernel, in the JAX package either, so the
   trace must launch none). Every launch count is set to 0 just before a
   trace and checked just after, and every flash-attention launch of a trace (and every
   forward and backward launch of the train run) must have gone through the
   ``wgmma`` route; the prefill
   logits of one level are then held against the same engine with the
   kernels off (jamba: its first Mamba layer in fp32 copies; the whole
   model's bf16 difference is printed; deepseek: the absorbed decode
   against the dense path on fp32 copies of one MLA layer at full width,
   and one ``loss_fn`` with the MTP term). Each trace's engines are freed
   before the next, so each peak memory is its own;
4. train: phi4-mini-3.8b at full width and depth through
   ``repro_torch.launch.train.run_training`` (fp32 master weights, bf16
   compute, remat, batch 8 x 512, 3 AdamW steps), every step checked for a
   finite loss and grad norm, moved parameters and its launches (K1 twice
   and K5 once a layer), the last step profiled; then the gradients with the
   kernels on held against the einsum path (fp32 copies at 2 layers, leaf by
   leaf; bf16 at full depth, the first step's loss and grad norm); and one
   step with ``remat_policy="save_attn"`` against one with ``"nothing"``
   from the same parameters and batch (the loss bit for bit, the gradients
   to the bf16 limits, K1 and K5 launches, step time and memory of each);
5. the ``kernels`` JSON line, the card line, and the final JSON line.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as dec_k  # noqa: E402
from repro_torch.kernels import flash_attention as fa_k  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab_k  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv_k  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_k  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12
# profiler kernel names: cuBLAS's products, and among them its fp32
# (non-TF32) kernels
GEMM_RE = r"nvjet|gemm|cutlass|sm90_xmma|cublas"
FP32_GEMM_RE = r"f32f32|sgemm|gemm_f32|simt"
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
WKV_TOL = {dt: 4 * t for dt, t in TOL.items()}   # x4 for the recurrences
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}   # the reference's own
LOGITS_TOL = 2e-2       # prefill logits, kernels on against kernels off, bf16
LOGITS_TOL_FP32 = 5e-4  # the same in fp32, relative to the largest logit above 1
# training, kernels on against kernels off. fp32 copies (2 layers): the two
# paths differ only in the order of their sums, so every gradient leaf is
# held to the fp32 kernel tolerance, relative to the leaf's largest value.
# bf16 at full depth, first step: the loss (a mean of per-token CEs, each a
# difference of logits that the two paths give to within LOGITS_TOL) checks
# the forward, K1, only. The backward is held by the attention leaves' gradients
# (wq, wk, wv: K5's dq, dk and dv feed them), leaf by leaf, as the norm of the
# difference relative to the norm of the einsum path's gradient, and by the
# global grad norm. Both limits are about 4-8 times the bf16 rounding drift
# read on an H100: 1.3e-4 on the grad norm; 1.27e-2 on wq and wk and 6.8e-3
# on wv (wo, which K5 does not feed, drifts by 6.7e-3 too). A K5 that dropped
# dq or dk would put a leaf near 1.
GRAD_TOL_FP32 = 1e-4
TRAIN_LOSS_TOL = LOGITS_TOL
TRAIN_GNORM_TOL = 1e-3
ATTN_GRAD_TOL_BF16 = 5e-2

# serving path shapes (phi4-mini-3.8b, batch 8, prompt 512, max_len 1024)
B, H, KV, D, PROMPT, MAX_LEN = 8, 24, 8, 128, 512, 1024
# the train phase: batch x PROMPT tokens a step; the last step is profiled
TRAIN_BATCH, TRAIN_STEPS = 8, 3
# rwkv6-1.6b: 32 heads of 64 folded with the batch, recurrence in fp32
WKV_BH, WKV_D = B * 32, 64
# jamba-1.5-large: 64 q heads / 8 kv heads of 128 (G = 8); Mamba d_inner
# 16384 (expand 2 x d_model 8192), d_state 16; u and dt in bf16
JAMBA_H, SSM_DIN, SSM_N = 64, 16384, 16
JAMBA = "jamba-1.5-large-398b"
# deepseek-v3-671b at every published width, cut to 4 layers: the 3 dense
# layers and one MoE layer with all 256 routed experts (15.80 B parameters,
# 31.6 GB in bf16, at level 0)
DEEPSEEK, DEEPSEEK_LAYERS = "deepseek-v3-671b", 4
# two engines stay resident when the two largest levels and the working set
# of a prefill fit under this (the card holds 80 GB)
TWO_ENGINES_BYTES = 75e9
KERNELS = {"flash_attention": fa_k, "decode_attention": dec_k, "ssm_scan": ssm_k,
           "rwkv6_wkv": wkv_k, "flash_attention_bwd": fab_k}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    return float(out.splitlines()[0]) * 1e6


def jamba_cut_config():
    """jamba-1.5-large at every published width, cut to what one card holds:
    one 8-layer super-block (the least ``layer_plan`` allows: 7 Mamba
    layers, attention at index 3, MoE on layers 1, 3, 5 and 7) and 8 of its
    16 experts a MoE layer. 25.79 B parameters at level 0, 51.6 GB in bf16."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(JAMBA)
    return cfg.scaled(num_layers=cfg.hybrid_block_size,
                      moe=dataclasses.replace(cfg.moe, num_experts=8))


def deepseek_cut_config():
    """deepseek-v3-671b at every published width (MLA with q_lora 1536 and
    kv_lora 512, 128 heads, 256 routed experts top-8 and one shared, the MTP
    head), cut in depth to what one card holds."""
    from repro_torch.configs import get_config

    return get_config(DEEPSEEK).scaled(num_layers=DEEPSEEK_LAYERS)


def reduced_line(arch: str = JAMBA) -> str:
    from repro_torch.configs import get_config

    full = get_config(arch)
    if arch == DEEPSEEK:
        return f"reduced: num_layers {full.num_layers} -> {deepseek_cut_config().num_layers}"
    cut = jamba_cut_config()
    return (f"reduced: num_layers {full.num_layers} -> {cut.num_layers}, "
            f"num_experts {full.moe.num_experts} -> {cut.moe.num_experts}")


def param_bytes(cfg, itemsize: int = 2) -> int:
    """Bytes of ``cfg``'s parameters, from the port's own specs (stacked
    groups included)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import ParamSpec

    plan = {g.name: g.n_units for g in tfm.layer_plan(cfg)}

    def count(spec, stack):
        if isinstance(spec, ParamSpec):
            return int(np.prod(spec.shape)) * (stack if stack is not None else 1)
        return sum(count(v, stack) for v in spec.values())

    return itemsize * sum(count(sub, plan.get(name))
                          for name, sub in tfm.model_param_specs(cfg).items())


class Timer:
    """Median time of one call in ms: CUDA events around each launch, after
    a warm-up, with the 50 MB L2 flushed before every timed launch (on the
    serving path every layer brings its own K and V, so L2 is cold)."""

    def __init__(self, device):
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)

    def __call__(self, fn, warmup: int = 3, iters: int = 15) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        return statistics.median(times)


def reset_counts():
    """Every kernel's launch count, and K1's, K3's and K5's counts by route,
    to 0."""
    for mod in KERNELS.values():
        mod.launches = 0
    for mod in (fa_k, ssm_k, fab_k):
        mod.launches_by_route = dict.fromkeys(mod.ROUTES, 0)


K1_ROUTES = {}   # path -> K1's launches by route, read right after the path ran
K3_ROUTES = {}   # the same for K3, on the paths that launched it
K5_ROUTES = {}   # the same for K5


def _assert_route(mod, record, kernel, where, n, route):
    """Every one of the ``n`` launches on ``route``; a path that launched
    none (an empty record) passes and is not recorded."""
    routes = {r: mod.launches_by_route.get(r, 0) for r in mod.ROUTES}
    assert routes[route] == n and sum(routes.values()) == n, (
        f"{where}: {kernel} launches by route {routes}, expected all {n} on {route}")
    if n:
        record[where] = routes


def assert_k1_wgmma(where, n):
    """Every one of the ``n`` K1 launches counted since the last reset went
    through the ``wgmma`` route."""
    _assert_route(fa_k, K1_ROUTES, "K1", where, n, "wgmma")


def assert_k3_tma(where, n):
    """Every one of the ``n`` K3 launches counted since the last reset went
    through the ``tma`` route."""
    _assert_route(ssm_k, K3_ROUTES, "K3", where, n, "tma")


def assert_k5_wgmma(where, n):
    """Every one of the ``n`` K5 calls counted since the last reset went
    through the ``wgmma`` route."""
    _assert_route(fab_k, K5_ROUTES, "K5", where, n, "wgmma")


def call_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median time of one call as its caller sees it: the device idle before
    the call (synchronised), CUDA events around it, so the host's work in
    the call (checks, allocations, launches) counts whenever the device
    would otherwise wait for it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def device_ms(fn, iters: int = 15, tries: int = 3, label: str = ""):
    """Device time of one call: the kernels' own time under
    ``torch.profiler``, summed over every kernel the call launches, with L2
    flushed before each call (by a ``bitwise_not_`` over 256 MB, whose
    kernel is left out). Returns (ms a call, kernels a call). A profile that
    recorded no kernel at all (CUPTI drops a session now and then) is taken
    again, up to ``tries`` times. With a ``label``, each kernel's time is
    printed."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        rows = [r for r in _profile_rows(prof) if "bitwise_not" not in r[2]]
        if rows:
            for dev_us, count, key in rows if label else ():
                print(f"    {label}: {dev_us / 1e3 / iters:.4f} ms a call, "
                      f"{count / iters:g} a call: {key[:100]}")
            return sum(r[0] for r in rows) / 1e3 / iters, sum(r[1] for r in rows) / iters
    raise AssertionError(f"the profiler saw no kernel of the timed call in {tries} tries")


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def _check(name, got, want, tol):
    """Max abs error, after holding every element to ``atol + tol * |want|``.
    ``atol`` is ``tol`` for references of order 1 and ``tol * max|want|`` for
    smaller ones, so that a small output is not held to a limit of its own
    size."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs().max().item()
    atol = tol * min(1.0, want.abs().max().item())
    bad = ((got - want).abs() > atol + tol * want.abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} elements beyond atol={atol:.3e}, "
                             f"rtol={tol}, max abs err {err}")
    return err


# ----------------------------------------------------------------------
# K1
def _visible_pairs(sq, s, causal, window, q_offset):
    rows = q_offset + np.arange(sq)[:, None]
    cols = np.arange(s)[None, :]
    m = np.ones((sq, s), bool)
    if causal:
        m &= cols <= rows
    if window is not None:
        m &= cols > rows - window
    return int(m.sum())


def flash_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # name, dtype, b, h, kv, sq, s, d, window, softcap, q_offset, causal; the
    # names ending in "contiguous" hand over (B, H, S, D) tensors, the others
    # the transposed views of (B, S, H, D) tensors that ops hands over
    return [
        ("main bf16", bf, B, H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
        ("main fp32 b2", f32, 2, H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
        ("jamba g8 bf16", bf, B, JAMBA_H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
        ("smoke d16 s32 bf16", bf, 2, 4, 2, 32, 32, 16, None, 0.0, 0, True),
        ("smoke d16 s32 fp32", f32, 2, 4, 2, 32, 32, 16, None, 0.0, 0, True),
        ("d16 window 8", f32, 2, 4, 2, 40, 40, 16, 8, 0.0, 0, True),
        ("d256 softcap50 bf16", bf, 1, 8, 4, 256, 256, 256, None, 50.0, 0, True),
        ("d256 window64 fp32", f32, 1, 8, 4, 200, 200, 256, 64, 0.0, 0, True),
        ("ragged s192 window64 bf16", bf, 1, 4, 1, 192, 192, 128, 64, 0.0, 0, True),
        ("ragged s192 window64 fp32", f32, 1, 4, 1, 192, 192, 128, 64, 0.0, 0, True),
        ("softcap30 d64 bf16", bf, 2, 8, 2, 256, 256, 64, None, 30.0, 0, True),
        ("softcap30 d64 fp32", f32, 2, 8, 2, 256, 256, 64, None, 30.0, 0, True),
        ("q_offset 128 fp32", f32, 2, 4, 4, 128, 256, 64, None, 0.0, 128, True),
        ("q_offset 100 window 70 bf16", bf, 2, 4, 2, 90, 190, 128, 70, 0.0, 100, True),
        ("non-causal ragged fp32", f32, 1, 4, 4, 100, 77, 64, None, 0.0, 0, False),
        # the wgmma route (bf16, D 64 and 128): ragged, window with q_offset,
        # soft cap, G 1 / 3 / 8, non-causal, contiguous tensors
        ("wgmma sq77 d128 g3", bf, 2, 6, 2, 77, 77, 128, None, 0.0, 0, True),
        ("wgmma sq200 d64 g1", bf, 2, 4, 4, 200, 200, 64, None, 0.0, 0, True),
        ("wgmma sq192 d128 g8", bf, 1, 16, 2, 192, 192, 128, None, 0.0, 0, True),
        ("wgmma window64 q_offset100 d64", bf, 2, 6, 2, 90, 190, 64, 64, 0.0, 100, True),
        ("wgmma window70 q_offset100 d128", bf, 2, 6, 2, 90, 190, 128, 70, 0.0, 100, True),
        ("wgmma window64 s300 d128 g1", bf, 1, 4, 4, 300, 300, 128, 64, 0.0, 0, True),
        ("wgmma softcap30 d128 g3", bf, 2, 6, 2, 256, 256, 128, None, 30.0, 0, True),
        ("wgmma softcap30 ragged d64 g8", bf, 1, 8, 1, 200, 200, 64, None, 30.0, 0, True),
        ("wgmma non-causal ragged d128", bf, 1, 6, 2, 100, 77, 128, None, 0.0, 0, False),
        ("wgmma non-causal sq300 s200 d64", bf, 1, 4, 2, 300, 200, 64, None, 0.0, 0, False),
        ("wgmma q_offset 128 d128 g1", bf, 2, 4, 4, 128, 256, 128, None, 0.0, 128, True),
        ("wgmma s1 d128 g3 contiguous", bf, 2, 6, 2, 1, 1, 128, None, 0.0, 0, True),
        ("wgmma main d128 contiguous", bf, 2, H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
        ("wgmma ragged d64 g8 contiguous", bf, 2, 8, 1, 200, 200, 64, 64, 0.0, 0, True),
        # rows that see no column (q_offset past S - 1 + window) beside rows that
        # see some, on every route: the mean of V and lse = -1e30 + log S
        ("wgmma blind rows window32 d128 g3", bf, 2, 6, 2, 64, 200, 128, 32, 0.0, 220, True),
        ("wgmma blind rows non-causal d64 g1", bf, 1, 4, 4, 100, 150, 64, 40, 0.0, 150, False),
        ("wgmma blind rows only d128 g8", bf, 1, 16, 2, 128, 300, 128, 64, 30.0, 400, True),
        ("mma blind rows d16", bf, 2, 4, 2, 40, 40, 16, 8, 0.0, 40, True),
        ("fma blind rows d64", f32, 2, 4, 2, 64, 100, 64, 16, 0.0, 100, True),
        ("fma blind rows softcap d128", f32, 1, 4, 1, 70, 130, 128, 50, 30.0, 150, True),
    ]


def _flash_inputs(gen, b, h, kv, sq, s, d, dt, device, contiguous=False):
    """q, k, v as the kernel takes them: transposed views of the model's
    (B, S, H, D) tensors, or contiguous (B, H, S, D) tensors."""
    if contiguous:
        return tuple(_rand(gen, (b, n, t, d), dt, device)
                     for n, t in ((h, sq), (kv, s), (kv, s)))
    return tuple(_rand(gen, (b, t, n, d), dt, device).transpose(1, 2)
                 for n, t in ((h, sq), (kv, s), (kv, s)))


def check_flash(device, timer):
    gen = torch.Generator(device=device).manual_seed(1)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (name, dt, b, h, kv, sq, s, d, window, cap, off, causal) in flash_cases():
        q, k, v = _flash_inputs(gen, b, h, kv, sq, s, d, dt, device,
                                contiguous=name.endswith("contiguous"))
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=off,
                  return_lse=True)
        rt = fa_k.route(dt, d)
        before = fa_k.launches_by_route[rt]
        out, lse = fa_k.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa_k.launches_by_route[rt] == before + 1, (name, rt)
        assert name.startswith("wgmma") <= (rt == "wgmma"), (name, rt)
        assert name.startswith("mma") <= (rt == "mma"), (name, rt)
        assert name.startswith("fma") <= (rt == "fma"), (name, rt)
        ref_out, ref_lse = fa_k.flash_attention_plain(q, k, v, **kw)
        assert out.shape == q.shape and out.dtype == dt and lse.shape == (b, h, sq)
        e1 = _check(f"flash[{name}] out", out, ref_out, TOL[dt])
        e2 = _check(f"flash[{name}] lse", lse, ref_lse, TOL[dt])
        worst[dt] = max(worst[dt], e1)
        blind = fa_k.blind_rows(sq, s, window, off, device=device)
        if "blind" in name:
            assert blind.any(), name
            mean_v = v.float().mean(dim=2).repeat_interleave(h // kv, dim=1)   # (B, H, D)
            _check(f"flash[{name}] mean of V", out[:, :, blind],
                   mean_v[:, :, None, :].expand(-1, -1, int(blind.sum()), -1), TOL[dt])
            assert (lse[:, :, blind] == fa_k.NEG_INF).all(), name
        print(f"  flash {name:32s} route {rt:5s} out err {e1:.3e}  lse err {e2:.3e}"
              + (f"  ({int(blind.sum())} rows see no column)" if blind.any() else ""))

    # timing at the serving shape
    dt = torch.bfloat16
    q = _rand(gen, (B, PROMPT, H, D), dt, device).transpose(1, 2)
    k = _rand(gen, (B, PROMPT, KV, D), dt, device).transpose(1, 2)
    v = _rand(gen, (B, PROMPT, KV, D), dt, device).transpose(1, 2)
    assert fa_k.route(dt, D) == "wgmma"
    out = fa_k.flash_attention(q, k, v)
    err = _check("flash[timed] out", out, fa_k.flash_attention_plain(q, k, v), TOL[dt])
    reset_counts()
    ms = timer(lambda: fa_k.flash_attention(q, k, v))
    assert_k1_wgmma("flash[timed]", fa_k.launches)
    k_call_ms = call_ms(lambda: fa_k.flash_attention(q, k, v))
    k_device_ms, k_kernels = device_ms(lambda: fa_k.flash_attention(q, k, v))
    plain_ms = timer(lambda: fa_k.flash_attention_plain(q, k, v))
    # the fp32 path (FMAs on the CUDA cores) at the same shape, for the record
    qf, kf, vf = q.float(), k.float(), v.float()
    fp32_ms = timer(lambda: fa_k.flash_attention(qf, kf, vf))
    del qf, kf, vf
    try:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                     enable_gqa=True)
        lib()
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
    _check("flash[timed] vs library", out, lib(), TOL[dt])
    library_ms = timer(lib)
    lib_device_ms, lib_kernels = device_ms(lib)
    es = q.element_size()
    nbytes = (2 * B * H * PROMPT * D + 2 * B * KV * PROMPT * D) * es
    flops = 4 * D * B * H * _visible_pairs(PROMPT, PROMPT, True, None, 0)
    t_b, t_f = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
        "library_ms": library_ms, "kernel_route": "wgmma", "call_ms": k_call_ms,
        "device_ms": k_device_ms, "device_kernels_per_call": k_kernels,
        "library_device_ms": lib_device_ms, "library_kernels_per_call": lib_kernels,
        "fp32_path_ms": fp32_ms,
        "shape": f"q({B},{H},{PROMPT},{D}) kv({B},{KV},{PROMPT},{D}) bf16 causal",
        "bytes": nbytes, "flops": flops, "bound_bytes_ms": t_b, "bound_flops_ms": t_f,
        "max_abs_err_all_bf16": worst[torch.bfloat16],
        "max_abs_err_all_fp32": worst[torch.float32],
    }


# ----------------------------------------------------------------------
# K2
def decode_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # name, dtype, b, kv, g, s, d, softcap, lengths (None = random mask), splits
    return [
        ("main bf16", bf, B, KV, 3, MAX_LEN, D, 0.0, [PROMPT + 1 + i for i in range(B)], None),
        ("main fp32", f32, B, KV, 3, MAX_LEN, D, 0.0, [PROMPT + 1 + i for i in range(B)], None),
        ("jamba g8 bf16", bf, B, KV, JAMBA_H // KV, MAX_LEN, D, 0.0,
         [PROMPT + 1 + i for i in range(B)], None),
        ("lengths 1,S-1,S g1 bf16", bf, 3, 4, 1, 256, 128, 0.0, [1, 255, 256], None),
        ("lengths 1,S-1,S g8 fp32", f32, 3, 2, 8, 192, 64, 0.0, [1, 191, 192], None),
        ("g3 single split", bf, 2, 8, 3, 512, 128, 0.0, [300, 512], 1),
        ("g3 seven splits", f32, 2, 8, 3, 500, 128, 0.0, [300, 500], 7),
        ("smoke d16 s32 bf16", bf, 2, 2, 2, 32, 16, 0.0, [7, 32], None),
        ("smoke d16 s32 fp32", f32, 2, 2, 2, 32, 16, 0.0, [1, 31], None),
        ("d256 softcap30 g2 bf16", bf, 2, 4, 2, 300, 256, 30.0, [123, 300], None),
        ("d256 g5 fp32", f32, 1, 4, 5, 130, 256, 0.0, [130], None),
        ("random mask g4 d64 bf16", bf, 4, 2, 4, 777, 64, 0.0, None, None),
        ("random mask g6 softcap fp32", f32, 2, 3, 6, 257, 128, 30.0, None, None),
        # a row with no valid slot: the mean of V, m = -1e30, l = S
        ("all-masked row g3 bf16", bf, 3, 8, 3, 1024, 128, 0.0, [0, 520, 1], None),
        ("all-masked row g8 softcap fp32", f32, 2, 2, 8, 300, 64, 30.0, [0, 7], None),
        ("all-masked rows d16 s32 bf16", bf, 2, 2, 2, 32, 16, 0.0, [0, 0], None),
        ("all-masked row d256 splits 3", f32, 2, 2, 2, 257, 256, 0.0, [0, 257], 3),
        # one valid slot; fewer valid slots than blocks in the cluster
        ("one slot g7 bf16", bf, 8, 2, 7, 1024, 128, 0.0, [1] * 8, None),
        ("3 slots, 8 splits fp32", f32, 2, 4, 4, 512, 64, 0.0, [3, 5], 8),
        ("5 slots, 8 splits bf16", bf, 2, 4, 2, 1024, 128, 0.0, [5, 1], 8),
        ("g1 bf16", bf, 4, 8, 1, 1024, 128, 0.0, [520, 1, 1024, 64], None),
        ("g2 fp32", f32, 4, 8, 2, 1024, 128, 0.0, [520, 3, 1024, 64], None),
        ("g4 bf16", bf, 4, 8, 4, 1024, 128, 0.0, [520, 3, 1024, 64], None),
        ("g5 splits 5 bf16", bf, 2, 8, 5, 700, 128, 0.0, [699, 300], 5),
        ("g6 splits 2 fp32", f32, 2, 4, 6, 700, 64, 0.0, [699, 300], 2),
        ("g7 bf16", bf, 2, 8, 7, 1024, 128, 0.0, [520, 1000], None),
        ("random mask g8 splits 8 bf16", bf, 3, 2, 8, 600, 128, 0.0, None, 8),
    ]


def _prefix_mask(lengths, s, device):
    n = torch.tensor(lengths, device=device)
    return torch.arange(s, device=device)[None, :] < n[:, None]


def check_decode(device, timer):
    gen = torch.Generator(device=device).manual_seed(2)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (name, dt, b, kv, g, s, d, cap, lengths, splits) in decode_cases():
        q = _rand(gen, (b, kv, g, d), dt, device)
        k = _rand(gen, (b, s, kv, d), dt, device)
        v = _rand(gen, (b, s, kv, d), dt, device)
        if lengths is None:
            mask = torch.rand((b, s), generator=gen, device=device) < 0.4
            mask[:, s // 2] = True          # at least one valid slot a row
        else:
            mask = _prefix_mask(lengths, s, device)
        before = dec_k.launches
        out, m, l = dec_k.decode_attention(q, k, v, mask, softcap=cap,
                                           return_stats=True, splits=splits)
        torch.cuda.synchronize()
        assert dec_k.launches == before + 1
        r_out, r_m, r_l = dec_k.decode_attention_plain(q, k, v, mask, softcap=cap,
                                                       return_stats=True)
        assert out.shape == q.shape and out.dtype == dt and m.shape == (b, kv, g, 1)
        e1 = _check(f"decode[{name}] out", out, r_out, TOL[dt])
        e2 = _check(f"decode[{name}] m", m, r_m, TOL[dt])
        e3 = _check(f"decode[{name}] l", l, r_l, TOL[dt])
        worst[dt] = max(worst[dt], e1)
        print(f"  decode {name:31s} out err {e1:.3e}  m err {e2:.3e}  l err {e3:.3e}")
        empty = ~mask.any(dim=1)
        if empty.any():                     # what the TPU kernel gives there
            assert (m[empty] == dec_k.NEG_INF).all() and (l[empty] == s).all(), name
            _check(f"decode[{name}] mean of V", out[empty],
                   v.float().mean(dim=1)[empty][:, :, None, :].expand(-1, -1, g, -1),
                   TOL[dt])

    dt = torch.bfloat16
    g = H // KV
    q = _rand(gen, (B, KV, g, D), dt, device)
    k = _rand(gen, (B, MAX_LEN, KV, D), dt, device)
    v = _rand(gen, (B, MAX_LEN, KV, D), dt, device)
    lengths = [PROMPT + 8] * B                 # the middle of the 16 decode steps
    mask = _prefix_mask(lengths, MAX_LEN, device)
    out = dec_k.decode_attention(q, k, v, mask)
    err = _check("decode[timed] out", out, dec_k.decode_attention_plain(q, k, v, mask),
                 TOL[dt])
    ms = timer(lambda: dec_k.decode_attention(q, k, v, mask))
    k_call_ms = call_ms(lambda: dec_k.decode_attention(q, k, v, mask))
    k_device_ms, k_kernels = device_ms(lambda: dec_k.decode_attention(q, k, v, mask))
    plain_ms = timer(lambda: dec_k.decode_attention_plain(q, k, v, mask))
    ql = q.reshape(B, H, 1, D)
    kl, vl = k.transpose(1, 2), v.transpose(1, 2)
    am = mask[:, None, None, :]
    try:
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am,  # noqa: E731
                                                     enable_gqa=True)
        lib()
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(g, dim=1) for t in (kl, vl))
        lib = lambda: F.scaled_dot_product_attention(ql, ke, ve, attn_mask=am)  # noqa: E731
    _check("decode[timed] vs library", out.reshape(B, H, 1, D), lib(), TOL[dt])
    library_ms = timer(lib)
    lib_call_ms = call_ms(lib)
    lib_device_ms, lib_kernels = device_ms(lib)
    es = q.element_size()
    n_valid = int(mask.sum().item())
    # the kernel loads only valid slots, so the bound counts those
    nbytes = 2 * n_valid * KV * D * es + 2 * B * H * D * es + B * MAX_LEN
    flops = 4 * g * D * KV * n_valid
    t_b, t_f = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:67",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
        "library_ms": library_ms, "call_ms": k_call_ms, "device_ms": k_device_ms,
        "device_kernels_per_call": k_kernels, "library_call_ms": lib_call_ms,
        "library_device_ms": lib_device_ms, "library_kernels_per_call": lib_kernels,
        "shape": f"q({B},{KV},{g},{D}) kv({B},{MAX_LEN},{KV},{D}) bf16, "
                 f"{lengths[0]} valid slots a row (bound counts valid slots)",
        "splits": dec_k.num_splits(B, KV, MAX_LEN, sms),
        "cluster": dec_k.cluster_size(dec_k.num_splits(B, KV, MAX_LEN, sms)),
        "bytes": nbytes, "flops": flops, "bound_bytes_ms": t_b, "bound_flops_ms": t_f,
        "all_slots_bound_ms": (2 * B * MAX_LEN * KV * D * es) / HBM_BW * 1e3,
        "max_abs_err_all_bf16": worst[torch.bfloat16],
        "max_abs_err_all_fp32": worst[torch.float32],
    }


# ----------------------------------------------------------------------
# K4
def wkv_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # name, dtype, bh, s, dk, dv
    return [
        ("main fp32", f32, WKV_BH, PROMPT, WKV_D, WKV_D),
        ("main bf16", bf, WKV_BH, PROMPT, WKV_D, WKV_D),
        ("ragged s200 fp32", f32, 16, 200, 64, 64),
        ("ragged s200 bf16", bf, 16, 200, 64, 64),
        ("s1 fp32", f32, 8, 1, 64, 64),
        ("s1 bf16", bf, 8, 1, 64, 64),
        ("dk24 dv40 s37 fp32", f32, 4, 37, 24, 40),
        ("dk128 dv96 s70 bf16", bf, 4, 70, 128, 96),
        ("smoke d16 s32 fp32", f32, 8, 32, 16, 16),
    ]


def wkv_model_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # name, dtype of r / k / v (w and u fp32), b, s, h, dk, dv, view: "dense"
    # (B, S, H, D) tensors, "sliced" (a column slice of a wider tensor),
    # "transposed" (a transpose of (B, H, S, D) tensors)
    return [
        ("model main bf16", bf, B, PROMPT, WKV_BH // B, WKV_D, WKV_D, "dense"),
        ("model main fp32", f32, B, PROMPT, WKV_BH // B, WKV_D, WKV_D, "dense"),
        ("model s1 bf16 sliced", bf, 2, 1, 4, 64, 64, "sliced"),
        ("model s1 fp32 transposed", f32, 2, 1, 4, 64, 64, "transposed"),
        ("model s200 bf16 sliced", bf, 2, 200, 4, 64, 64, "sliced"),
        ("model s200 fp32 transposed", f32, 2, 200, 4, 64, 64, "transposed"),
        ("model dk128 s200 bf16 transposed", bf, 2, 200, 3, 128, 128, "transposed"),
        ("model dk128 dv96 s70 fp32 sliced", f32, 2, 70, 3, 128, 96, "sliced"),
        ("model dk24 dv40 s37 bf16", bf, 2, 37, 3, 24, 40, "dense"),
        ("model smoke d16 s32 bf16 sliced", bf, 2, 32, 4, 16, 16, "sliced"),
    ]


def _wkv_inputs(gen, bh, s, dk, dv, dt, device):
    """As the reference's kernel test draws them: decays in (0, 1), small k
    and u (u stays fp32, as the model hands it over)."""
    r = _rand(gen, (bh, s, dk), dt, device)
    k = (torch.randn((bh, s, dk), generator=gen, device=device) * 0.3).to(dt)
    v = _rand(gen, (bh, s, dv), dt, device)
    w = torch.sigmoid(torch.randn((bh, s, dk), generator=gen, device=device)).to(dt)
    u = torch.randn((bh, dk), generator=gen, device=device) * 0.1
    return r, k, v, w, u


def _wkv_model_inputs(gen, b, s, h, dk, dv, dt, device, view="dense"):
    """The model-layout entry's inputs, (B, S, H, D): r, k, v in ``dt``, w
    and u in fp32, drawn as :func:`_wkv_inputs` draws them, as the views the
    case names."""
    def make(d, dtype, scale=1.0, squash=False):
        shape = {"dense": (b, s, h, d), "sliced": (b, s, h, d + 8),
                 "transposed": (b, h, s, d)}[view]
        x = torch.randn(shape, generator=gen, device=device) * scale
        x = (torch.sigmoid(x) if squash else x).to(dtype)
        if view == "sliced":
            return x[..., :d]
        return x.transpose(1, 2) if view == "transposed" else x
    r, k = make(dk, dt), make(dk, dt, 0.3)
    v, w = make(dv, dt), make(dk, torch.float32, squash=True)
    u = torch.randn((h, dk), generator=gen, device=device) * 0.1
    return r, k, v, w, u


def _fold(t):
    b, s, h, d = t.shape
    return t.float().transpose(1, 2).reshape(b * h, s, d).contiguous()


def check_wkv(device, timer):
    gen = torch.Generator(device=device).manual_seed(3)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (name, dt, bh, s, dk, dv) in wkv_cases():
        ins = _wkv_inputs(gen, bh, s, dk, dv, dt, device)
        y, st = wkv_k.rwkv6_wkv(*ins)
        torch.cuda.synchronize()
        ref_y, ref_st = wkv_k.rwkv6_wkv_plain(*ins)
        assert y.shape == (bh, s, dv) and y.dtype == dt
        assert st.shape == (bh, dk, dv) and st.dtype == torch.float32
        e1 = _check(f"wkv[{name}] y", y, ref_y, WKV_TOL[dt])
        e2 = _check(f"wkv[{name}] s_final", st, ref_st, WKV_TOL[dt])
        worst[dt] = max(worst[dt], e1, e2)
        print(f"  wkv {name:34s} y err {e1:.3e}  s_final err {e2:.3e}")
    # the model-layout entry: against its plain version, and bit for bit
    # against the folded entry on fp32 copies of the same values (bf16 ->
    # fp32 is exact and the kernel sums in the same order)
    for (name, dt, b, s, h, dk, dv, view) in wkv_model_cases():
        ins = _wkv_model_inputs(gen, b, s, h, dk, dv, dt, device, view)
        before = wkv_k.launches
        y, st = wkv_k.rwkv6_wkv_model(*ins)
        torch.cuda.synchronize()
        assert wkv_k.launches == before + 1, name
        ref_y, ref_st = wkv_k.rwkv6_wkv_model_plain(*ins)
        assert y.shape == (b, s, h, dv) and y.dtype == torch.float32
        assert st.shape == (b, h, dk, dv) and st.dtype == torch.float32
        e1 = _check(f"wkv[{name}] y", y, ref_y, WKV_TOL[dt])
        e2 = _check(f"wkv[{name}] s_final", st, ref_st, WKV_TOL[dt])
        worst[dt] = max(worst[dt], e1, e2)
        r, k, v, w, u = ins
        fy, fst = wkv_k.rwkv6_wkv(_fold(r), _fold(k), _fold(v), _fold(w), u.repeat(b, 1))
        same = (torch.equal(fy.reshape(b, h, s, dv).transpose(1, 2), y)
                and torch.equal(fst.reshape(b, h, dk, dv), st))
        assert same, f"wkv[{name}]: the model-layout entry differs from the folded one"
        print(f"  wkv {name:34s} y err {e1:.3e}  s_final err {e2:.3e}  (= folded entry)")

    # timing at the serving shape: the model-layout entry as rwkv_time_mix
    # calls it (bf16 r, k, v; fp32 w, u, y), and the folded entry in fp32 as
    # the model's fold handed it over before
    nh = WKV_BH // B
    mins = _wkv_model_inputs(gen, B, PROMPT, nh, WKV_D, WKV_D, torch.bfloat16, device)
    y, st = wkv_k.rwkv6_wkv_model(*mins)
    ref_y, ref_st = wkv_k.rwkv6_wkv_model_plain(*mins)
    err = max(_check("wkv[timed] y", y, ref_y, WKV_TOL[torch.bfloat16]),
              _check("wkv[timed] s_final", st, ref_st, WKV_TOL[torch.bfloat16]))
    ms = timer(lambda: wkv_k.rwkv6_wkv_model(*mins))
    k_call_ms = call_ms(lambda: wkv_k.rwkv6_wkv_model(*mins))
    k_device_ms, k_kernels = device_ms(lambda: wkv_k.rwkv6_wkv_model(*mins))
    plain_ms = timer(lambda: wkv_k.rwkv6_wkv_model_plain(*mins), warmup=1, iters=5)
    r, k, v, w, u = mins
    fins = [_fold(r), _fold(k), _fold(v), _fold(w), u.repeat(B, 1)]
    folded_ms = timer(lambda: wkv_k.rwkv6_wkv(*fins))
    # what the model paid before: the four fold copies, the call, the unfold
    fold_call = lambda: wkv_k.rwkv6_wkv(  # noqa: E731
        *[_fold(t) for t in (r, k, v, w)], u.repeat(B, 1))[0].reshape(
            B, nh, PROMPT, WKV_D).transpose(1, 2).contiguous()
    fold_call_ms = timer(fold_call)
    bf_fins = [t.to(torch.bfloat16) for t in fins[:4]] + [fins[4]]
    folded_bf16_ms = timer(lambda: wkv_k.rwkv6_wkv(*bf_fins))
    del bf_fins, fins
    n_el = WKV_BH * PROMPT * WKV_D                       # elements of one (B,S,H,D) tensor
    out_bytes = 4 * n_el + 4 * WKV_BH * WKV_D * WKV_D    # y and s_final in fp32
    nbytes = 3 * 2 * n_el + 4 * n_el + 4 * nh * WKV_D + out_bytes   # bf16 r,k,v; fp32 w, u
    folded_bytes = 4 * 4 * n_el + 4 * WKV_BH * WKV_D + out_bytes    # fp32 r,k,v,w; u per bh
    # per step and state element: r.S (2), k v^T (1), w S + kv (2); the
    # bonus term r.(u*k) is O(Dk) a step
    flops = 5 * WKV_BH * PROMPT * WKV_D * WKV_D
    t_b, t_f = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    t_fb = folded_bytes / HBM_BW * 1e3
    return {
        "name": "rwkv6_wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv.py:55",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
        "library_ms": None, "entry": "rwkv6_wkv_model", "call_ms": k_call_ms,
        "device_ms": k_device_ms, "device_kernels_per_call": k_kernels,
        "folded_fp32_ms": folded_ms, "folded_bf16_ms": folded_bf16_ms,
        "fold_copies_and_call_ms": fold_call_ms,
        "folded_bound_ms": max(t_fb, t_f),
        "folded_bound_by": "bytes" if t_fb >= t_f else "operations",
        "shape": f"r/k/v({B},{PROMPT},{nh},{WKV_D}) bf16, w({B},{PROMPT},{nh},{WKV_D}) fp32, "
                 f"u({nh},{WKV_D}); folded: ({WKV_BH},{PROMPT},{WKV_D}) fp32",
        "bytes": nbytes, "folded_bytes": folded_bytes, "flops": flops,
        "bound_bytes_ms": t_b, "bound_flops_ms": t_f, "folded_bound_bytes_ms": t_fb,
        "max_abs_err_all_bf16": worst[torch.bfloat16],
        "max_abs_err_all_fp32": worst[torch.float32],
    }


# ----------------------------------------------------------------------
# K3
def ssm_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # name, dtype, b, s, d_in, n, the route (dtype, d_in, n) must take, and
    # whether dt * a is drawn to reach about -1000 (dt up to ~50, a down to
    # ~-20: the polynomial exp's clamp)
    return [
        ("serving bf16", bf, B, PROMPT, SSM_DIN, SSM_N, "tma", False),
        ("serving fp32 b2", f32, 2, PROMPT, SSM_DIN, SSM_N, "tma", False),
        ("smoke bf16", bf, 2, 32, 128, 8, "tma", False),
        ("smoke fp32", f32, 2, 32, 128, 8, "tma", False),
        ("ragged s200 fp32", f32, 2, 200, 512, SSM_N, "tma", False),
        ("ragged s200 bf16", bf, 2, 200, 512, SSM_N, "tma", False),
        ("d_in 1000 fp32", f32, 2, 64, 1000, SSM_N, "tma", False),
        ("d_in 1000 bf16", bf, 3, 40, 1000, SSM_N, "tma", False),
        ("s2 fp32", f32, 4, 2, 384, SSM_N, "tma", False),
        ("s2 bf16", bf, 4, 2, 384, SSM_N, "tma", False),
        ("s1 n4 bf16", bf, 3, 1, 256, 4, "tma", False),
        ("n12 d_in 132 s70 fp32", f32, 2, 70, 132, 12, "tma", False),
        ("n8 d_in 1000 s77 bf16", bf, 2, 77, 1000, 8, "tma", False),
        ("n5 s33 d_in 200 fp32", f32, 2, 33, 200, 5, "simple", False),
        ("n3 s17 bf16", bf, 1, 17, 130, 3, "simple", False),
        ("d_in 130 s50 bf16", bf, 2, 50, 130, SSM_N, "simple", False),
        ("d_in 130 s50 fp32", f32, 2, 50, 130, SSM_N, "simple", False),
        ("extreme dt*a bf16", bf, 2, 64, 1024, SSM_N, "tma", True),
        ("extreme dt*a fp32", f32, 2, 64, 1024, SSM_N, "tma", True),
        ("extreme dt*a d_in 130 bf16", bf, 2, 40, 130, SSM_N, "simple", True),
        ("extreme dt*a n5 fp32", f32, 2, 40, 200, 5, "simple", True),
    ]


def _ssm_inputs(gen, b, s, d_in, n, dt_, device, extreme=False):
    """As the reference's kernel test draws them: dt = softplus(N(0,1)/2),
    a = -exp(N(0,1) * 0.3); u and dt in the working dtype, B, C, a and
    d_skip in fp32 (as the model hands them over). ``extreme``: dt uniform
    in [0, 50) and a in (-20, 0], so dt * a * log2(e) reaches about -1400."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    u = rn(b, s, d_in).to(dt_)
    if extreme:
        dt = (torch.rand((b, s, d_in), generator=gen, device=device) * 50).to(dt_)
        a = -torch.rand((d_in, n), generator=gen, device=device) * 20
    else:
        dt = F.softplus(rn(b, s, d_in) * 0.5).to(dt_)
        a = -torch.exp(rn(d_in, n) * 0.3)
    bm, cm = rn(b, s, n), rn(b, s, n)
    d_skip = 1.0 + 0.1 * rn(d_in)
    return u, dt, bm, cm, a, d_skip


# per state element and step, besides its exp: dt * a, du * B, the h FMA
# and the y FMA on the FMA pipe; an exp on that pipe instead of the
# special-function unit costs sm90::ex2_poly's 10 instructions
SSM_FMA_OPS, SSM_POLY_OPS = 4, 10


def _simple_route_call(ins):
    """A call of the simple route's kernel on ``ins`` through its C entry
    (the wrapper sends the serving shape to the tma route); its output is
    held against the plain version once."""
    u, dt, bm, cm, a, d_skip = ins
    b, s, d_in = u.shape
    y = torch.empty_like(u)
    h = torch.empty((b, d_in, a.shape[1]), dtype=torch.float32, device=u.device)

    def call():
        err = ssm_k._kernel_fn("simple")(
            u.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), a.data_ptr(),
            d_skip.data_ptr(), y.data_ptr(), h.data_ptr(), b, s, d_in, a.shape[1],
            1 if u.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"simple route launch failed (code {err})"

    call()
    ref_y, ref_h = ssm_k.ssm_scan_plain(*ins)
    _check("ssm_scan[simple route] y", y, ref_y, WKV_TOL[u.dtype])
    _check("ssm_scan[simple route] h_final", h, ref_h, WKV_TOL[u.dtype])
    return call


def check_ssm_scan(device, timer):
    gen = torch.Generator(device=device).manual_seed(4)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (name, dt_, b, s, d_in, n, want_rt, extreme) in ssm_cases():
        ins = _ssm_inputs(gen, b, s, d_in, n, dt_, device, extreme)
        rt = ssm_k.route(dt_, d_in, n)
        assert rt == want_rt, (name, rt)
        before = ssm_k.launches_by_route[rt]
        y, h = ssm_k.ssm_scan(*ins)
        torch.cuda.synchronize()
        assert ssm_k.launches_by_route[rt] == before + 1, (name, rt)
        ref_y, ref_h = ssm_k.ssm_scan_plain(*ins)
        assert y.shape == (b, s, d_in) and y.dtype == dt_
        assert h.shape == (b, d_in, n) and h.dtype == torch.float32
        e1 = _check(f"ssm_scan[{name}] y", y, ref_y, WKV_TOL[dt_])
        e2 = _check(f"ssm_scan[{name}] h_final", h, ref_h, WKV_TOL[dt_])
        worst[dt_] = max(worst[dt_], e1, e2)
        print(f"  ssm_scan {name:29s} route {rt:6s} y err {e1:.3e}  h_final err {e2:.3e}")
        del ins, y, h, ref_y, ref_h

    # timing at the serving shape (jamba prefill: batch 8 x 512, bf16 u/dt)
    dt_ = torch.bfloat16
    assert ssm_k.route(dt_, SSM_DIN, SSM_N) == "tma"
    ins = _ssm_inputs(gen, B, PROMPT, SSM_DIN, SSM_N, dt_, device)
    y, h = ssm_k.ssm_scan(*ins)
    ref_y, ref_h = ssm_k.ssm_scan_plain(*ins)
    err = max(_check("ssm_scan[timed] y", y, ref_y, WKV_TOL[dt_]),
              _check("ssm_scan[timed] h_final", h, ref_h, WKV_TOL[dt_]))
    del y, h, ref_y, ref_h
    k3 = lambda: ssm_k.ssm_scan(*ins)  # noqa: E731
    reset_counts()
    ms = timer(k3)
    assert_k3_tma("ssm_scan[timed]", ssm_k.launches)
    k_call_ms = call_ms(k3)
    k_device_ms, k_kernels = device_ms(k3, label="K3")
    plain_ms = timer(lambda: ssm_k.ssm_scan_plain(*ins), warmup=1, iters=5)
    f32_ins = [t.float() for t in ins]
    fp32_ms = timer(lambda: ssm_k.ssm_scan(*f32_ins))
    # the parent design, the simple route's kernel (csrc/ssm_scan.cu), on the
    # same inputs through its own C entry: the yardstick of the redesign
    simple = _simple_route_call(ins)
    simple_ms = timer(simple)
    simple_device_ms, _ = device_ms(simple, label="K3 simple route")
    simple_fp32_ms = timer(_simple_route_call(f32_ins))
    del f32_ins
    es = ins[0].element_size()
    steps = B * PROMPT * SSM_DIN * SSM_N            # state-element steps
    nbytes = (3 * B * PROMPT * SSM_DIN * es          # u, dt, y
              + 2 * 4 * B * PROMPT * SSM_N           # B, C
              + 4 * SSM_DIN * SSM_N + 4 * SSM_DIN    # a, d_skip
              + 4 * B * SSM_DIN * SSM_N)             # h_final
    # per state element and step: dt * a, exp, da * h + du * B (2), h * C
    flops = 5 * steps
    t_b, t_f = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    # the exps alone on the special-function units (16 a clock an SM), and
    # the best split of them between those units and the FMA pipe (128 fp32
    # lanes a clock an SM) that also carries the SSM_FMA_OPS: a share p on
    # the polynomial balances (ops + poly p) / 128 = (1 - p) / 16; both at
    # the card's largest SM clock
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm_clock = steps / (sms * max_sm_clock_hz()) * 1e3
    sfu_ms = per_sm_clock / 16
    p = (128 - 16 * SSM_FMA_OPS) / (128 + 16 * SSM_POLY_OPS)
    mixed_ms = per_sm_clock * (1 - p) / 16
    return {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_sm90.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:61",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
        "library_ms": None, "kernel_route": "tma", "call_ms": k_call_ms,
        "device_ms": k_device_ms, "device_kernels_per_call": k_kernels,
        "fp32_path_ms": fp32_ms, "simple_route_ms": simple_ms,
        "simple_route_device_ms": simple_device_ms, "simple_route_fp32_ms": simple_fp32_ms,
        "sfu_exp_bound_ms": sfu_ms,
        "mixed_pipe_bound_ms": mixed_ms, "mixed_pipe_poly_share": p,
        "simple_route_source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "shape": f"u/dt({B},{PROMPT},{SSM_DIN}) bf16, B/C({B},{PROMPT},{SSM_N}) fp32",
        "bytes": nbytes, "flops": flops, "bound_bytes_ms": t_b, "bound_flops_ms": t_f,
        "max_abs_err_all_bf16": worst[torch.bfloat16],
        "max_abs_err_all_fp32": worst[torch.float32],
    }


# ----------------------------------------------------------------------
# K5
def flash_bwd_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # name, dtype, b, h, kv, sq, s, d, window, softcap, q_offset, causal; the
    # names ending in "contiguous" hand over (B, H, S, D) tensors, the others
    # the transposed views of (B, S, H, D) tensors that ops hands over
    return [
        ("train bf16", bf, B, H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
        ("train fp32 b2", f32, 2, H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
        ("g1 d64 bf16", bf, 2, 4, 4, 256, 256, 64, None, 0.0, 0, True),
        ("g1 d64 fp32", f32, 2, 4, 4, 256, 256, 64, None, 0.0, 0, True),
        ("g3 d128 ragged s200 bf16", bf, 2, 12, 4, 200, 200, 128, None, 0.0, 0, True),
        ("g3 d128 ragged s200 fp32", f32, 2, 12, 4, 200, 200, 128, None, 0.0, 0, True),
        ("g4 window64 softcap30 bf16", bf, 2, 8, 2, 256, 256, 128, 64, 30.0, 0, True),
        ("g4 window64 softcap30 fp32", f32, 2, 8, 2, 256, 256, 128, 64, 30.0, 0, True),
        ("q_offset 128 bf16", bf, 2, 4, 2, 128, 256, 64, None, 0.0, 128, True),
        ("q_offset 100 window 70 fp32", f32, 2, 4, 2, 90, 190, 128, 70, 0.0, 100, True),
        ("smoke d16 s32 bf16", bf, 2, 4, 2, 32, 32, 16, None, 0.0, 0, True),
        ("smoke d16 s32 fp32", f32, 2, 4, 2, 32, 32, 16, None, 0.0, 0, True),
        ("d16 window 8 softcap 5 fp32", f32, 2, 4, 2, 40, 40, 16, 8, 5.0, 0, True),
        ("d256 softcap50 bf16", bf, 1, 8, 4, 256, 256, 256, None, 50.0, 0, True),
        ("d256 window64 ragged fp32", f32, 1, 8, 4, 200, 200, 256, 64, 0.0, 0, True),
        ("non-causal ragged fp32", f32, 1, 4, 4, 100, 77, 64, None, 0.0, 0, False),
        ("non-causal ragged bf16", bf, 1, 6, 2, 100, 77, 64, None, 0.0, 0, False),
        # the wgmma route (bf16, D 64 and 128): ragged Sq / S, window with soft
        # cap, window with q_offset, G 1 / 3 / 8, non-causal, rows that see no
        # column, contiguous tensors
        ("wgmma ragged s200 d64 g8", bf, 1, 8, 1, 200, 200, 64, None, 0.0, 0, True),
        ("wgmma ragged s77 d128 g3", bf, 2, 6, 2, 77, 77, 128, None, 0.0, 0, True),
        ("wgmma window64 softcap30 d64 g3", bf, 2, 6, 2, 256, 256, 64, 64, 30.0, 0, True),
        ("wgmma window70 q_offset100 d128 g1", bf, 2, 4, 4, 90, 190, 128, 70, 0.0, 100, True),
        ("wgmma window70 q_offset100 d64 g8", bf, 1, 16, 2, 90, 190, 64, 70, 0.0, 100, True),
        ("wgmma g8 s512 d128", bf, 1, 16, 2, 512, 512, 128, None, 0.0, 0, True),
        ("wgmma non-causal sq100 s300 d128", bf, 1, 6, 2, 100, 300, 128, None, 0.0, 0, False),
        ("wgmma blind rows d128 g3", bf, 2, 6, 2, 64, 200, 128, 32, 0.0, 220, True),
        ("wgmma sq3 d64 g3 contiguous", bf, 2, 6, 2, 3, 3, 64, None, 0.0, 0, True),
        ("wgmma train d128 contiguous", bf, 2, H, KV, PROMPT, PROMPT, D, None, 0.0, 0, True),
    ]


def _bwd_inputs(gen, b, h, kv, sq, s, d, dt, device, contiguous=False, **kw):
    """q, k, v, dout in the model's layout (transposed views, as ops hands
    them over) or contiguous, lse / delta from the forward's plain version,
    and that forward's output."""
    q, k, v = _flash_inputs(gen, b, h, kv, sq, s, d, dt, device, contiguous=contiguous)
    dout = (_rand(gen, (b, h, sq, d), dt, device) if contiguous
            else _rand(gen, (b, sq, h, d), dt, device).transpose(1, 2))
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (q, k, v, dout, lse, fab_k.delta_of(dout, out)), out


def check_flash_bwd(device, timer):
    gen = torch.Generator(device=device).manual_seed(5)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for (name, dt, b, h, kv, sq, s, d, window, cap, off, causal) in flash_bwd_cases():
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
        ins, out = _bwd_inputs(gen, b, h, kv, sq, s, d, dt, device,
                               contiguous=name.endswith("contiguous"), **kw)
        rt = fab_k.route(dt, d)
        assert name.startswith("wgmma") <= (rt == "wgmma"), (name, rt)
        before = fab_k.launches_by_route[rt]
        got = fab_k.flash_attention_bwd(*ins, **kw)
        torch.cuda.synchronize()
        assert fab_k.launches_by_route[rt] == before + 1, (name, rt)
        want = fab_k.flash_attention_bwd_plain(*ins, **kw)
        errs = []
        for what, x, y, ref_in in zip(("dq", "dk", "dv"), got, want, ins[:3]):
            assert x.shape == ref_in.shape and x.dtype == dt, (what, x.shape, x.dtype)
            errs.append(_check(f"flash_bwd[{name}] {what}", x, y, BWD_TOL[dt]))
        worst[dt] = max(worst[dt], *errs)
        blind = fa_k.blind_rows(sq, s, window, off, device=device)
        if "blind" in name:      # p = 0 on every pair of a row that sees no column
            assert blind.any() and (got[0][:, :, blind] == 0).all(), name
        # the call as ops makes it: delta from the forward's output inside K5
        got_o = fab_k.flash_attention_bwd(*ins[:5], out=out, **kw)
        torch.cuda.synchronize()
        for what, x, y in zip(("dq", "dk", "dv"), got_o, want):
            errs.append(_check(f"flash_bwd[{name}] {what} (delta from out)", x, y, BWD_TOL[dt]))
        worst[dt] = max(worst[dt], *errs)
        print(f"  flash_bwd {name:34s} route {rt:5s} dq {errs[0]:.3e}  dk {errs[1]:.3e}  "
              f"dv {errs[2]:.3e}; delta from out: {max(errs[3:]):.3e}")

    # timing at the training shape (phi4-mini-3.8b, batch 8 x 512, bf16)
    dt = torch.bfloat16
    ins, out = _bwd_inputs(gen, B, H, KV, PROMPT, PROMPT, D, dt, device)
    assert fab_k.route(dt, D) == "wgmma"
    got = fab_k.flash_attention_bwd(*ins[:5], out=out)
    want = fab_k.flash_attention_bwd_plain(*ins)
    err = max(_check(f"flash_bwd[timed] {w}", x, y, BWD_TOL[dt])
              for w, x, y in zip(("dq", "dk", "dv"), got, want))
    # timed as ops._Flash.backward calls it: delta = rowsum(dout * out) inside
    # K5's dq kernel, where SDPA's backward computes its own too
    k5 = lambda: fab_k.flash_attention_bwd(*ins[:5], out=out)  # noqa: E731
    reset_counts()
    ms = timer(k5)
    assert_k5_wgmma("flash_bwd[timed]", fab_k.launches)
    k_call_ms = call_ms(k5)
    k_device_ms, k_kernels = device_ms(k5, label="K5")
    given_delta_ms = timer(lambda: fab_k.flash_attention_bwd(*ins))
    plain_ms = timer(lambda: fab_k.flash_attention_bwd_plain(*ins))
    fins = [t.float() for t in ins]
    fp32_ms = timer(lambda: fab_k.flash_attention_bwd(*fins))
    del fins
    # the separate delta pass the call ran before this PR, for the record
    dout = ins[3]
    delta_fn = lambda: fab_k.delta_of(dout, out)  # noqa: E731
    delta_ms = timer(delta_fn)
    delta_device_ms, _ = device_ms(delta_fn, label="delta pass")
    # library yardstick: the backward of SDPA on the same q, k, v, dout. Timed
    # as forward + backward minus forward (CUDA events), and its device time
    # alone: the forward runs once with grad, then only
    # torch.autograd.grad(out, (q, k, v), dout) is profiled
    q, k, v = (t.detach().requires_grad_(True) for t in ins[:3])
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        method = "sdpa(enable_gqa) fwd+bwd minus fwd"
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        sdpa = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
        method = "sdpa(repeated kv) fwd+bwd minus fwd"

    def fwd_bwd():
        q.grad = k.grad = v.grad = None
        sdpa().backward(dout)

    fwd_bwd()
    # two bf16 computations of the same gradient: twice the tolerance
    _check("flash_bwd[timed] vs library dq", got[0], q.grad, 2 * BWD_TOL[dt])
    with torch.no_grad():
        fwd_ms = timer(sdpa)
    library_ms = timer(fwd_bwd) - fwd_ms
    lib_out = sdpa()
    lib_bwd = lambda: torch.autograd.grad(lib_out, (q, k, v), dout,  # noqa: E731
                                          retain_graph=True)
    lib_device_ms, lib_kernels = device_ms(lib_bwd, label="SDPA backward")
    del q, k, v, lib_out, out
    es = ins[0].element_size()
    n_q, n_kv = B * H * PROMPT * D, B * KV * PROMPT * D
    nbytes = (3 * n_q + 4 * n_kv) * es + 2 * 4 * B * H * PROMPT  # q,dout,dq; k,v,dk,dv; lse,delta
    # the function needs 5 products a visible pair (q.k, dout.v, dv, dq, dk);
    # the two-kernel design computes q.k and dout.v in both kernels, 7 in all
    pair_flops = 2 * D * B * H * _visible_pairs(PROMPT, PROMPT, True, None, 0)
    flops, design_flops = 5 * pair_flops, 7 * pair_flops
    t_b, t_f = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:153",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations",
        "library_ms": library_ms, "library_method": method, "library_fwd_ms": fwd_ms,
        "kernel_route": "wgmma", "call_ms": k_call_ms, "device_ms": k_device_ms,
        "device_kernels_per_call": k_kernels, "library_device_ms": lib_device_ms,
        "library_kernels_per_call": lib_kernels, "delta_inside": True,
        "given_delta_ms": given_delta_ms, "separate_delta_pass_ms": delta_ms,
        "separate_delta_pass_device_ms": delta_device_ms,
        "fp32_path_ms": fp32_ms,
        "shape": f"q/dout({B},{H},{PROMPT},{D}) kv({B},{KV},{PROMPT},{D}) bf16 causal",
        "bytes": nbytes, "flops": flops, "bound_bytes_ms": t_b, "bound_flops_ms": t_f,
        "design_flops": design_flops,
        "design_flops_ms": design_flops / PEAK_FLOPS[dt] * 1e3,
        "max_abs_err_all_bf16": worst[torch.bfloat16],
        "max_abs_err_all_fp32": worst[torch.float32],
    }


# ----------------------------------------------------------------------
def _launches_per_run(cfg, steps):
    """The launches one prefill and ``steps`` decode steps of ``cfg`` make:
    K1 once and K2 once a step for every GQA attention layer, K3 for every
    Mamba layer, K4 for every RWKV layer; none for an MLA layer (MLA has no
    kernel, in the JAX package either)."""
    from repro_torch.models import transformer as tfm

    n = {"gqa": 0, "mla": 0, "mamba": 0, "rwkv": 0}
    for g in tfm.layer_plan(cfg):
        for sl in g.pattern:
            n[sl.mixer] += g.n_units
    return {"flash_attention": n["gqa"], "decode_attention": n["gqa"] * steps,
            "ssm_scan": n["mamba"], "rwkv6_wkv": n["rwkv"], "flash_attention_bwd": 0}


def run_trace(device, args, cfg, max_engines=None):
    """One request trace through ``launch.serve``'s entry points at full
    width. Every kernel's launch count is set to 0 just before it and read
    just after, and held against the layers of the levels that ran. Returns
    (report, counts)."""
    from repro_torch.core.variants import VariantPool
    from repro_torch.launch import serve

    pool = VariantPool(cfg)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    report = serve.serve_trace(
        cfg.name, cfg=cfg, policy="proportional", requests=args.requests,
        disconnect=True, smoke=False, device=device, dtype="bfloat16", batch=B,
        prompt_len=PROMPT, decode_steps=args.decode_steps, max_len=MAX_LEN,
        seed=args.seed, max_engines=max_engines, verbose=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    if counts["flash_attention"]:
        assert_k1_wgmma(cfg.name, counts["flash_attention"])
    if counts["ssm_scan"]:
        assert_k3_tma(cfg.name, counts["ssm_scan"])
    peak = torch.cuda.max_memory_allocated()

    runs = report["runs"]
    assert runs, "no share was executed"
    assert report["disconnected"], "the trace did not disconnect a node"
    for r in runs:
        assert r["tokens"].shape == (B, args.decode_steps), r["tokens"].shape
        assert r["tokens"].min() >= 0 and r["tokens"].max() < cfg.vocab_size
        assert r["finite"], f"non-finite logits at level {r['level']}"
    want = {k: 0 for k in KERNELS}
    for r in runs:
        for k, v in _launches_per_run(pool[r["level"]].config, args.decode_steps).items():
            want[k] += v
    assert counts == want, f"{cfg.name}: launches {counts} != layers x prefills / steps {want}"
    levels = sorted({r["level"] for r in runs})
    print(f"{cfg.name}: {len(report['results'])} requests, {len(runs)} shares run "
          f"(= prefills), levels {levels}, {report['engine_builds']} engine builds, "
          f"launches {counts}, wall {wall:.1f} s")
    pre = statistics.median(r["prefill_ms"] for r in runs)
    dec = statistics.median(r["decode_ms_per_step"] for r in runs)
    print(f"{cfg.name}: prefill {pre:.2f} ms (batch {B} x {PROMPT}), "
          f"{dec:.3f} ms per decode step, {B * 1e3 / dec:.1f} tokens/s decode, "
          f"peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    by_level = {}
    for r in runs:
        by_level.setdefault(r["level"], []).append((r["prefill_ms"], r["decode_ms_per_step"]))
    print(f"{cfg.name}: by level (prefill ms, ms per step): "
          + "; ".join(f"{lv}: " + ", ".join(f"({p:.1f}, {d:.2f})" for p, d in v)
                      for lv, v in sorted(by_level.items())))
    return report, counts


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def kernels_vs_einsum(device, args, engine, fp32=False):
    """Prefill logits of ``engine``'s weights with ``use_kernels`` on and
    off (``fp32``: copies of them in float32). Returns (max abs difference,
    max |logit|)."""
    from repro_torch.launch import serve

    cfg, params = engine.cfg, engine.params
    if fp32:
        cfg, params = cfg.scaled(dtype="float32"), _tree_float(params)
    toks = serve.make_prompts(cfg.vocab_size, B, PROMPT, seed=args.seed, device=device)
    logits = [serve.Engine(cfg, params, serve.EngineConfig(max_len=MAX_LEN,
                                                           use_kernels=on),
                           device=device).prefill(toks)[0]
              for on in (True, False)]
    torch.cuda.synchronize()
    assert logits[0].shape == (B, cfg.vocab_size) and torch.isfinite(logits[0]).all()
    diff = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    print(f"{cfg.name}: prefill logits kernels vs einsum path, "
          f"{cfg.dtype}: max abs diff {diff:.6f} (max |logit| {scale:.3f})")
    return diff, scale


def _lowest_engine(report):
    lvl = min(report["engines"])
    print(f"(kernels on/off on the level-{lvl} engine of the trace)")
    return report["engines"][lvl]


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def jamba_checks(device, args, cfg):
    """Kernels on against off for the cut jamba, on the level-0 engine
    rebuilt from its seed (the trace's bounded pool has dropped it).

    Printed, not held: the whole model's bf16 prefill logits, and the share
    of tokens whose expert pair at the first MoE layer differs between the
    two paths (in bf16 a top-2 choice near a tie flips on a last-bit
    difference upstream). Held: the first Mamba layer at full width on fp32
    copies of its leaves and the real hidden state that reaches it, with the
    kernel on and off, to LOGITS_TOL_FP32 relative to the largest output
    above 1."""
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16", max_len=MAX_LEN,
                           seed=args.seed, max_engines=1).engine_for(0)
    toks = serve.make_prompts(eng.cfg.vocab_size, B, PROMPT, seed=args.seed, device=device)
    route = moe_mod.route_topk
    first, current = {}, [None]

    def recording(c, router_logits):   # keeps the first MoE layer's choice
        gates, idx = route(c, router_logits)
        first.setdefault(current[0], idx.sort(dim=-1).values)
        return gates, idx

    logits = []
    moe_mod.route_topk = recording
    try:
        for on in (True, False):
            current[0] = on
            logits.append(serve.Engine(eng.cfg, eng.params,
                                       serve.EngineConfig(max_len=MAX_LEN, use_kernels=on),
                                       device=device).prefill(toks)[0])
    finally:
        moe_mod.route_topk = route
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in logits)
    diff = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    flipped = (first[True] != first[False]).any(dim=-1).float().mean().item()
    print(f"{cfg.name}: bf16 prefill logits kernels vs einsum path, level 0: max abs "
          f"diff {diff:.6f} (max |logit| {scale:.3f}); expert pair differs at the first "
          f"MoE layer for {flipped:.4%} of {first[True].shape[0]} tokens (printed, not held)")
    del logits, first

    # fp32 copies of the first Mamba layer and the hidden state it sees
    g = tfm.layer_plan(cfg)[0]
    i = next(k for k, sl in enumerate(g.pattern) if sl.mixer == "mamba")
    sub = eng.params[g.name][f"sub{i}"]
    p32 = {k: v[0].float() for k, v in sub["mamba"].items()}
    cfg32 = eng.cfg.scaled(dtype="float32")
    with torch.inference_mode():
        x = embed_tokens(eng.cfg, eng.params["embed"], toks, torch.bfloat16)
        h = tfm._norm(eng.cfg, sub["norm_mixer"][0], x).float()
        outs = [ssm.mamba_apply_dense(cfg32, p32, h, None, use_kernel=on)
                for on in (True, False)]
    torch.cuda.synchronize()
    (y_on, st_on), (y_off, st_off) = outs
    d_y = (y_on - y_off).abs().max().item()
    s_y = y_off.abs().max().item()
    d_h = (st_on.h - st_off.h).abs().max().item()
    s_h = st_off.h.abs().max().item()
    nbytes = sum(v.numel() * 4 for v in p32.values())
    print(f"{cfg.name}: fp32 copies of layer {i} (Mamba, {nbytes / 1e9:.2f} GB), kernel on "
          f"/ off: output max abs diff {d_y:.3e} (max |out| {s_y:.3f}), h_final "
          f"{d_h:.3e} (max |h| {s_h:.3f})")
    tol = LOGITS_TOL_FP32 * max(1.0, s_y)
    assert d_y <= tol, f"Mamba layer kernel on/off in fp32: {d_y} > {tol}"
    assert d_h <= LOGITS_TOL_FP32 * max(1.0, s_h), f"Mamba h_final on/off in fp32: {d_h}"
    del eng, p32, outs, x, h
    _free()


def deepseek_checks(device, args, cfg):
    """On the cut deepseek's level-0 engine, rebuilt from its seed (the
    trace's pool has been freed):

    * the weight-absorbed decode against the dense path, at full width
      (128 heads, latent 512) on fp32 copies of the first MLA layer's leaves
      and the hidden state that reaches it: ``mla_attention_dense`` over
      PROMPT tokens; apart, a prefill of PROMPT - 1 tokens, the cache padded
      to MAX_LEN, one ``mla_attention_decode`` step; the outputs at the last
      position held to LOGITS_TOL_FP32 of the largest output value above 1;
    * one ``loss_fn`` at batch B x PROMPT under ``torch.no_grad()``: ce, the
      MoE aux and the MTP term, each finite;
    * ``Engine.generate`` at level 0 (the trace's plan need not pick it),
      twice: its prefill ms and ms per decode step."""
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16", max_len=MAX_LEN,
                           seed=args.seed, max_engines=1).engine_for(0)
    toks = serve.make_prompts(eng.cfg.vocab_size, B, PROMPT, seed=args.seed, device=device)

    g = tfm.layer_plan(cfg)[0]
    sub = eng.params[g.name]["sub0"]
    p32 = {k: v[0].float() for k, v in sub["attn"].items()}
    cfg32 = eng.cfg.scaled(dtype="float32")
    with torch.inference_mode():
        x = embed_tokens(eng.cfg, eng.params["embed"], toks, torch.bfloat16)
        h = tfm._norm(eng.cfg, sub["norm_mixer"][0], x).float()
        pos = torch.arange(PROMPT, device=device)[None]
        dense, _ = attn.mla_attention_dense(cfg32, p32, h, pos)
        dense = dense[:, -1]
        _, raw = attn.mla_attention_dense(cfg32, p32, h[:, :-1], pos[:, :-1])
        cache = attn.MLACache(*(F.pad(t, (0, 0, 0, MAX_LEN - (PROMPT - 1))) for t in raw))
        del raw
        step, _ = attn.mla_attention_decode(cfg32, p32, h[:, -1:], cache,
                                            torch.full((B,), PROMPT - 1, device=device))
    torch.cuda.synchronize()
    d = (step[:, 0] - dense).abs().max().item()
    scale = dense.abs().max().item()
    nbytes = sum(v.numel() * 4 for v in p32.values())
    print(f"{cfg.name}: absorbed decode vs dense path, fp32 copies of {g.name} unit 0 "
          f"(MLA, {nbytes / 1e9:.2f} GB; {cfg.num_heads} heads, latent "
          f"{cfg.mla.kv_lora_rank}), position {PROMPT - 1} of batch {B}: max abs diff "
          f"{d:.3e} (max |out| {scale:.3f}, limit {LOGITS_TOL_FP32} x max(1, max |out|))")
    assert torch.isfinite(step).all() and d <= LOGITS_TOL_FP32 * max(1.0, scale), (
        f"absorbed MLA decode vs dense in fp32: {d}")
    del p32, x, h, dense, cache, step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        total, metrics = model_lib.loss_fn(eng.cfg, eng.params, {"tokens": toks},
                                           use_kernels=True)
        vals = {k: float(v) for k, v in {"total": total, **metrics}.items()}
    ms = (time.perf_counter() - t0) * 1e3
    print(f"{cfg.name}: loss_fn of the level-0 engine, batch {B} x {PROMPT}, no grad: "
          + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()) + f" ({ms:.1f} ms)")
    assert set(vals) == {"total", "ce", "aux", "mtp"} and all(
        np.isfinite(v) for v in vals.values()), vals
    del total, metrics
    _free()

    for run in (1, 2):
        out = eng.generate(toks, num_steps=args.decode_steps)
        st = eng.last_stats
        assert st["finite"] and out.shape == (B, args.decode_steps), st
        print(f"{cfg.name}: level 0 generate, run {run}: prefill {st['prefill_ms']:.2f} ms "
              f"(batch {B} x {PROMPT}), {st['decode_ms_per_step']:.3f} ms per decode step, "
              f"{B * 1e3 / st['decode_ms_per_step']:.1f} tokens/s decode")
    del eng
    _free()


def deepseek_trace(device, args):
    """The cut deepseek through ``launch.serve``: two engines resident where
    the two largest levels fit beside a prefill's working set, else one.
    MLA launches no kernel, so every launch count must stay 0."""
    from repro_torch.core.variants import VariantPool

    cfg = deepseek_cut_config()
    m = cfg.mla
    assert (cfg.d_model, cfg.num_heads, m.q_lora_rank, m.kv_lora_rank) == (7168, 128, 1536, 512)
    assert (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim) == (128, 64, 128)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) == (256, 8, 2048)
    assert (cfg.d_ff_dense, cfg.vocab_size, cfg.mtp_depth) == (18432, 129280, 1)
    print(reduced_line(DEEPSEEK))
    pool = VariantPool(cfg)
    sizes = sorted((param_bytes(v.config) for v in pool.variants), reverse=True)
    # a prefill's working set: the fp32 scores of two MLA products, the MoE
    # buffers and the logits, a few GB; 8 GB is kept free for it
    max_engines = 2 if sizes[0] + sizes[1] + 8e9 <= TWO_ENGINES_BYTES else 1
    print(f"{cfg.name}: parameters by level "
          + ", ".join(f"{param_bytes(v.config) / 1e9:.1f}" for v in pool.variants)
          + f" GB in bf16; max_engines={max_engines} (the two largest levels take "
          f"{(sizes[0] + sizes[1]) / 1e9:.1f} GB)")
    report, counts = run_trace(device, args, cfg, max_engines=max_engines)
    assert not any(counts.values()), f"{cfg.name}: a kernel was launched: {counts}"
    del report
    _free()
    deepseek_checks(device, args, cfg)
    return counts


def main_path(device, args):
    """The four traces, one after the other. Returns the launch counts of
    each kernel, read right after each trace."""
    from repro_torch.configs import get_config

    out = {}
    cfg = get_config("phi4-mini-3.8b")
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model) == (H, KV, D, 3072)
    report, counts = run_trace(device, args, cfg)
    # bf16 activations through up to 32 layers: the kernel path and the
    # einsum path round at other places. The limit is a few times what they
    # differ by and a tenth of a typical logit.
    diff, _ = kernels_vs_einsum(device, args, _lowest_engine(report))
    assert diff <= LOGITS_TOL, f"kernel and einsum paths disagree: {diff} > {LOGITS_TOL}"
    out["phi4"] = counts
    del report
    _free()

    cfg = get_config("rwkv6-1.6b")
    assert (cfg.d_model // cfg.ssm.wkv_head_dim, cfg.ssm.wkv_head_dim) == (
        WKV_BH // B, WKV_D)
    report, counts = run_trace(device, args, cfg)
    # Both recurrences run in fp32 and differ only in the order of their
    # sums, but in bf16 a last-bit difference flips roundings that 24 layers
    # of random weights amplify (0.29 on logits of 5.1 on an H100; a 24-layer
    # model of width 256 shows the same on the CPU, 0.09 in bf16 and 4e-5 in
    # fp32). So the bf16 difference is printed and the check is made on fp32
    # copies of the same weights, to the reference's end-to-end 5e-4.
    eng = _lowest_engine(report)
    kernels_vs_einsum(device, args, eng)
    diff, scale = kernels_vs_einsum(device, args, eng, fp32=True)
    tol = LOGITS_TOL_FP32 * max(1.0, scale)
    assert diff <= tol, f"kernel and einsum paths disagree in fp32: {diff} > {tol}"
    out["rwkv6"] = counts
    del report, eng
    _free()

    cfg = jamba_cut_config()
    ssm_cfg = cfg.ssm
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (JAMBA_H, KV, D)
    assert (ssm_cfg.expand * cfg.d_model, ssm_cfg.d_state) == (SSM_DIN, SSM_N)
    print(reduced_line())
    # two levels do not fit on the card together (51.6 + 45.7 GB)
    report, counts = run_trace(device, args, cfg, max_engines=1)
    out["jamba"] = counts
    del report
    _free()
    jamba_checks(device, args, cfg)

    out["deepseek"] = deepseek_trace(device, args)
    return out


def _probe(params):
    """A few elements of every kind of leaf, to see that a step moved them."""
    lay = params["layers"]["sub0"]
    return {
        "embedding": params["embed"]["embedding"][:4, :8],
        "final_norm": params["final_norm"][:8],
        "norm_mixer": lay["norm_mixer"][0, :8],
        "wq": lay["attn"]["wq"][0, :4, 0, :4],
        "w_down": lay["mlp"]["w_down"][-1, :4, :4],
    }


def _profile_rows(prof):
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator row repeats its kernels' device time
        # and no named range (the profiler puts those on the device timeline too)
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith(
                ("train.", "profile.")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def train_phase(device, args):
    """phi4-mini-3.8b trained at full width and depth through
    ``launch.train.run_training``: fp32 master weights, bf16 compute, remat,
    batch ``TRAIN_BATCH`` x 512 from the synthetic stream, ``TRAIN_STEPS``
    steps. Every step is checked (finite loss and grad norm, parameters that
    moved, K1 = 2 x layers and K5 = layers launches: remat runs each layer's
    forward twice). Then the gradients with the kernels on are held against
    the einsum path: leaf by leaf in fp32 copies at full width and 2 layers;
    at full depth in bf16, the first step's loss and grad norm and the
    attention leaves' gradients. Returns the launch counts of the training
    run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import train as train_launch
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfg = get_config("phi4-mini-3.8b")
    n_layers, batch, steps = cfg.num_layers, TRAIN_BATCH, TRAIN_STEPS
    rec = {"events": [], "loss": [], "gnorm": [], "prev": None, "counts": None,
           "prof": None, "prof_wall": None}

    def counts():
        return {name: mod.launches for name, mod in KERNELS.items()}

    def on_step(i, state, metrics):
        snap = {k: v.detach().clone() for k, v in _probe(state.params).items()}
        now = counts()
        if metrics is not None:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            assert np.isfinite(loss) and np.isfinite(gnorm), (i, loss, gnorm)
            still = [k for k in snap if torch.equal(snap[k], rec["prev"][k])]
            assert not still, f"step {i}: parameters did not move: {still}"
            delta = {k: now[k] - rec["counts"][k] for k in now}
            want = {"flash_attention": 2 * n_layers, "flash_attention_bwd": n_layers,
                    "decode_attention": 0, "ssm_scan": 0, "rwkv6_wkv": 0}
            assert delta == want, f"step {i}: launches {delta} != {want}"
            rec["loss"].append(loss)
            rec["gnorm"].append(gnorm)
            print(f"  train step {i}: loss {loss:.5f}  grad norm {gnorm:.5f}  "
                  f"launches {delta}")
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rec["events"].append(ev)
        if rec["prof"] is not None:                 # end of the profiled step
            torch.cuda.synchronize()
            rec["prof_wall"] = (time.perf_counter() - rec["prof_t0"]) * 1e3
            rec["prof"].__exit__(None, None, None)
            rec["prof_done"], rec["prof"] = rec["prof"], None
        elif metrics is not None and i == steps - 2:   # profile the last step
            rec["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            rec["prof"].__enter__()
            rec["prof_t0"] = time.perf_counter()
        rec["prev"], rec["counts"] = snap, now

    reset_counts()
    fab_k.copied_bytes = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    losses = train_launch.run_training(
        cfg, device=device, steps=steps, global_batch=batch, seq_len=PROMPT,
        seed=args.seed, remat=True, use_kernels=True, log_every=1, verbose=True,
        on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    total = counts()
    assert_k1_wgmma("train", total["flash_attention"])
    assert_k5_wgmma("train", total["flash_attention_bwd"])
    peak = torch.cuda.max_memory_allocated()
    assert len(losses) == steps and total["flash_attention_bwd"] == steps * n_layers
    ev = rec["events"]
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    clean = step_ms[1:-1] or step_ms[-1:]          # neither warm-up nor profiled
    ms = statistics.median(clean)
    print(f"train phi4-mini-3.8b: {steps} steps of {batch} x {PROMPT} tokens, full width "
          f"and depth, bf16 compute, fp32 master, remat; step ms "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} (first: warm-up, last: profiled); "
          f"{ms:.1f} ms a step, {batch * PROMPT * 1e3 / ms:.0f} tokens/s; "
          f"peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); wall {wall:.1f} s; "
          f"launches {total}; K5 operand copies {fab_k.copied_bytes} bytes")
    assert peak < 80e9, f"peak memory {peak} above the card's 80 GB"
    rows = _profile_rows(rec["prof_done"])
    if not rows:
        raise AssertionError("the profiler saw no device time in the train step")
    busy = sum(r[0] for r in rows) / 1e3
    print(f"profile[train step {steps - 1}]: wall {rec['prof_wall']:.1f} ms (profiler on), "
          f"device busy {busy:.1f} ms, idle share {max(0.0, 1 - busy / rec['prof_wall']):.3f}")
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    cats = {"K1 flash_fwd": 0.0, "K5 bwd_dq/bwd_dkv": 0.0, "matmul (cuBLAS)": 0.0,
            "other (ATen elementwise, copies, reductions)": 0.0}
    for dev_us, _, key in rows:
        if "flash_fwd" in key:
            cats["K1 flash_fwd"] += dev_us
        elif "bwd_dq" in key or "bwd_dkv" in key:
            cats["K5 bwd_dq/bwd_dkv"] += dev_us
        elif re.search(GEMM_RE, key, re.I):
            cats["matmul (cuBLAS)"] += dev_us
        else:
            cats["other (ATen elementwise, copies, reductions)"] += dev_us
    print("  by kind: " + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / 1e3 / busy:.1%})"
                                    for k, v in cats.items()))
    # the range's own device time is its span on the device timeline, which
    # the optimizer's stream of large elementwise kernels keeps busy
    opt_ms = max([(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))
                  for e in rec["prof_done"].key_averages()
                  if e.key == "train.apply_updates"] or [0]) / 1e3
    print(f"  optimizer (span of the range train.apply_updates on the device): "
          f"{opt_ms:.1f} ms; loss, forward and backward: the other "
          f"{busy - opt_ms:.1f} ms of busy time")
    first_loss, first_gnorm = rec["loss"][0], rec["gnorm"][0]
    del rec
    gc.collect()
    torch.cuda.empty_cache()

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=PROMPT,
                                      global_batch=batch, seed=args.seed))
    tokens = to_device(data.batch(0), device)

    # full depth, bf16, the first step from the run's initial state: its loss
    # and grad norm with the kernels on are the run's own; the attention
    # leaves' gradients come from one more first step on each path
    attn = {}
    for on in (True, False):
        tcfg = ts.TrainConfig(remat=True, use_kernels=on)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = ts.init_train_state(cfg, tcfg, gen, device=device).params
        loss, _, grads = ts.loss_and_grads(cfg, tcfg, params, tokens)
        if not on:
            off_loss, off_gnorm = float(loss), float(opt_lib.global_norm(grads))
        attn[on] = grads["layers"]["sub0"]["attn"]
        del params, grads, loss
        gc.collect()
        torch.cuda.empty_cache()
    d_loss, d_gnorm = abs(first_loss - off_loss), abs(first_gnorm - off_gnorm) / off_gnorm
    rel = {k: ((attn[True][k] - attn[False][k]).norm() / attn[False][k].norm()).item()
           for k in sorted(attn[False])}
    print(f"train bf16 full depth, first step, kernels on / off: loss {first_loss:.6f} / "
          f"{off_loss:.6f} (diff {d_loss:.2e}, checks the forward only), grad norm "
          f"{first_gnorm:.6f} / {off_gnorm:.6f} (rel diff {d_gnorm:.2e}); attention "
          f"gradients, |on - off| / |off| by leaf: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    del attn
    assert d_loss <= TRAIN_LOSS_TOL, f"loss kernels on/off {d_loss} > {TRAIN_LOSS_TOL}"
    assert d_gnorm <= TRAIN_GNORM_TOL, f"grad norm on/off {d_gnorm} > {TRAIN_GNORM_TOL}"
    for k in ("wq", "wk", "wv"):
        assert rel[k] <= ATTN_GRAD_TOL_BF16, (
            f"bf16 gradient of {k}, kernels on/off: {rel[k]} > {ATTN_GRAD_TOL_BF16}")

    save_attn_step(device, args, cfg, tokens)

    # fp32 copies at full width, 2 layers: every gradient leaf
    cfg2 = cfg.scaled(num_layers=2, dtype="float32")
    params = ts.init_train_state(cfg2, tcfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device).params
    got = {}
    for on in (True, False):
        tc = ts.TrainConfig(remat=True, use_kernels=on)
        loss, _, grads = ts.loss_and_grads(cfg2, tc, params, tokens)
        got[on] = (float(loss), grads)
    worst, worst_key = 0.0, None
    for key, (g_on, g_off) in zip(
            _leaf_keys(got[True][1]), zip(opt_lib._leaves(got[True][1]),
                                          opt_lib._leaves(got[False][1]))):
        rel = (g_on - g_off).abs().max().item() / max(g_off.abs().max().item(), 1e-30)
        assert rel <= GRAD_TOL_FP32, f"fp32 gradient {key}: rel diff {rel} > {GRAD_TOL_FP32}"
        if rel >= worst:
            worst, worst_key = rel, key
    print(f"train fp32 copies, full width, 2 layers, kernels on / off: loss "
          f"{got[True][0]:.6f} / {got[False][0]:.6f}; worst gradient leaf {worst_key} "
          f"rel diff {worst:.2e} (limit {GRAD_TOL_FP32})")
    del got, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return total


def save_attn_step(device, args, cfg, tokens):
    """One loss-and-gradients step of ``cfg`` at full width and depth with
    ``remat_policy="save_attn"`` (each mixer's output kept as well as each
    layer's input), from the same parameters and batch as one with
    ``"nothing"``. Held: the loss bit for bit, the gradients to the train
    phase's bf16 limits (every leaf's difference relative to its norm under
    ATTN_GRAD_TOL_BF16, the grad norm to TRAIN_GNORM_TOL), K1 twice and K5
    once a layer under both policies (the JAX package's ``save_attn`` reruns
    the flash forward as well: the attention's backward needs q, k, v, out
    and lse, which neither policy keeps). Printed: the step time (CUDA
    events) and the memory the step adds, at its peak, to what was held
    before it, for each policy twice, in turns (nothing, save_attn,
    save_attn, nothing); the first two are compared, and their gradients
    dropped before the last two run."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    params = ts.init_train_state(cfg, ts.TrainConfig(), torch.Generator(
        device=device).manual_seed(args.seed), device=device).params
    kept, losses, times, peaks = None, {}, {}, {}
    for i, policy in enumerate(("nothing", "save_attn", "save_attn", "nothing")):
        tcfg = ts.TrainConfig(remat=True, use_kernels=True, remat_policy=policy)
        _free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        loss, _, grads = ts.loss_and_grads(cfg, tcfg, params, tokens)
        t1.record()
        torch.cuda.synchronize()
        counts = {k: KERNELS[k].launches for k in ("flash_attention", "flash_attention_bwd")}
        times.setdefault(policy, []).append(t0.elapsed_time(t1))
        peaks.setdefault(policy, []).append((torch.cuda.max_memory_allocated() - base) / 1e9)
        assert counts == {"flash_attention": 2 * cfg.num_layers,
                          "flash_attention_bwd": cfg.num_layers}, (policy, counts)
        assert_k1_wgmma(f"train[{policy}]", counts["flash_attention"])
        assert_k5_wgmma(f"train[{policy}]", counts["flash_attention_bwd"])
        losses.setdefault(policy, float(loss))
        if i == 0:
            kept = (loss, grads)
        elif i == 1:
            compared = _compare_policies(kept, (loss, grads), opt_lib)
            kept = None
        del grads, loss
    for policy in ("nothing", "save_attn"):
        print(f"train remat_policy={policy!r}: loss {losses[policy]:.6f}, step (loss and "
              f"gradients, no update) {' / '.join(f'{t:.1f}' for t in times[policy])} ms, "
              f"peak memory above what was held before "
              f"{' / '.join(f'{m:.2f}' for m in peaks[policy])} GB, launches K1 "
              f"{2 * cfg.num_layers}, K5 {cfg.num_layers} each time")
    print(compared)
    del params
    _free()


def _compare_policies(nothing, save_attn, opt_lib) -> str:
    """The ``save_attn`` step's (loss, gradients) against the ``"nothing"``
    step's; returns the line to print."""
    (l0, g0), (l1, g1) = nothing, save_attn
    assert torch.equal(l0, l1), f"save_attn loss {float(l1)} != nothing {float(l0)}"
    worst, worst_key, equal, n = 0.0, None, 0, 0
    for key, (a, b) in zip(_leaf_keys(g0), zip(opt_lib._leaves(g1), opt_lib._leaves(g0))):
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        equal += int(torch.equal(a, b))
        n += 1
        if rel >= worst:
            worst, worst_key = rel, key
    n0, n1 = float(opt_lib.global_norm(g0)), float(opt_lib.global_norm(g1))
    assert worst <= ATTN_GRAD_TOL_BF16 and abs(n1 - n0) / n0 <= TRAIN_GNORM_TOL, (
        f"save_attn gradients vs nothing: worst leaf {worst_key} {worst}, norms {n1} / {n0}")
    return (f"train save_attn vs nothing: loss equal bit for bit; {equal} of {n} gradient "
            f"leaves equal bit for bit; worst leaf {worst_key} |diff| / |nothing| "
            f"{worst:.2e} (limit {ATTN_GRAD_TOL_BF16}); grad norm {n1:.6f} / {n0:.6f}")


def _leaf_keys(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_keys(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1]


def profile_phase(device, args):
    """Where the time goes (not part of the default run): ``torch.profiler``
    over one prefill and four decode steps of the full-width level-0 engine
    (jamba: of the cut config the trace runs). Prints wall time, the device's
    busy time and idle share, the kernels that take most of the device time
    and the busy time by kind."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    if args.arch == JAMBA:
        cfg = jamba_cut_config()
        print(reduced_line())
    elif args.arch == DEEPSEEK:
        cfg = deepseek_cut_config()
        print(reduced_line(DEEPSEEK))
    else:
        cfg = get_config(args.arch)
    torch.cuda.reset_peak_memory_stats()
    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16", max_len=MAX_LEN,
                           seed=args.seed).engine_for(0)
    toks = serve.make_prompts(cfg.vocab_size, B, PROMPT, seed=args.seed, device=device)
    eng.generate(toks, num_steps=2)                      # warm-up
    logits, caches, lengths = eng.prefill(toks)
    state = {"caches": caches, "lengths": lengths, "tok": logits.argmax(-1)}

    def decode4():
        for _ in range(4):
            lg, state["caches"], state["lengths"] = eng.decode(
                state["caches"], state["lengths"], state["tok"])
            state["tok"] = lg.argmax(-1)

    for name, fn in (("prefill", lambda: eng.prefill(toks)), ("4 decode steps", decode4)):
        torch.cuda.synchronize()
        with _model_ranges(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _profile_rows(prof)
        busy_ms = sum(r[0] for r in rows) / 1e3
        print(f"profile[{name}]: wall {wall_ms:.2f} ms (profiler on), device busy "
              f"{busy_ms:.2f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
        if not rows:
            raise AssertionError("the profiler saw no device time")
        for dev_us, count, key in rows[:12]:
            print(f"    {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
        cats = dict.fromkeys(("K1 flash_fwd", "K2 decode", "K3 ssm scan", "K4 wkv",
                              "matmul (cuBLAS)",
                              "other (ATen elementwise, copies, reductions, sort)"), 0.0)
        for dev_us, _, key in rows:
            if "flash_fwd" in key:
                cats["K1 flash_fwd"] += dev_us
            elif "decode" in key and "kernel" in key:
                cats["K2 decode"] += dev_us
            elif "scan_kernel" in key:
                cats["K3 ssm scan"] += dev_us
            elif "wkv_kernel" in key:
                cats["K4 wkv"] += dev_us
            elif re.search(GEMM_RE, key, re.I):
                cats["matmul (cuBLAS)"] += dev_us
            else:
                cats["other (ATen elementwise, copies, reductions, sort)"] += dev_us
        print("  by kind: " + ", ".join(f"{k} {v / 1e3:.2f} ms ({v / 1e3 / busy_ms:.1%})"
                                        for k, v in cats.items() if v))
        by_range = _range_device_ms(prof)
        for part, split in by_range.items():
            print(f"  {part}: {split['all']:.2f} ms ({split['all'] / busy_ms:.1%} of busy): "
                  + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items() if k != "all"))
        if by_range:
            print(f"  outside those ranges (embedding, norms, residuals, LM head): "
                  f"{busy_ms - sum(v['all'] for v in by_range.values()):.2f} ms")
    print(f"profile: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


class _model_ranges:
    """Wraps the model's MLA, MoE and dense-MLP entry points in profiler
    ranges named ``profile.*`` while the context is open (the model's own
    code carries no ranges)."""

    def __enter__(self):
        from repro_torch.models import attention as attn
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as tfm

        self.saved = [(attn, "mla_attention_dense", "profile.mla"),
                      (attn, "mla_attention_decode", "profile.mla"),
                      (moe_mod, "moe_apply", "profile.moe"),
                      (tfm, "mlp_apply", "profile.dense mlp")]
        self.saved = [(mod, name, label, getattr(mod, name)) for mod, name, label in self.saved]
        for mod, name, label, fn in self.saved:
            setattr(mod, name, self._ranged(label, fn))
        return self

    @staticmethod
    def _ranged(label, fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, _, fn in self.saved:
            setattr(mod, name, fn)


def _range_device_ms(prof) -> dict:
    """Device time (ms) of the kernels launched under each ``profile.*``
    range, split into {"all", "fp32 matmul", "bf16 matmul", "other"} by
    kernel name."""
    out = {}

    def kernels(ev):
        for k in getattr(ev, "kernels", []):
            yield k.name, k.duration
        for ch in ev.cpu_children:
            yield from kernels(ch)

    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.name.startswith("profile."):
            continue
        if ev.cpu_parent is not None and ev.cpu_parent.name.startswith("profile."):
            continue        # a range inside another: its kernels count there
        split = out.setdefault(ev.name[len("profile."):], dict.fromkeys(
            ("all", "fp32 matmul", "bf16 matmul", "other"), 0.0))
        for kname, us in kernels(ev):
            kind = ("other" if not re.search(GEMM_RE, kname, re.I) else
                    "fp32 matmul" if re.search(FP32_GEMM_RE, kname, re.I) else "bf16 matmul")
            split["all"] += us / 1e3
            split[kind] += us / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "main", "train", "profile"),
                    default="all")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", choices=("phi4-mini-3.8b", "rwkv6-1.6b", JAMBA, DEEPSEEK),
                    default="phi4-mini-3.8b", help="the model --phase profile runs "
                    f"({JAMBA}: cut to one super-block and 8 experts; {DEEPSEEK}: cut "
                    f"to {DEEPSEEK_LAYERS} layers)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda)

    t0 = time.time()
    _build.load()
    print(f"set-up: kernels built in {time.time() - t0:.1f} s "
          f"({len(_build.sources())} sources -> {_build.build_dir()})")
    for src, log in re.findall(r"== (\S+) \(exit \d+\)\n(.*?)(?=\n== |\Z)",
                               _build.build_log(), re.S):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            print(f"  ptxas {src}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers "
                  f"a thread, {sum(1 for x in spills if x)} with spills "
                  f"(most {max(spills, default=0)} bytes)")
        for line in sorted(set(re.findall(r"^.*(?:wgmma|setmaxnreg).*$", log, re.M))):
            print(f"  ptxas {src}: {line.strip()[:200]}")

    kernels = []
    if args.phase in ("all", "kernels"):
        timer = Timer(device)
        print("kernels against their plain versions on the card:")
        kernels = [check_flash(device, timer), check_decode(device, timer),
                   check_ssm_scan(device, timer), check_wkv(device, timer),
                   check_flash_bwd(device, timer)]
        for kd in kernels:
            lib = "none" if kd["library_ms"] is None else f"{kd['library_ms']:.4f} ms"
            print(f"  {kd['name']}: {kd['ms']:.4f} ms, plain {kd['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {kd['bound_ms']:.4f} ms ({kd['bound_by']})")
            if "device_ms" in kd:
                lcall, ldev = kd.get("library_call_ms"), kd.get("library_device_ms")
                print(f"    {kd['name']}: call {kd['call_ms']:.4f} ms, device "
                      f"{kd['device_ms']:.4f} ms ({kd['device_kernels_per_call']:g} "
                      f"kernels a call)"
                      + ("; library: " if ldev is not None else "")
                      + (f"call {lcall:.4f} ms, " if lcall is not None else "")
                      + (f"device {ldev:.4f} ms ({kd['library_kernels_per_call']:g} "
                         f"kernels a call)" if ldev is not None else ""))
            if kd["name"] == "flash_attention_bwd":
                print(f"    flash_attention_bwd: delta inside; with delta given "
                      f"{kd['given_delta_ms']:.4f} ms; the separate delta pass it replaces "
                      f"{kd['separate_delta_pass_ms']:.4f} ms (device "
                      f"{kd['separate_delta_pass_device_ms']:.4f} ms)")
            if kd["name"] == "ssm_scan":
                print(f"    ssm_scan: the parent design (simple route's kernel) on the same "
                      f"inputs {kd['simple_route_ms']:.4f} ms, device "
                      f"{kd['simple_route_device_ms']:.4f} ms, fp32 "
                      f"{kd['simple_route_fp32_ms']:.4f} ms")
                print(f"    ssm_scan: route tma; fp32 path {kd['fp32_path_ms']:.4f} ms; bounds: "
                      f"bytes {kd['bound_bytes_ms']:.4f} ms, the exps on the special-function "
                      f"units {kd['sfu_exp_bound_ms']:.4f} ms, split with the FMA pipe "
                      f"({kd['mixed_pipe_poly_share']:.3f} on the polynomial) "
                      f"{kd['mixed_pipe_bound_ms']:.4f} ms")
            if kd["name"] == "rwkv6_wkv":
                print(f"    rwkv6_wkv: folded entry fp32 {kd['folded_fp32_ms']:.4f} ms, bf16 "
                      f"{kd['folded_bf16_ms']:.4f} ms (bound {kd['folded_bound_ms']:.4f} ms, "
                      f"{kd['folded_bound_by']}); fold copies + folded call + unfold "
                      f"{kd['fold_copies_and_call_ms']:.4f} ms")
        del timer
        torch.cuda.empty_cache()
    paths = {}      # path -> the launch counts read right after it ran
    if args.phase in ("all", "main"):
        paths.update(main_path(device, args))
    if args.phase in ("all", "train"):
        paths["train"] = train_phase(device, args)
    if args.phase == "all":
        # each kernel's launches on the path that carries it (K1 and K2: the
        # first trace), and on every path that ran it
        own = {"flash_attention": "phi4", "decode_attention": "phi4",
               "ssm_scan": "jamba", "rwkv6_wkv": "rwkv6", "flash_attention_bwd": "train"}
        for kd in kernels:
            kd["launches"] = paths[own[kd["name"]]][kd["name"]]
            kd["launches_by_path"] = {p: c[kd["name"]] for p, c in paths.items()
                                      if c[kd["name"]]}
            if kd["launches"] <= 0:
                raise AssertionError(f"{kd['name']} was not launched on the main path")
            if kd["name"] == "flash_attention":
                kd["launches_by_route"] = {p: r for p, r in K1_ROUTES.items()
                                           if p != "flash[timed]"}
            if kd["name"] == "ssm_scan":
                kd["launches_by_route"] = {p: r for p, r in K3_ROUTES.items()
                                           if p != "ssm_scan[timed]"}
            if kd["name"] == "flash_attention_bwd":
                kd["launches_by_route"] = {p: r for p, r in K5_ROUTES.items()
                                           if p != "flash_bwd[timed]"}

    if args.phase == "profile":
        profile_phase(device, args)

    print(json.dumps({"kernels": kernels}))
    print(card)
    if args.phase != "all":
        print(f"partial run (--phase {args.phase}): no final result line")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
