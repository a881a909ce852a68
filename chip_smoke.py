#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --phase kernels     # or: main, archs, train, sim, dryrun, profile
    python3 chip_smoke.py --phase dryrun --all     # every dry-run cell
    python3 chip_smoke.py --phase profile --arch deepseek-v3-671b   # or any served arch

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
   forward's output (as ``ops`` calls it), bf16 at D 256 on its ``wgmma``
   route among its cases. Decode attention's bf16 instance runs both
   products on the tensor cores: its cases span G 1-8 at D 64, 128 and 256,
   with prefix and scattered masks, all-masked rows, soft cap 50 and splits
   1-8, and it is timed at the served shapes of qwen3-32b (G 8), musicgen
   (D 64) and gemma2-2b (D 256) beside SDPA with ``attn_mask``. The WKV recurrence runs through
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
   trace and checked just after, and every flash-attention launch of a trace
   must have gone through the route of the model's head dim (``wgmma`` at
   D 128 on these four; every forward and backward launch of the train run
   too); the prefill
   logits of one level are then held against the same engine with the
   kernels off (jamba: its first Mamba layer in fp32 copies; the whole
   model's bf16 difference is printed; deepseek: the absorbed decode
   against the dense path on fp32 copies of one MLA layer at full width,
   and one ``loss_fn`` with the MTP term). Each trace's engines are freed
   before the next, so each peak memory is its own;
4. archs: the six archs that had run only as dry-run steps, at every
   published width, bf16, random weights, with the main phase's settings:
   request traces through ``launch.serve`` of gemma2-2b (K1 on ``wgmma`` at D
   256, soft caps 50 and 30, local/global pairs; all six levels resident),
   gemma2-27b, qwen3-32b (K2 at G 8) and mixtral-8x7b cut to 16 layers with
   all 8 experts (one engine resident; each trace's memory reckoned first),
   then llava-next-mistral-7b (2880 patch positions, ``max_len`` 4096) and
   musicgen-medium through the engine of each of their six levels with
   stub-frontend embeddings ahead of the prompt (neither package's ``serve``
   passes such embeddings). Launch counts are held to layers x prefills /
   steps and K1's route to the head dim's; after each model, kernels on
   against off on its level-0 weights: the bf16 prefill logits printed, fp32
   copies of its leading layer units (up to 40 GB) held to the end-to-end
   tolerance, where K1 runs its ``fma`` route and K2 its fp32 instance
   (mixtral: its first attention layer; expert-pair flips printed, and the
   bf16 logits again with the experts pinned to the einsum path's); then
   gemma2-2b's sliding-window ring past its wrap (prompt 4608, window 4096,
   16 decode steps into 5120 slots; in bf16 every K1 and K2 call held
   against its plain version on the same inputs and the logits printed; on
   fp32 copies the logits held, every step, and the last step against a
   prefill); last, every bf16 kernel call of the traces and of the
   stub-frontend runs, recorded by signature, replayed once a signature
   against its plain version at the kernels phase's tolerances and timed,
   as the dryrun phase replays its cells' calls;
5. train: phi4-mini-3.8b at full width and depth through
   ``repro_torch.launch.train.run_training`` (fp32 master weights, bf16
   compute, remat, batch 8 x 512, 3 AdamW steps), every step checked for a
   finite loss and grad norm, moved parameters and its launches (K1 twice
   and K5 once a layer and microbatch), the last step profiled; then the
   gradients with the kernels on held against the einsum path (fp32 copies
   at 2 layers, leaf by leaf; bf16 at full depth, the first step's loss and
   grad norm and attention leaves); and one step with
   ``remat_policy="save_attn"`` against one with ``"nothing"`` from the
   same parameters and batch (the loss bit for bit, the gradients to the
   bf16 limits, K1 and K5 launches, step time and memory of each). Then, the
   same way, each memory reckoned first: gemma2-2b at full width and depth
   (2 x 5120 tokens in 2 microbatches: past its 4096 window, so the local
   layers' window masks pairs in K1 and K5; K1 and K5 on ``wgmma`` at D 256)
   and mixtral-8x7b at every width with all 8 experts, cut to 2 layers (8 x
   512; ``wgmma``; the loss with its load-balance term), every K1 and K5
   call of their first steps held against the plain version on its own
   inputs; bf16 on/off at the trained depth and fp32 copies leaf by leaf
   (gemma2-2b: one local and one global layer at S 5120; mixtral: one
   layer), mixtral's experts pinned to the einsum path's choices by (layer,
   pass) and the share its router would have flipped printed; last, every
   kernel call of those two runs replayed by signature against its plain
   version;
6. sim: the online simulator (``repro_torch.launch.sim``, pure host code)
   over analytic ``H100_SXM`` tables of phi4-mini-3.8b, the six scenarios of
   the golden digests x ``proportional`` x {none, full} at horizon 6 s,
   seed 0, 2 standby nodes, each run twice and held to the same digest of
   records, log and summary; then the sharded control plane on
   ``fleet-64``, ``cells=1`` held to the unsharded run record for record,
   and ``cells=4``; and ``fleet-1024`` (requests sized for 64-node cells)
   at ``cells=16`` under full control, run twice, held to one digest and
   required to serve requests within deadline. One JSON line per case (goodput, p99, shed rate, mean
   accuracy, events/s, wall time: host times, beside the card line); every
   kernel's launch count must stay 0 across the phase;
7. dryrun: ``repro_torch.launch.dryrun.run_cell`` with the kernels on, at
   every published width, on phi4-mini-3.8b's ``train_4k``, ``prefill_32k``
   and ``decode_32k``, gemma2-2b's ``prefill_32k`` (K1's ``wgmma`` route at
   bf16, D 256, S up to 8192), qwen3-32b's ``decode_32k`` (K2 at G = 8 over
   32768 slots) and rwkv6-1.6b's ``prefill_32k`` (K4) and ``long_500k``: each
   cell's step runs at one data shard's batch of the reference's mesh at 2
   and 4 layer units (prefill at 3 lengths), one JSON line a cell (counted
   and analytic FLOPs, reckoned bytes, the roofline with H100 peaks, peak
   memory and step time at the depths run), every output finite and each
   kernel's launches equal to layers x calls at those depths; then the
   kernels-off FLOP count held against the kernels-on count plus the
   kernels' analytic FLOPs (phi4-mini at 2 layers, prefill and decode, to
   1e-9); then every kernel call the cells made, replayed once for each
   distinct signature (each tensor's shape, strides and dtype, every other
   argument's value) on random inputs of that layout and held against its
   plain version (run in slices of batch and kv heads where its score
   matrix is large), timed; and K1 and K2 at gemma2-2b's and qwen3-32b's
   shapes timed beside their plain versions and SDPA. ``--phase dryrun
   --all`` runs every cell of ``configs.cells()`` instead (outside ``all``);
8. the ``kernels`` JSON line, the card line, and the final JSON line.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
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
from repro_torch.kernels.ops import KERNELS, ROUTED  # noqa: E402

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
# the train phase's runs after phi4's: (arch, global batch, sequence length,
# microbatches, layers and sequences of the fp32 hold). gemma2-2b at full
# width and depth with sequences past its 4096 window, so that its local
# layers' window masks pairs in K1 and K5, and its fp32 hold one local and
# one global layer at that length; mixtral-8x7b at every published width
# with all 8 experts, cut to MIXTRAL_TRAIN_LAYERS layers (3.16 B
# parameters), its fp32 hold one layer
TRAIN_RUNS = (("gemma2-2b", 2, 5120, 2, 2, 1), ("mixtral-8x7b", TRAIN_BATCH, 512, 1, 1, 8))
MIXTRAL_TRAIN_LAYERS = 2
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
# mixtral-8x7b at every published width with all 8 experts, cut to 16 of its
# 32 layers (47.0 GB in bf16 at level 0; the whole model is 93.4 GB)
MIXTRAL, MIXTRAL_LAYERS = "mixtral-8x7b", 16
# the archs phase: four traces through the gateway, (arch, max_engines); then
# the two stub-frontend archs through the engine of each level
ARCH_TRACES = (("gemma2-2b", None), ("gemma2-27b", 1), ("qwen3-32b", 1), (MIXTRAL, 1))
STUB_ARCHS = ("llava-next-mistral-7b", "musicgen-medium")
# kernels on against off in fp32: copies of as many leading layer units as
# stay within this many bytes; the check's batch is cut so that one layer's
# fp32 scores on the einsum path stay within EINSUM_SCORES_BYTES
FP32_COPY_BYTES = 40e9
EINSUM_SCORES_BYTES = 4e9
# the sliding-window ring past its wrap, at full width: gemma2-2b (window
# 4096) with a prompt of 4608 and 16 decode steps into 5120 slots
RING_ARCH, RING_BATCH, RING_PROMPT, RING_MAX_LEN = "gemma2-2b", 2, 4608, 5120
# two engines stay resident when the two largest levels and the working set
# of a prefill fit under this (the card holds 80 GB)
TWO_ENGINES_BYTES = 75e9
# the sim phase: the golden digests' cases (tests/_golden_digest.py), on the
# card's tables; then the sharded control plane on a 64-node fleet, and on a
# 1024-node fleet whose requests are sized for its 64-node cells
SIM_SCENARIOS = ("steady", "diurnal", "node-churn", "straggler-storm",
                 "overload", "flash-crowd")
SIM_HORIZON_S, SIM_SEED, SIM_STANDBY = 6.0, 0, 2
SIM_FLEET = "fleet-64"
SIM_CELLS_FLEET, SIM_CELLS, SIM_CELLS_HORIZON_S = "fleet-1024", 16, 0.05


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


def mixtral_cut_config():
    """mixtral-8x7b at every published width (32 q / 8 kv heads of 128,
    window 4096, 8 experts top-2 of width 14336, vocab 32000), cut in depth
    to ``MIXTRAL_LAYERS`` of its 32 layers: 47.0 GB in bf16 at level 0, 40.1
    GB at level 1 (the whole model is 93.4 GB, its level 1 79.7 GB)."""
    from repro_torch.configs import get_config

    return get_config(MIXTRAL).scaled(num_layers=MIXTRAL_LAYERS)


CUT_CONFIGS = {JAMBA: jamba_cut_config, DEEPSEEK: deepseek_cut_config,
               MIXTRAL: mixtral_cut_config}


def arch_config(arch: str):
    """The config this script serves for ``arch``: its cut where the whole
    model does not fit the card, else the published one."""
    from repro_torch.configs import get_config

    return CUT_CONFIGS[arch]() if arch in CUT_CONFIGS else get_config(arch)


def reduced_line(arch: str = JAMBA, cut=None) -> str:
    """What the cut of ``arch`` (``cut``, or the one this script serves)
    leaves out, as a ``reduced:`` line."""
    from repro_torch.configs import get_config

    full, cut = get_config(arch), cut or arch_config(arch)
    parts = [f"num_layers {full.num_layers} -> {cut.num_layers}"]
    if full.moe is not None and full.moe.num_experts != cut.moe.num_experts:
        parts.append(f"num_experts {full.moe.num_experts} -> {cut.moe.num_experts}")
    return "reduced: " + ", ".join(parts)


def serve_max_len(cfg, prompt_len: int, steps: int) -> int:
    """The decode caches' length: the stub positions, the prompt and the
    steps, rounded up to a multiple of 1024 (1024 for a 512-token prompt;
    llava-next's 2880 patch positions make it 4096)."""
    n = cfg.stub_embed_len + prompt_len + steps
    return -(-n // 1024) * 1024


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
    for mod in ROUTED.values():
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


# the route every K1 launch of a bf16 run must take, by head dim: a table of
# its own, so that a wrong change to the kernel's ``route`` fails the traces
K1_ROUTE_BY_HEAD_DIM = {64: "wgmma", 128: "wgmma", 256: "wgmma"}


def k1_route(cfg) -> str:
    """The route every K1 launch of a bf16 run of ``cfg`` must take:
    ``wgmma`` at head dims 64, 128 and 256 (gemma2-2b)."""
    return K1_ROUTE_BY_HEAD_DIM[cfg.head_dim]


def assert_k1_route(where, n, cfg):
    """Every one of the ``n`` K1 launches counted since the last reset went
    through :func:`k1_route` of ``cfg``."""
    _assert_route(fa_k, K1_ROUTES, "K1", where, n, k1_route(cfg))


def assert_k3_tma(where, n):
    """Every one of the ``n`` K3 launches counted since the last reset went
    through the ``tma`` route."""
    _assert_route(ssm_k, K3_ROUTES, "K3", where, n, "tma")


# the route every K5 launch of a bf16 run must take, by head dim
K5_ROUTE_BY_HEAD_DIM = {64: "wgmma", 128: "wgmma", 256: "wgmma"}


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


def complete_capture(rows, iters: int) -> bool:
    """Whether a profile of ``iters`` identical calls holds every launch:
    at least one kernel, and each kernel seen a whole number of times a
    call. CUPTI drops records now and then (an empty profile, or one kernel
    seen once in 7 calls), and such a profile reads far low."""
    return bool(rows) and all(count % iters == 0 for _, count, _ in rows)


def device_ms(fn, iters: int = 15, tries: int = 3, label: str = ""):
    """Device time of one call: the kernels' own time under
    ``torch.profiler``, summed over every kernel the call launches, with L2
    flushed before each call (by a ``bitwise_not_`` over 256 MB, whose
    kernel is left out). Returns (ms a call, kernels a call). A profile that
    lost launches (:func:`complete_capture`) is taken again, up to
    ``tries`` times; if every one did, the time is taken with CUDA events
    around each call instead (the device's time from the flush's end to the
    call's last kernel, gaps included) and the kernels a call are None.
    With a ``label``, each kernel's time is printed."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        rows = [r for r in _profile_rows(prof) if "bitwise_not" not in r[2]]
        if complete_capture(rows, iters):
            for dev_us, count, key in rows if label else ():
                print(f"    {label}: {dev_us / 1e3 / iters:.4f} ms a call, "
                      f"{count / iters:g} a call: {key[:100]}")
            return sum(r[0] for r in rows) / 1e3 / iters, sum(r[1] for r in rows) / iters
        seen.append(sum(r[1] for r in rows))
    times = []
    for _ in range(iters):
        flush.bitwise_not_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    ms = statistics.median(times)
    print(f"    {label or 'device_ms'}: the profiler lost launches in {tries} tries "
          f"(kernels seen in {iters} calls: {seen}); CUDA events instead: {ms:.4f} ms a call")
    return ms, None


def _per_call(kernels):
    """How :func:`device_ms`'s kernels a call read in a line."""
    return "CUDA events" if kernels is None else f"{kernels:g} kernels a call"


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


# K1's bf16 D 256 cases (the wgmma route): name, then b, h, kv, sq, s, d,
# window, softcap, q_offset, causal
D256_FLASH_CASES = (
    ("ragged sq77 s77 g2", (2, 4, 2, 77, 77, 256, None, 0.0, 0, True)),
    ("ragged sq200 s200 window64 g1", (1, 4, 4, 200, 200, 256, 64, 0.0, 0, True)),
    ("sq333 g8 softcap50", (1, 16, 2, 333, 333, 256, None, 50.0, 0, True)),
    ("window64 q_offset100 g2", (2, 4, 2, 90, 190, 256, 64, 0.0, 100, True)),
    ("blind rows window32 g2", (2, 4, 2, 64, 200, 256, 32, 0.0, 220, True)),
    ("blind rows only softcap30 g8", (1, 16, 2, 128, 300, 256, 64, 30.0, 400, True)),
    ("non-causal sq100 s300 g2", (1, 4, 2, 100, 300, 256, None, 0.0, 0, False)),
    ("non-causal sq300 s77 g1", (1, 4, 4, 300, 77, 256, None, 0.0, 0, False)),
    ("softcap30 g2", (2, 8, 4, 256, 256, 256, None, 30.0, 0, True)),
    ("s1 g2", (2, 8, 4, 1, 1, 256, None, 0.0, 0, True)),
    ("served gemma2-2b softcap50", (8, 8, 4, 512, 512, 256, None, 50.0, 0, True)),
)


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
        # the wgmma route at D 256 (gemma2's head dim; 256-thread blocks that
        # issue their own copies, 80-row K/V stages): ragged Sq and S, G 1 / 2
        # / 8, window with q_offset, rows that see no column, non-causal with
        # Sq != S, soft caps 50 and 30, S 1, gemma2-2b's served shape, each on
        # the model's strided views and contiguous
        *[(f"wgmma d256 {tag}{suffix}", bf, *shape)
          for tag, shape in D256_FLASH_CASES for suffix in ("", " contiguous")],
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
        if name.startswith("wgmma d256"):           # every operand read in place
            assert all(fa_k._aligned_view(x) is x for x in (q, k, v)), name
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
    ] + tensor_core_decode_cases()


def tensor_core_decode_cases():
    """The bf16 (tensor-core) instance at G 1, 2, 3, 4, 5 and 8 and D 64,
    128 and 256, over 777 slots (not a multiple of the 64-row stage): by G,
    a prefix mask with an all-masked row (G 1, 4), a scattered mask (G 2,
    5), a prefix mask past one stage (G 3, 8); soft cap 50 at G 2 and 8;
    splits 1..8 in turn."""
    cases = []
    for d in (64, 128, 256):
        for i, g in enumerate((1, 2, 3, 4, 5, 8)):
            lengths = {1: [0, 777 - 13 * g], 4: [0, 777 - 13 * g], 2: None, 5: None,
                       3: [1 + 50 * g, 777], 8: [1 + 50 * g, 777]}[g]
            cap = 50.0 if g in (2, 8) else 0.0
            splits = 1 + (3 * i + d // 64) % 8
            cases.append((f"tc d{d} g{g} splits {splits}" + (" cap50" if cap else ""),
                          torch.bfloat16, 2, 2, g, 777, d, cap, lengths, splits))
    return cases


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
        print(f"  decode {name:31s} {dec_k.route(dt)} out err {e1:.3e}  m err {e2:.3e}  "
              f"l err {e3:.3e}")
        empty = ~mask.any(dim=1)
        if empty.any():                     # what the TPU kernel gives there
            assert (m[empty] == dec_k.NEG_INF).all() and (l[empty] == s).all(), name
            _check(f"decode[{name}] mean of V", out[empty],
                   v.float().mean(dim=1)[empty][:, :, None, :].expand(-1, -1, g, -1),
                   TOL[dt])

    # masked slots holding NaN (a cache's unwritten slots may hold anything):
    # neither the TMA path (a prefix mask, whose last box runs past the share)
    # nor the per-row path (a scattered mask) lets them into the output
    for masks in ("prefix", "scattered"):
        for d in (64, 128, 256):
            q = _rand(gen, (2, 2, 8, d), torch.bfloat16, device)
            k, v = (_rand(gen, (2, 300, 2, d), torch.bfloat16, device) for _ in range(2))
            mask = (_prefix_mask([77, 250], 300, device) if masks == "prefix"
                    else torch.rand((2, 300), generator=gen, device=device) < 0.3)
            bad = (~mask)[:, :, None, None].expand_as(k)
            want = dec_k.decode_attention_plain(q, k, v, mask)
            got = dec_k.decode_attention(q, k.masked_fill(bad, float("nan")),
                                         v.masked_fill(bad, float("nan")), mask)
            e1 = _check(f"decode[NaN in masked slots, {masks}, d{d}]", got, want, TOL[torch.bfloat16])
            print(f"  decode NaN in masked slots, {masks} mask, d{d}: out err {e1:.3e}")

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
    lib = _sdpa_decode(q, k, v, mask)
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
    served = [_time_decode(gen, device, timer, *shape) for shape in DECODE_SERVED_SHAPES]
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
        "served_shapes": served,
    }


# K2 at the other served shapes over 1024 slots, prompt + 8 valid a row:
# (label, kv heads, G, D, soft cap)
DECODE_SERVED_SHAPES = (("qwen3-32b G 8", 8, 8, 128, 0.0), ("musicgen D 64 G 1", 24, 1, 64, 0.0),
                        ("gemma2-2b D 256 G 2 cap 50", 4, 2, 256, 50.0))


def _decode_bound(b, kv, g, d, n_valid_total, s, es=2):
    """(bound ms, bound_by): the valid slots' K and V, q and out, the mask;
    4 G D FLOPs a valid slot and kv head."""
    nbytes = 2 * n_valid_total * kv * d * es + 2 * b * kv * g * d * es + b * s
    t_b = nbytes / HBM_BW * 1e3
    t_f = 4 * g * d * kv * n_valid_total / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def _sdpa_decode(q, k, v, mask):
    """The SDPA call that computes K2's function (no soft cap), q (B, KV, G,
    D) and the (B, S, KV, D) caches as they lie, the mask as ``attn_mask``."""
    b, kv, g, d = q.shape
    ql = q.reshape(b, kv * g, 1, d)
    kl, vl = k.transpose(1, 2), v.transpose(1, 2)
    am = mask[:, None, None, :]
    try:
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am,  # noqa: E731
                                                      enable_gqa=True)
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(g, dim=1) for t in (kl, vl))
        return lambda: F.scaled_dot_product_attention(ql, ke, ve, attn_mask=am)  # noqa: E731


def _time_decode(gen, device, timer, label, kv, g, d, cap):
    """K2 (bf16) at a served shape over ``MAX_LEN`` slots, ``PROMPT + 8``
    valid a row, against its plain version, timed beside SDPA with
    ``attn_mask`` (without the soft cap) and the bound."""
    dt = torch.bfloat16
    q = _rand(gen, (B, kv, g, d), dt, device)
    k = _rand(gen, (B, MAX_LEN, kv, d), dt, device)
    v = _rand(gen, (B, MAX_LEN, kv, d), dt, device)
    mask = _prefix_mask([PROMPT + 8] * B, MAX_LEN, device)
    fn = lambda: dec_k.decode_attention(q, k, v, mask, softcap=cap)  # noqa: E731
    err = _check(f"decode[{label}]", fn(), dec_k.decode_attention_plain(q, k, v, mask,
                                                                        softcap=cap), TOL[dt])
    ms = timer(fn)
    library_ms = timer(_sdpa_decode(q, k, v, mask))
    bound, by = _decode_bound(B, kv, g, d, B * (PROMPT + 8), MAX_LEN)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = dec_k.num_splits(B, kv, MAX_LEN, sms)
    print(f"  decode[{label}] q({B},{kv},{g},{d}) over {MAX_LEN} slots, {PROMPT + 8} valid: "
          f"{ms:.4f} ms, SDPA (attn_mask, no cap) {library_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}); splits {splits}, route {dec_k.route(dt)}, err {err:.3e}")
    return {"shape": f"q({B},{kv},{g},{d}) kv({B},{MAX_LEN},{kv},{d}) bf16 cap {cap:g}, "
                     f"{PROMPT + 8} valid slots ({label})",
            "ms": ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err, "splits": splits}


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
        # the wgmma route at D 256 (gemma2-2b's head dim): soft cap 50, window
        # 64 with ragged S, G 1 / 2 / 8, window with q_offset, rows that see no
        # column, non-causal, contiguous tensors, a batch of one whose dout has
        # a batch stride of 1 element (as autograd hands it over)
        ("wgmma d256 window64 ragged s200 g2", bf, 1, 8, 4, 200, 200, 256, 64, 0.0, 0, True),
        ("wgmma d256 softcap50 g1", bf, 2, 4, 4, 192, 192, 256, None, 50.0, 0, True),
        ("wgmma d256 window64 softcap50 g8", bf, 1, 16, 2, 256, 256, 256, 64, 50.0, 0, True),
        ("wgmma d256 window70 q_offset100 g2", bf, 2, 4, 2, 90, 190, 256, 70, 0.0, 100, True),
        ("wgmma d256 blind rows g2", bf, 2, 4, 2, 64, 200, 256, 32, 0.0, 220, True),
        ("wgmma d256 non-causal sq100 s300 g2", bf, 1, 4, 2, 100, 300, 256, None, 0.0, 0, False),
        ("wgmma d256 softcap50 g2 contiguous", bf, 1, 8, 4, 256, 256, 256, None, 50.0, 0, True),
        ("wgmma d256 softcap50 g2 s333 odd dout stride", bf, 1, 8, 4, 333, 333, 256, None, 50.0,
         0, True),
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
        if name.endswith("odd dout stride"):     # a dim of size 1: its stride addresses nothing
            dout = ins[3]
            ins = ins[:3] + (dout.as_strided(dout.shape, (1,) + dout.stride()[1:]),) + ins[4:]
        rt = fab_k.route(dt, d)
        assert name.startswith("wgmma") <= (rt == "wgmma"), (name, rt)
        before, copied = fab_k.launches_by_route[rt], fab_k.copied_bytes
        got = fab_k.flash_attention_bwd(*ins, **kw)
        torch.cuda.synchronize()
        assert fab_k.launches_by_route[rt] == before + 1, (name, rt)
        assert fab_k.copied_bytes == copied, name       # every operand read in place
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
    print(f"  flash_bwd[timed]: the design's 7 products at 989 TFLOP/s "
          f"{design_flops / PEAK_FLOPS[dt] * 1e3:.4f} ms")
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
    """One request trace of ``cfg`` through ``launch.serve``'s entry points
    at full width (the main phase's four, the archs phase's four). Every
    kernel's launch count is set to 0 just before it and read just after,
    and held against the layers of the levels that ran; every K1 launch
    must have taken ``cfg``'s route (:func:`k1_route`). Returns (report,
    counts)."""
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
        assert_k1_route(cfg.name, counts["flash_attention"], cfg)
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
    diff, scale = prefill_on_off(device, cfg, params, toks)
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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def moe_prefill_on_off(device, eng, toks):
    """Printed, not held: ``eng``'s bf16 prefill logits with the kernels on
    and off, and the share of tokens whose expert pair at the first MoE
    layer differs between the two paths (in bf16 a top-2 choice near a tie
    flips on a last-bit difference upstream). As a witness of what those
    flips carry, the kernels-on prefill again with every MoE layer's
    experts pinned to the kernels-off path's choice (the gates taken from
    the kernels-on router's probabilities at those experts). Returns (max
    abs difference, max |logit|, flipped share, max abs difference pinned)."""
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod

    route = moe_mod.route_topk
    chosen, path = {}, [None]   # path -> every MoE layer's experts, in call order

    def hooked(c, router_logits):
        gates, idx = route(c, router_logits)
        if path[0] == "pinned":
            idx = chosen["off"][len(chosen.get("pinned", ()))]
            probs = torch.softmax(router_logits.float(), dim=-1).gather(-1, idx)
            gates = probs / probs.sum(dim=-1, keepdim=True) * c.moe.router_scale
        chosen.setdefault(path[0], []).append(idx)
        return gates, idx

    logits = {}
    moe_mod.route_topk = hooked
    try:
        for p in ("off", "on", "pinned"):
            path[0] = p
            logits[p] = serve.Engine(eng.cfg, eng.params,
                                     serve.EngineConfig(max_len=eng.ecfg.max_len,
                                                        use_kernels=p != "off"),
                                     device=device).prefill(toks)[0]
    finally:
        moe_mod.route_topk = route
    _sync(device)
    assert all(torch.isfinite(x).all() for x in logits.values())
    assert len(chosen["pinned"]) == len(chosen["off"]) == len(chosen["on"]) > 0, {
        p: len(v) for p, v in chosen.items()}
    diff = (logits["on"] - logits["off"]).abs().max().item()
    pinned = (logits["pinned"] - logits["off"]).abs().max().item()
    scale = logits["off"].abs().max().item()
    first = [chosen[p][0].sort(dim=-1).values for p in ("on", "off")]
    flipped = (first[0] != first[1]).any(dim=-1).float().mean().item()
    print(f"{eng.cfg.name}: bf16 prefill logits kernels vs einsum path, level 0: max abs "
          f"diff {diff:.6f} (max |logit| {scale:.3f}); expert pair differs at the first "
          f"MoE layer for {flipped:.4%} of {first[0].shape[0]} tokens; with the kernels-on "
          f"path's experts pinned to the einsum path's at all {len(chosen['off'])} MoE "
          f"layers: max abs diff {pinned:.6f} (printed, not held)")
    return diff, scale, flipped, pinned


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
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16", max_len=MAX_LEN,
                           seed=args.seed, max_engines=1).engine_for(0)
    toks = serve.make_prompts(eng.cfg.vocab_size, B, PROMPT, seed=args.seed, device=device)
    moe_prefill_on_off(device, eng, toks)

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
    """The main phase's four traces, one after the other: phi4-mini-3.8b,
    rwkv6-1.6b, the cut jamba and the cut deepseek (the archs phase serves
    the other six). Returns the launch counts of each kernel, read right
    after each trace."""
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


# ----------------------------------------------------------------------
# the archs phase: the six archs that had run only as dry-run steps, served
def reckon_fit(device, cfg, max_len, max_engines):
    """Before a trace: ``launch.dryrun.reckon_footprint`` of its largest
    level, kernels on, for a prefill (batch B x the stub positions and the
    prompt) and for a decode step (B x ``max_len`` slots), the larger of the
    two, plus the parameters of the other levels the trace keeps resident
    (the ``max_engines`` largest; all six without a bound); printed and held
    against the card's free memory. Nothing catches an out-of-memory error,
    so a trace that would not fit fails here, before it builds anything.
    Returns the reckoned bytes."""
    from repro_torch.core.variants import VariantPool
    from repro_torch.launch import dryrun as dr

    levels = sorted((v.config for v in VariantPool(cfg).variants), key=param_bytes,
                    reverse=True)
    others = sum(param_bytes(c) for c in levels[1:max_engines or len(levels)])
    step = {kind: dr.reckon_footprint(levels[0], kind, B, seq, kernels=True)
            for kind, seq in (("prefill", cfg.stub_embed_len + PROMPT), ("decode", max_len))}
    total = max(step.values()) + others
    free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else None
    print(f"{cfg.name}: parameters by level "
          + ", ".join(f"{param_bytes(v.config) / 1e9:.1f}" for v in VariantPool(cfg).variants)
          + f" GB in bf16; max_engines={max_engines}; reckoned (launch.dryrun."
          f"reckon_footprint, the largest level, kernels on): prefill {step['prefill'] / 1e9:.1f}"
          f" GB, decode over {max_len} slots {step['decode'] / 1e9:.1f} GB; + the other "
          f"resident levels' parameters {others / 1e9:.1f} GB = {total / 1e9:.1f} GB"
          + ("" if free is None else f" of {free / 1e9:.1f} GB free"))
    assert free is None or total <= free, f"{cfg.name}: {total} bytes reckoned, {free} free"
    return total


def arch_inputs(cfg, level, seed, device, batch=B, prompt_len=PROMPT):
    """One engine batch of a level: ``batch`` prompts of ``prompt_len``
    tokens from ``serve.make_prompts``, and for a stub-frontend arch its
    precomputed embeddings ``(batch, stub_embed_len, d_model)``, drawn in
    bf16 from a generator seeded with ``seed`` and the level (None
    otherwise)."""
    from repro_torch.launch import serve

    toks = serve.make_prompts(cfg.vocab_size, batch, prompt_len, seed=seed + level,
                              device=device)
    if not cfg.frontend_stub:
        return toks, None
    gen = torch.Generator(device=device).manual_seed(1000 * seed + level)
    return toks, torch.randn((batch, cfg.stub_embed_len, cfg.d_model), generator=gen,
                             device=device, dtype=torch.bfloat16)


def prefill_on_off(device, cfg, params, toks, embeds=None, max_len=MAX_LEN):
    """Prefill logits of ``cfg`` / ``params`` through the engine with
    ``use_kernels`` on and off. Returns (max abs difference, max |logit| of
    the kernels-off path)."""
    from repro_torch.launch import serve

    logits = [serve.Engine(cfg, params, serve.EngineConfig(max_len=max_len, use_kernels=on),
                           device=device).prefill(toks, embeds)[0]
              for on in (True, False)]
    _sync(device)
    assert logits[0].shape == (toks.shape[0], cfg.vocab_size)
    assert all(torch.isfinite(x).all() for x in logits)
    return (logits[0] - logits[1]).abs().max().item(), logits[1].abs().max().item()


def leading_fp32(cfg, params, budget=FP32_COPY_BYTES):
    """fp32 copies of the embedding, the final norm and as many leading
    layer units of ``params`` (a model of ``cfg`` with one stacked group) as
    stay within ``budget`` bytes together; a gemma2 unit is its local and
    global pair. ``params`` is emptied as the copies are made, leaf by leaf,
    so that the bf16 model and its fp32 copy are never both whole on the
    card. Returns (the fp32 config of those units, their parameters, units
    copied, units in the model)."""
    from repro_torch.models import transformer as tfm

    (g,) = tfm.layer_plan(cfg)

    def numel(t):
        return sum(numel(v) for v in t.values()) if isinstance(t, dict) else t.numel()

    per_unit = 4 * numel(params[g.name]) // g.n_units
    rest = 4 * sum(numel(v) for k, v in params.items() if k != g.name)
    n = min(g.n_units, int((budget - rest) // per_unit))
    assert n >= 1, f"{cfg.name}: not one layer unit fits {budget} bytes in fp32"

    def take(tree, stacked):
        out = {}
        for k in list(tree):
            v = tree.pop(k)
            out[k] = take(v, stacked) if isinstance(v, dict) else (
                v[:n] if stacked else v).float()
        return out

    p32 = {k: take(params[k], k == g.name) if isinstance(params[k], dict)
           else params.pop(k).float() for k in list(params)}
    params.clear()
    cfg32 = cfg.scaled(num_layers=n * len(g.pattern), dtype="float32")
    assert [(x.name, x.n_units) for x in tfm.layer_plan(cfg32)] == [(g.name, n)]
    return cfg32, p32, n, g.n_units


def first_attention_fp32(device, eng, toks):
    """A MoE model's first attention layer at full width on fp32 copies of
    its leaves and the real hidden state that reaches it, with the kernel on
    and off. Returns (max abs difference, max |output| of the kernels-off
    path)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens, resolve_dtype

    cfg = eng.cfg
    g = tfm.layer_plan(cfg)[0]
    i = next(k for k, sl in enumerate(g.pattern) if sl.mixer == "gqa")
    sub = eng.params[g.name][f"sub{i}"]
    p32 = {k: v[0].float() for k, v in sub["attn"].items()}
    cfg32 = cfg.scaled(dtype="float32")
    with torch.inference_mode():
        x = embed_tokens(cfg, eng.params["embed"], toks, resolve_dtype(cfg.dtype))
        h = tfm._norm(cfg, sub["norm_mixer"][0], x).float()
        pos = torch.arange(h.shape[1], device=h.device)[None]
        outs = [attn.gqa_attention_dense(cfg32, p32, h, pos, is_global=g.pattern[i].is_global,
                                         use_kernel=on)[0] for on in (True, False)]
    _sync(device)
    assert all(torch.isfinite(o).all() for o in outs)
    diff, scale = (outs[0] - outs[1]).abs().max().item(), outs[1].abs().max().item()
    nbytes = sum(v.numel() * 4 for v in p32.values())
    print(f"{cfg.name}: fp32 copies of layer {i}'s attention ({nbytes / 1e9:.2f} GB, window "
          f"{attn.layer_window(cfg, g.pattern[i].is_global)}), kernel on / off: output max "
          f"abs diff {diff:.3e} (max |out| {scale:.3f})")
    return diff, scale


def arch_checks(device, args, cfg, max_len=MAX_LEN, budget=FP32_COPY_BYTES,
                batch=B, prompt_len=PROMPT):
    """Kernels on against off for one model of the archs phase, on its
    level-0 engine rebuilt from its seed (the trace's pool is freed first:
    two copies of qwen3-32b do not fit).

    * Printed: the whole bf16 model's prefill logits (a MoE model: and the
      share of tokens whose expert pair flips at its first MoE layer, and
      the logits with the experts pinned, :func:`moe_prefill_on_off`).
    * Held to LOGITS_TOL_FP32 relative to the largest value above 1 (in
      fp32, K1 runs its ``fma`` route and K2 its fp32 instance; the bf16
      routes' calls are held by the phase's replay): a dense
      model's prefill logits on fp32 copies of as many leading layer units as
      stay within ``budget`` bytes (:func:`leading_fp32`; the whole of
      gemma2-2b, llava-next and musicgen), at a batch cut so that one layer's
      fp32 scores on the einsum path stay within EINSUM_SCORES_BYTES; a MoE
      model's first attention layer (:func:`first_attention_fp32`). Only
      prefill is held for a MoE model: the capacity rule drops tokens by
      sequence length, so its decode logits need not equal the forward's.

    Returns the figures."""
    from repro_torch.launch import serve
    from repro_torch.train import optimizer as opt_lib

    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16", max_len=max_len,
                           seed=args.seed, max_engines=1).engine_for(0)
    toks, embeds = arch_inputs(eng.cfg, 0, args.seed, device, batch, prompt_len)
    out = {}
    if cfg.moe is not None:
        assert embeds is None
        (out["bf16_diff"], out["bf16_scale"], out["flipped"],
         out["bf16_diff_pinned"]) = moe_prefill_on_off(device, eng, toks)
        out["fp32_diff"], out["fp32_scale"] = first_attention_fp32(device, eng, toks)
        held = "first attention layer's output"
        del eng
    else:
        out["bf16_diff"], out["bf16_scale"] = prefill_on_off(
            device, eng.cfg, eng.params, toks, embeds, max_len)
        print(f"{cfg.name}: bf16 prefill logits kernels vs einsum path, level 0, the whole "
              f"model: max abs diff {out['bf16_diff']:.6f} (max |logit| "
              f"{out['bf16_scale']:.3f}) (printed, not held)")
        cfg32, p32, n, units = leading_fp32(eng.cfg, eng.params, budget)
        del eng
        _free()
        seq = cfg.stub_embed_len + prompt_len
        b = max(1, min(batch, int(EINSUM_SCORES_BYTES // (cfg.num_heads * seq * seq * 4))))
        out["fp32_units"], out["fp32_batch"] = n, b
        out["fp32_diff"], out["fp32_scale"] = prefill_on_off(
            device, cfg32, p32, toks[:b], None if embeds is None else embeds[:b], max_len)
        nbytes = sum(t.numel() * 4 for t in opt_lib._leaves(p32))
        held = "prefill logits"
        print(f"{cfg.name}: fp32 copies of {n} of {units} layer units ({cfg32.num_layers} "
              f"layers, {nbytes / 1e9:.2f} GB), batch {b} x {seq}, kernels on / off: "
              f"prefill logits max abs diff {out['fp32_diff']:.3e} (max |logit| "
              f"{out['fp32_scale']:.3f})")
        del p32
    tol = LOGITS_TOL_FP32 * max(1.0, out["fp32_scale"])
    assert out["fp32_diff"] <= tol, (
        f"{cfg.name}: {held}, kernels on/off in fp32: {out['fp32_diff']} > {tol}")
    _free()
    return out


def stub_trace(device, args, cfg, batch=B, prompt_len=PROMPT, calls=None):
    """A stub-frontend arch (llava-next, musicgen) through
    ``EnginePool(...).engine_for(level).generate(tokens, steps, embeds=...)``
    at each of the six levels of ``VariantPool(cfg)``, one engine resident
    at a time, with precomputed frontend embeddings (:func:`arch_inputs`)
    ahead of the prompt. These two do not go through the gateway: neither
    package's ``serve`` passes frontend embeddings (its shares call
    ``Engine.generate(tokens, ...)``), so a trace would stop at the model's
    "needs stub frontend embeddings". Each level's tokens, logits and
    launches are held as ``run_trace`` holds a share's; the prefill counts
    the stub positions. The kernel calls are counted at the kernel entries
    (``recording_calls``; the CPU runs the plain versions, which launch
    nothing) and on the card by the kernels' own counts too, which must
    agree; the recorded calls are added to ``calls`` (a Counter) where one
    is given. Returns the counts."""
    from repro_torch.launch import serve

    steps = args.decode_steps
    pool = serve.EnginePool(cfg, device=device, dtype="bfloat16",
                            max_len=serve_max_len(cfg, prompt_len, steps), seed=args.seed,
                            max_engines=1)
    cuda = device.type == "cuda"
    want, rows, mine = dict.fromkeys(KERNELS, 0), [], collections.Counter()
    reset_counts()
    t0 = time.time()
    with recording_calls(mine):
        for level in range(len(pool.pool)):
            eng = pool.engine_for(level)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            toks, embeds = arch_inputs(eng.cfg, level, args.seed, device, batch, prompt_len)
            out = eng.generate(toks, num_steps=steps, embeds=embeds)
            st = eng.last_stats
            assert out.shape == (batch, steps), out.shape
            assert out.min() >= 0 and out.max() < cfg.vocab_size
            assert st["finite"], f"{cfg.name}: non-finite logits at level {level}"
            for k, n in _launches_per_run(eng.cfg, steps).items():
                want[k] += n
            rows.append((level, st["prefill_ms"], st["decode_ms_per_step"],
                         torch.cuda.max_memory_allocated() if cuda else 0))
            del eng
    _sync(device)
    wall = time.time() - t0
    called = dict.fromkeys(KERNELS, 0)
    for (name, _, _), n in mine.items():
        called[name.replace("_model", "")] += n
    if calls is not None:
        calls.update(mine)
    assert called == want, f"{cfg.name}: kernel calls {called} != layers x prefills / steps {want}"
    counts = called
    if cuda:
        counts = {name: mod.launches for name, mod in KERNELS.items()}
        assert counts == want, f"{cfg.name}: launches {counts} != kernel calls {want}"
        assert_k1_route(cfg.name, counts["flash_attention"], cfg)
    seq = cfg.stub_embed_len + prompt_len
    print(f"{cfg.name}: {len(rows)} levels through the engine with stub embeddings "
          f"(batch {batch} x {seq} = {cfg.stub_embed_len} stub + {prompt_len} tokens, "
          f"{steps} steps), {pool.builds} engine builds, launches {counts}, wall {wall:.1f} s")
    for level, pre, dec, peak in rows:
        print(f"{cfg.name}: level {level}: prefill {pre:.2f} ms, {dec:.3f} ms per decode "
              f"step, {batch * 1e3 / dec:.1f} tokens/s decode, peak memory {peak / 1e9:.2f} GB")
    del pool
    _free()
    return counts


def _ring_run(device, cfg, params, toks, steps, max_len, on, fed, held=None):
    """Prefill and ``steps`` decode steps of ``cfg`` through the engine,
    kernels ``on`` or off; each step is fed ``fed[i]``, or this path's own
    greedy token where ``fed`` is None. With ``held`` (a dict), every K1 and
    K2 call is held against its plain version on the same inputs
    (:func:`holding_calls`). Returns the logits of the prefill and of every
    step."""
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import resolve_dtype

    eng = serve.Engine(cfg, params, serve.EngineConfig(max_len=max_len, use_kernels=on),
                       device=device)
    reset_counts()
    with holding_calls(held) if held is not None else contextlib.nullcontext():
        lg, caches, lengths = eng.prefill(toks)
        slots = (caches["layers"]["sub0"].k.shape[2], caches["layers"]["sub1"].k.shape[2])
        assert slots == (min(attn.layer_window(cfg, False), max_len), max_len), slots
        logits = [lg]
        for i in range(steps):
            tok = logits[-1].argmax(-1) if fed is None else fed[i]
            lg, caches, lengths = eng.decode(caches, lengths, tok)
            logits.append(lg)
        _sync(device)
    assert all(torch.isfinite(x).all() for x in logits)
    if on and device.type == "cuda":
        counts = {k: KERNELS[k].launches for k in ("flash_attention", "decode_attention")}
        rt = k1_route(cfg) if resolve_dtype(cfg.dtype) == torch.bfloat16 else "fma"
        assert counts == {"flash_attention": cfg.num_layers,
                          "decode_attention": cfg.num_layers * steps}, counts
        assert fa_k.launches_by_route[rt] == cfg.num_layers, fa_k.launches_by_route
        print(f"{cfg.name} ring, {cfg.dtype}: launches {counts}, K1 on {rt}")
    return logits


def ring_check(device, args, cfg=None, batch=RING_BATCH, prompt_len=RING_PROMPT,
               max_len=RING_MAX_LEN):
    """gemma2-2b's sliding-window ring past its wrap, at full width, on its
    level-0 weights. The prompt is longer than the window (4608 against
    4096), so the prefill rolls the local layers' last 4096 positions by
    4608 % 4096 = 512 and each decode step writes slot ``lengths % 4096`` of
    their ring; the global layers decode into 5120 slots. Both paths are fed
    the kernels-off path's greedy tokens, so that a near-tie cannot send them
    down different sequences.

    * bf16: the prefill (K1 on ``wgmma``, D 256, window 4096 over S 4608,
      soft cap 50) and every decode step (K2 at D 256, G 2, soft cap 50 over
      the 4096-slot ring and 5120 slots). Held: every K1 and K2 call of the
      kernels-on path against its plain version on the same q, caches and
      mask (:func:`holding_calls`). Printed: the logits, kernels on against
      off.
    * fp32 copies, held to LOGITS_TOL_FP32 relative to the largest logit
      above 1 (K1 runs its ``fma`` route there): the prefill logits and every
      step's, kernels on against off; and the last step's logits (kernels
      off) against a prefill of the prompt and the tokens fed, which holds
      the ring itself, whatever the kernels do.

    Returns the figures by dtype."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = cfg or get_config(RING_ARCH)
    steps, w = args.decode_steps, cfg.sliding_window
    assert w < prompt_len and prompt_len + steps <= max_len, (w, prompt_len, max_len)
    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16", max_len=max_len,
                           seed=args.seed, max_engines=1).engine_for(0)
    toks = serve.make_prompts(cfg.vocab_size, batch, prompt_len, seed=args.seed, device=device)
    print(f"{cfg.name} ring: batch {batch}, prompt {prompt_len}, {steps} decode steps, max_len "
          f"{max_len}; local layers' ring {min(w, max_len)} slots, rolled by "
          f"{prompt_len % min(w, max_len)}; global layers {max_len} slots")
    res = {}
    for dtype in ("bfloat16", "float32"):
        if dtype == "bfloat16":
            vcfg, params = eng.cfg, eng.params
        else:
            vcfg, params = eng.cfg.scaled(dtype="float32"), _tree_float(eng.params)
            del eng
            _free()
        off = _ring_run(device, vcfg, params, toks, steps, max_len, False, None)
        fed = [x.argmax(-1) for x in off[:steps]]
        held = {} if dtype == "bfloat16" else None
        on = _ring_run(device, vcfg, params, toks, steps, max_len, True, fed, held)
        if held is not None:
            assert {k: len(v) for k, v in held.items()} == {
                "flash_attention": vcfg.num_layers,
                "decode_attention": vcfg.num_layers * steps}, {k: len(v) for k, v in held.items()}
            for k, v in held.items():
                print(f"{cfg.name} ring, {dtype}: {k} held against its plain version on the "
                      f"same inputs in all {len(v)} calls, max abs err {max(v):.3e} "
                      f"(tolerance {TOL[torch.bfloat16]:g})")
        diffs = [(a - b).abs().max().item() for a, b in zip(on, off)]
        scale = max(x.abs().max().item() for x in off)
        greedy = {p: torch.stack([x.argmax(-1) for x in lg], 1).tolist()
                  for p, lg in (("on", on), ("off", off))}
        first = next((i for i in range(steps + 1)
                      if any(a[i] != b[i] for a, b in zip(greedy["on"], greedy["off"]))), None)
        print(f"{cfg.name} ring, {dtype}, kernels on / off: prefill logits max abs diff "
              f"{diffs[0]:.3e}, decode steps {', '.join(f'{d:.2e}' for d in diffs[1:])} "
              f"(max |logit| {scale:.3f}); greedy tokens of the first row on "
              f"{greedy['on'][0]}, off {greedy['off'][0]}; first step they differ at: "
              f"{'none' if first is None else first}")
        res[dtype] = {"diffs": diffs, "scale": scale, "first_differ": first}
        if held is not None:
            res[dtype]["held"] = {k: (len(v), max(v)) for k, v in held.items()}
        if dtype == "float32":
            tol = LOGITS_TOL_FP32 * max(1.0, scale)
            assert max(diffs) <= tol, f"ring, kernels on/off in fp32: {max(diffs)} > {tol}"
            full = torch.cat([toks, torch.stack(fed, 1)], dim=1)
            whole = serve.Engine(vcfg, params, serve.EngineConfig(max_len=max_len,
                                                                  use_kernels=False),
                                 device=device).prefill(full)[0]
            d = (whole - off[-1]).abs().max().item()
            res[dtype]["decode_vs_prefill"] = d
            print(f"{cfg.name} ring, fp32, kernels off: step {steps}'s logits against a prefill "
                  f"of the prompt and the {steps} tokens fed: max abs diff {d:.3e}")
            assert d <= tol, f"ring decode against prefill in fp32: {d} > {tol}"
        del on, off
        _free()
    del params
    _free()
    return res


def archs_phase(device, args, timer):
    """The six archs that had run only as dry-run steps, served at every
    published width (mixtral cut in depth), bf16, random weights: four
    request traces through ``launch.serve`` (gemma2-2b, gemma2-27b,
    qwen3-32b, the cut mixtral), each reckoned to fit before it runs; then
    llava-next and musicgen through the engine of each level with their stub
    frontends' embeddings; after each model, kernels on against off on its
    level-0 weights (:func:`arch_checks`); then gemma2-2b's sliding-window
    ring past its wrap (:func:`ring_check`). Every kernel call of the traces
    and of the stub-frontend runs is recorded by signature
    (:func:`recording_calls`) and, last, each distinct one is replayed
    against its plain version and timed (:func:`dryrun_replay`). Returns
    (the launch counts of each model's run, read right after it ran; the
    replayed signatures)."""
    t_phase = time.time()
    out, calls = {}, collections.Counter()
    for arch, max_engines in ARCH_TRACES:
        t0 = time.time()
        cfg = arch_config(arch)
        if arch in CUT_CONFIGS:
            print(reduced_line(arch))
        max_len = serve_max_len(cfg, PROMPT, args.decode_steps)
        _free()
        reckon_fit(device, cfg, max_len, max_engines)
        with recording_calls(calls):
            report, out[arch] = run_trace(device, args, cfg, max_engines=max_engines)
        del report
        _free()
        arch_checks(device, args, cfg, max_len)
        print(f"{arch}: trace and checks, wall {time.time() - t0:.1f} s")
    for arch in STUB_ARCHS:
        t0 = time.time()
        cfg = arch_config(arch)
        out[arch] = stub_trace(device, args, cfg, calls=calls)
        arch_checks(device, args, cfg, serve_max_len(cfg, PROMPT, args.decode_steps))
        print(f"{arch}: engine levels and checks, wall {time.time() - t0:.1f} s")
    t0 = time.time()
    ring_check(device, args)
    print(f"{RING_ARCH} ring check: wall {time.time() - t0:.1f} s")
    t0 = time.time()
    print(f"archs: {len(calls)} distinct kernel call signatures in the traces and the "
          f"stub-frontend runs, replayed against the plain versions:")
    replayed = dryrun_replay(device, timer, calls, label="archs")
    print(f"archs: replay wall {time.time() - t0:.1f} s; phase wall "
          f"{time.time() - t_phase:.1f} s")
    return out, replayed


def _probe(params):
    """The first 8 elements of every parameter leaf, to see that a step
    moved them all."""
    from repro_torch.train import optimizer as opt_lib

    return {k: t.reshape(-1)[:8] for k, t in zip(_leaf_keys(params), opt_lib._leaves(params))}


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


def train_config(arch: str):
    """The config the train phase trains for ``arch``: mixtral at every
    published width with all 8 experts, cut to ``MIXTRAL_TRAIN_LAYERS``
    layers; any other arch as published."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.scaled(num_layers=MIXTRAL_TRAIN_LAYERS) if arch == MIXTRAL else cfg


def k5_route(cfg) -> str:
    """The route every K5 launch of a bf16 run of ``cfg`` must take:
    ``wgmma`` at head dims 64, 128 and 256 (gemma2-2b)."""
    return K5_ROUTE_BY_HEAD_DIM[cfg.head_dim]


def assert_k5_route(where, n, cfg):
    """Every one of the ``n`` K5 launches counted since the last reset went
    through :func:`k5_route` of ``cfg``."""
    _assert_route(fab_k, K5_ROUTES, "K5", where, n, k5_route(cfg))


def _kernel_kind(key: str) -> str:
    """A profiled kernel's row in the train phase's breakdown: K1 and K5 by
    route (from the kernel's name), cuBLAS, or other."""
    for tag, kernel in (("flash_fwd", "K1"), ("bwd_dq", "K5"), ("bwd_dkv", "K5")):
        if tag in key:
            rt = "mma" if "_mma_" in key else "wgmma" if "_sm90_" in key else "fma"
            return f"{kernel} {rt}"
    if re.search(GEMM_RE, key, re.I):
        return "matmul (cuBLAS)"
    return "other (ATen elementwise, copies, reductions)"


def reckon_train(device, cfg, batch, seq_len, microbatches):
    """Before a train run: ``launch.dryrun.reckon_footprint`` of its step,
    kernels on (fp32 masters and gradients, bf16 moments, the remat inputs,
    one unit's recompute, one microbatch's logits with their gradient),
    printed and held against the card's free memory, as :func:`reckon_fit`
    holds a trace. Returns the reckoned bytes."""
    from repro_torch.launch import dryrun as dr

    total = dr.reckon_footprint(cfg, "train", batch, seq_len, microbatches=microbatches,
                                kernels=True)
    free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else None
    print(f"train {cfg.name}: {param_bytes(cfg, 1) / 1e9:.2f} B parameters; reckoned "
          f"(launch.dryrun.reckon_footprint, kernels on, {batch} x {seq_len} in "
          f"{microbatches} microbatches) {total / 1e9:.1f} GB"
          + ("" if free is None else f" of {free / 1e9:.1f} GB free"))
    assert free is None or total <= free, f"{cfg.name}: {total} bytes reckoned, {free} free"
    return total


class StepChecks:
    """``run_training``'s ``on_step`` for the train phase. After every step:
    a finite loss and grad norm, every parameter leaf moved, and each
    kernel's launches equal to the step's own count (``expected_launches``:
    K1 twice and K5 once a GQA layer and microbatch, since remat reruns each
    forward). On the card it records a CUDA event after each step and
    profiles the last one. ``hold_first``: every K1 and K5 call of the first
    step is held against its plain version on the same inputs
    (:func:`holding_calls`; the errors land in ``held``)."""

    def __init__(self, cfg, microbatches, steps, device, hold_first=False):
        self.want = expected_launches(cfg, "train", microbatches, 1)
        self.steps, self.cuda = steps, device.type == "cuda"
        self.hold_first, self.held = hold_first, {}
        self.events = []
        self.prev = self.counts = self.prof = self.prof_done = self.prof_wall = None
        self._hold = contextlib.ExitStack()

    def __call__(self, i, state, metrics):
        snap = {k: v.detach().clone() for k, v in _probe(state.params).items()}
        now = {name: mod.launches for name, mod in KERNELS.items()}
        if metrics is not None:
            self._hold.close()                       # the first step's holds end here
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            assert np.isfinite(loss) and np.isfinite(gnorm), (i, loss, gnorm)
            still = [k for k in snap if torch.equal(snap[k], self.prev[k])]
            assert not still, f"step {i}: parameters did not move: {still}"
            delta = {k: now[k] - self.counts[k] for k in now}
            assert delta == self.want, f"step {i}: launches {delta} != {self.want}"
            print(f"  train step {i}: loss {loss:.5f}  grad norm {gnorm:.5f}  "
                  f"launches {delta}")
        elif self.hold_first:
            self._hold.enter_context(holding_calls(self.held))
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            if self.prof is not None:                       # end of the profiled step
                torch.cuda.synchronize()
                self.prof_wall = (time.perf_counter() - self.prof_t0) * 1e3
                self.prof.__exit__(None, None, None)
                self.prof_done, self.prof = self.prof, None
            elif metrics is not None and i == self.steps - 2:   # profile the last step
                from torch.profiler import ProfilerActivity, profile
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.prof_t0 = time.perf_counter()
        self.prev, self.counts = snap, now


def train_run(device, args, cfg, batch, seq_len, microbatches=1, steps=TRAIN_STEPS,
              where="train", calls=None, hold_first=False):
    """``cfg`` trained through ``launch.train.run_training``: fp32 master
    weights, bf16 compute (``cfg.dtype``), remat, ``batch`` x ``seq_len``
    tokens a step from the synthetic stream in ``microbatches``, ``steps``
    steps, every step checked (:class:`StepChecks`). ``calls``: a Counter
    that records every kernel call by signature (:func:`recording_calls`).
    On the card: K1's and K5's routes held to the head dim's, and printed:
    step times, tokens/s, peak memory, the profiled last step's idle share
    and busy time by kind (K1 and K5 by route, cuBLAS, other) and the
    ``train.apply_updates`` span. Returns the run's launch counts and what
    the first step's holds read."""
    from repro_torch.launch import train as train_launch

    reset_counts()
    fab_k.copied_bytes = 0
    if device.type == "cuda":
        _free()
        torch.cuda.reset_peak_memory_stats()
    chk = StepChecks(cfg, microbatches, steps, device, hold_first=hold_first)
    t0 = time.time()
    with recording_calls(calls) if calls is not None else contextlib.nullcontext():
        losses = train_launch.run_training(
            cfg, device=device, steps=steps, global_batch=batch, seq_len=seq_len,
            microbatches=microbatches, seed=args.seed, remat=True, use_kernels=True,
            log_every=1, verbose=True, on_step=chk)
    _sync(device)
    wall = time.time() - t0
    total = {name: mod.launches for name, mod in KERNELS.items()}
    assert len(losses) == steps and total == {k: n * steps for k, n in chk.want.items()}, total
    out = {"counts": total, "held": chk.held}
    for name, errs in sorted(chk.held.items()):
        print(f"train {cfg.name}: the first step's {len(errs)} {name} calls held against "
              f"the plain version on their own inputs: max abs err {max(errs):.3e}")
    if device.type != "cuda":
        return out
    assert_k1_route(where, total["flash_attention"], cfg)
    assert_k5_route(where, total["flash_attention_bwd"], cfg)
    peak = torch.cuda.max_memory_allocated()
    ev = chk.events
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    clean = step_ms[1:-1] or step_ms[-1:]          # neither warm-up nor profiled
    ms = statistics.median(clean)
    print(f"train {cfg.name}: {steps} steps of {batch} x {seq_len} tokens in {microbatches} "
          f"microbatch(es), {cfg.num_layers} layers, bf16 compute, fp32 master, remat; step ms "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} (first: warm-up"
          f"{' and holds' if hold_first else ''}, last: profiled); {ms:.1f} ms a step, "
          f"{batch * seq_len * 1e3 / ms:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB); wall {wall:.1f} s; launches {total}; K5 operand copies "
          f"{fab_k.copied_bytes} bytes")
    assert peak < 80e9, f"peak memory {peak} above the card's 80 GB"
    rows = _profile_rows(chk.prof_done)
    if not rows:
        raise AssertionError(f"the profiler saw no device time in {cfg.name}'s train step")
    busy = sum(r[0] for r in rows) / 1e3
    idle = max(0.0, 1 - busy / chk.prof_wall)
    print(f"profile[train {cfg.name} step {steps - 1}]: wall {chk.prof_wall:.1f} ms (profiler "
          f"on), device busy {busy:.1f} ms, idle share {idle:.3f}")
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    cats = collections.Counter()
    for dev_us, _, key in rows:
        cats[_kernel_kind(key)] += dev_us
    print("  by kind: " + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / 1e3 / busy:.1%})"
                                    for k, v in sorted(cats.items())))
    # the range's own device time is its span on the device timeline, which
    # the optimizer's stream of large elementwise kernels keeps busy
    opt_ms = max([(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))
                  for e in chk.prof_done.key_averages()
                  if e.key == "train.apply_updates"] or [0]) / 1e3
    print(f"  optimizer (span of the range train.apply_updates on the device): "
          f"{opt_ms:.1f} ms; loss, forward and backward: the other "
          f"{busy - opt_ms:.1f} ms of busy time")
    del chk
    _free()
    return out


@contextlib.contextmanager
def pinned_experts(chosen, pin=None):
    """Every MoE top-k choice made inside, recorded in ``chosen`` under
    (layer, pass, n): the layer by the order its router weight is first
    seen, the pass by how many times that layer ran before (under remat the
    backward reruns each layer: pass 0 is the forward, 1 its rerun), n = 0
    for the routing of its tokens and 1 for its load-balance term. With
    ``pin`` (such a record from another run of the same model and batch),
    each choice is replaced by the pinned one, the gates taken from this
    run's router probabilities at the pinned experts, so the capacity drop
    and the load-balance term follow the pin; ``chosen`` still records
    this run's own choices. Put back on exit."""
    from repro_torch.models import moe as moe_mod

    apply, topk = moe_mod.moe_apply, moe_mod._topk
    layers, runs, cur = {}, collections.Counter(), [None, 0]

    def hooked_apply(cfg, p, x):
        layer = layers.setdefault(p["w_router"].data_ptr(), len(layers))
        cur[0], cur[1] = (layer, runs[layer]), 0
        runs[layer] += 1
        return apply(cfg, p, x)

    def hooked_topk(probs, k):
        vals, idx = topk(probs, k)
        key = (*cur[0], cur[1])
        cur[1] += 1
        chosen[key] = idx.detach()
        if pin is not None:
            assert key in pin, f"no pinned choice for MoE call {key}"
            idx = pin[key]
            vals = probs.gather(-1, idx)
        return vals, idx

    moe_mod.moe_apply, moe_mod._topk = hooked_apply, hooked_topk
    try:
        yield chosen
    finally:
        moe_mod.moe_apply, moe_mod._topk = apply, topk


def flipped_share(own, off, key=(0, 0, 0)):
    """The share of tokens whose expert set differs between two records of
    :func:`pinned_experts` at ``key`` (default: the first MoE layer's
    routing in the forward)."""
    a, b = (x[key].sort(dim=-1).values for x in (own, off))
    return (a != b).any(dim=-1).float().mean().item()


def _on_off_grads(cfg, tcfg_kw, params, batch, moe, keep):
    """One ``loss_and_grads`` each with the kernels off and on, from the same
    parameters and batch; a MoE model's kernels-on run has its experts
    pinned to the kernels-off run's choices (:func:`pinned_experts`).
    ``keep(grads)`` picks what is kept of each run's gradients (the rest is
    freed before the next run). Returns ({on: (loss, grad norm, kept)}, the
    share of tokens whose experts the kernels-on router would have chosen
    otherwise at the first MoE layer, None without MoE)."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    out, chosen = {}, {False: {}, True: {}}
    for on in (False, True):
        tcfg = ts.TrainConfig(remat=True, use_kernels=on, **tcfg_kw)
        with (pinned_experts(chosen[on], pin=chosen[False] if on else None) if moe
              else contextlib.nullcontext()):
            loss, _, grads = ts.loss_and_grads(cfg, tcfg, params, batch)
        out[on] = (float(loss), float(opt_lib.global_norm(grads)), keep(grads))
        del grads, loss
        gc.collect()
        if batch["tokens"].device.type == "cuda":
            torch.cuda.empty_cache()
    return out, (flipped_share(chosen[True], chosen[False]) if moe else None)


def _attn_leaves(grads):
    """Every attention leaf's gradient (K5's dq, dk and dv feed wq, wk and
    wv), keyed ``sub/leaf``."""
    return {f"{sub}/{k}": g for sub, p in sorted(grads["layers"].items())
            if "attn" in p for k, g in sorted(p["attn"].items())}


def hold_bf16_first_step(device, args, cfg, tokens, microbatches=1):
    """The first step's loss and gradients at the trained depth in bf16,
    kernels on against off from the run's initial state and batch (a MoE
    model with its experts pinned): the loss to ``TRAIN_LOSS_TOL``, the grad
    norm to ``TRAIN_GNORM_TOL`` relative, and each attention leaf of every
    layer to ``ATTN_GRAD_TOL_BF16`` as |on - off| / |off|. Returns what it
    read."""
    from repro_torch.train import train_step as ts

    params = ts.init_train_state(cfg, ts.TrainConfig(), torch.Generator(
        device=device).manual_seed(args.seed), device=device).params
    got, flipped = _on_off_grads(cfg, {"microbatches": microbatches}, params,
                                 {"tokens": tokens}, cfg.moe is not None, _attn_leaves)
    del params
    (l_off, n_off, a_off), (l_on, n_on, a_on) = got[False], got[True]
    d_loss, d_gnorm = abs(l_on - l_off), abs(n_on - n_off) / n_off
    rel = {k: ((a_on[k] - a_off[k]).norm() / a_off[k].norm().clamp_min(1e-30)).item()
           for k in a_off}
    worst = max(rel, key=rel.get)
    print(f"train {cfg.name} {cfg.dtype} at the trained depth, first step, kernels on / off"
          + (" (experts pinned to the einsum path's)" if flipped is not None else "")
          + f": loss {l_on:.6f} / {l_off:.6f} (diff {d_loss:.2e}), grad norm {n_on:.6f} / "
          f"{n_off:.6f} (rel diff {d_gnorm:.2e}); attention gradients |on - off| / |off|: "
          f"worst {worst} {rel[worst]:.2e} of {len(rel)} leaves"
          + ("" if flipped is None else f"; without the pin the kernels-on router would "
             f"have chosen other experts for {flipped:.4%} of the tokens at the first MoE "
             f"layer (printed, not held)"))
    assert d_loss <= TRAIN_LOSS_TOL, f"loss kernels on/off {d_loss} > {TRAIN_LOSS_TOL}"
    assert d_gnorm <= TRAIN_GNORM_TOL, f"grad norm on/off {d_gnorm} > {TRAIN_GNORM_TOL}"
    for k, r in rel.items():
        if k.rsplit("/", 1)[1] in ("wq", "wk", "wv"):
            assert r <= ATTN_GRAD_TOL_BF16, (
                f"bf16 gradient of {k}, kernels on/off: {r} > {ATTN_GRAD_TOL_BF16}")
    return {"loss": d_loss, "gnorm": d_gnorm, "attn": rel[worst], "flipped": flipped}


def hold_fp32(device, args, cfg, layers, tokens):
    """Every gradient leaf in fp32 copies at full width and ``layers``
    layers, kernels on against off (K1 and K5 on their ``fma`` route; a MoE
    model with its experts pinned), relative to the leaf's largest value, to
    ``GRAD_TOL_FP32``. Returns (worst leaf, its difference, the flipped
    share)."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfg32 = cfg.scaled(num_layers=layers, dtype="float32")
    params = ts.init_train_state(cfg32, ts.TrainConfig(), torch.Generator(
        device=device).manual_seed(args.seed), device=device).params
    got, flipped = _on_off_grads(cfg32, {}, params, {"tokens": tokens}, cfg.moe is not None,
                                 lambda g: g)
    del params
    worst, worst_key = 0.0, None
    for key, (g_on, g_off) in zip(_leaf_keys(got[True][2]), zip(
            opt_lib._leaves(got[True][2]), opt_lib._leaves(got[False][2]))):
        rel = (g_on - g_off).abs().max().item() / max(g_off.abs().max().item(), 1e-30)
        assert rel <= GRAD_TOL_FP32, (f"{cfg.name} fp32 gradient {key}: rel diff {rel} > "
                                      f"{GRAD_TOL_FP32}")
        if rel >= worst:
            worst, worst_key = rel, key
    print(f"train {cfg.name} fp32 copies, full width, {layers} layer(s), "
          f"{tuple(tokens.shape)} tokens, kernels on / off"
          + (" (experts pinned)" if flipped is not None else "")
          + f": loss {got[True][0]:.6f} / {got[False][0]:.6f}; worst gradient leaf "
          f"{worst_key} rel diff {worst:.2e} (limit {GRAD_TOL_FP32})"
          + ("" if flipped is None else f"; flipped without the pin: {flipped:.4%} of "
             f"the tokens at the first MoE layer"))
    del got
    if device.type == "cuda":
        _free()
    return worst_key, worst, flipped


def train_arch(device, args, cfg, batch, seq_len, microbatches, fp32_layers, fp32_batch,
               calls=None):
    """One of ``TRAIN_RUNS``: the cut it trains (a ``reduced:`` line), its
    memory reckoned, the run (:func:`train_run`, every K1 and K5 call of the
    first step held on its own inputs), then kernels on against off: bf16
    at the trained depth (:func:`hold_bf16_first_step`) and fp32 copies of
    ``fp32_layers`` layers on the first ``fp32_batch`` sequences of the
    first batch (:func:`hold_fp32`). Returns the run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device

    if cfg.num_layers != get_config(cfg.name).num_layers:
        print(f"train {cfg.name}: {reduced_line(cfg.name, cfg)}")
    reckon_train(device, cfg, batch, seq_len, microbatches)
    run = train_run(device, args, cfg, batch, seq_len, microbatches,
                    where=f"train {cfg.name}", calls=calls, hold_first=True)
    first = {k: n for k, n in expected_launches(cfg, "train", microbatches, 1).items() if n}
    assert {k: len(v) for k, v in run["held"].items()} == first, (run["held"].keys(), first)
    tokens = to_device(SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                                  global_batch=batch, seed=args.seed))
                       .batch(0), device)["tokens"]
    hold_bf16_first_step(device, args, cfg, tokens, microbatches)
    if device.type == "cuda":
        _free()
    hold_fp32(device, args, cfg, fp32_layers, tokens[:fp32_batch])
    return run["counts"]


def train_phase(device, args, timer):
    """phi4-mini-3.8b, then each of ``TRAIN_RUNS`` (gemma2-2b at full width
    and depth with sequences past its window; mixtral at every width with
    all 8 experts, cut to 2 layers), trained and held (:func:`phi4_train`,
    :func:`train_arch`); last, every bf16 kernel call of the two runs after
    phi4's, recorded by signature, replayed against its plain version and
    timed. Returns (each run's launch counts by path, the replayed rows)."""
    paths = {"train": phi4_train(device, args)}
    calls = collections.Counter()
    for arch, batch, seq_len, micro, fp32_layers, fp32_batch in TRAIN_RUNS:
        paths[f"train {arch}"] = train_arch(device, args, train_config(arch), batch, seq_len,
                                            micro, fp32_layers, fp32_batch, calls=calls)
    print(f"train: {len(calls)} distinct kernel call signatures in the runs of "
          f"{', '.join(a for a, *_ in TRAIN_RUNS)}, replayed against the plain versions:")
    replayed = dryrun_replay(device, timer, calls, label="train")
    return paths, replayed


def phi4_train(device, args):
    """phi4-mini-3.8b trained at full width and depth (:func:`train_run`,
    batch ``TRAIN_BATCH`` x 512, every launch on ``wgmma``), then the
    gradients with the kernels on held against the einsum path: at full
    depth in bf16, the first step's loss, grad norm and attention leaves
    (:func:`hold_bf16_first_step`); ``remat_policy="save_attn"`` against
    ``"nothing"``; leaf by leaf in fp32 copies at full width and 2 layers
    (:func:`hold_fp32`). Returns the launch counts of the training run."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device

    cfg = get_config("phi4-mini-3.8b")
    total = train_run(device, args, cfg, TRAIN_BATCH, PROMPT)["counts"]
    tokens = to_device(SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=PROMPT, global_batch=TRAIN_BATCH,
        seed=args.seed)).batch(0), device)
    hold_bf16_first_step(device, args, cfg, tokens["tokens"])
    _free()
    save_attn_step(device, args, cfg, tokens)
    hold_fp32(device, args, cfg, 2, tokens["tokens"])
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
    (jamba, deepseek, mixtral: of the cut config their traces run; llava-next
    and musicgen: with their stub embeddings ahead of the prompt). Prints
    wall time, the device's busy time and idle share, the kernels that take
    most of the device time and the busy time by kind."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    cfg = arch_config(args.arch)
    if args.arch in CUT_CONFIGS:
        print(reduced_line(args.arch))
    torch.cuda.reset_peak_memory_stats()
    eng = serve.EnginePool(cfg, device=device, dtype="bfloat16",
                           max_len=serve_max_len(cfg, PROMPT, args.decode_steps),
                           seed=args.seed).engine_for(0)
    toks, embeds = arch_inputs(cfg, 0, args.seed, device)
    eng.generate(toks, num_steps=2, embeds=embeds)       # warm-up
    logits, caches, lengths = eng.prefill(toks, embeds)
    state = {"caches": caches, "lengths": lengths, "tok": logits.argmax(-1)}

    def decode4():
        for _ in range(4):
            lg, state["caches"], state["lengths"] = eng.decode(
                state["caches"], state["lengths"], state["tok"])
            state["tok"] = lg.argmax(-1)

    for name, fn in (("prefill", lambda: eng.prefill(toks, embeds)),
                     ("4 decode steps", decode4)):
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


def sim_digest(report) -> str:
    """sha256 over a simulator run's records, log and summary, in the shapes
    of the reference's golden digest (wall-clock, event-count and plan-cache
    counters left out: they are host speed, not serving behaviour)."""
    import hashlib

    records = [
        (int(r.request.rid), repr(r.arrival_s), repr(r.dispatch_s),
         repr(r.finish_s), bool(r.rejected), r.reject_reason,
         bool(r.degraded_admission), int(r.redistributed),
         repr(r.latency_s) if r.done else "",
         bool(r.meets_deadline) if r.done else None)
        for r in report.records]
    summary = sorted(
        (k, repr(v)) for k, v in report.summary().items()
        if k not in ("wall_s", "n_events", "plan_cache_hits", "plan_cache_misses"))
    blob = json.dumps({"records": records, "log": list(report.log),
                       "summary": summary}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _sim_run(scenario, control, cells=0, horizon_s=SIM_HORIZON_S):
    """One simulator run through ``launch.sim.build_sim`` on the card's
    tables (``H100_SXM``). Returns (report, host seconds of build + run)."""
    from repro_torch.launch import sim as launch_sim

    t0 = time.perf_counter()
    sim, _ = launch_sim.build_sim(scenario, "proportional", control, seed=SIM_SEED,
                                  horizon_s=horizon_s, num_standby=SIM_STANDBY,
                                  cells=cells)
    report = sim.run()
    return report, time.perf_counter() - t0


def _sim_line(case, report, wall, card, **extra):
    s = report.summary()
    for k in ("goodput_rps", "p99_latency_s", "shed_rate", "mean_acc"):
        assert np.isfinite(s[k]) and s[k] >= 0, (case, k, s[k])
    assert s["offered"] > 0 and report.n_events > 0, (case, s["offered"])
    row = {"sim": case, "offered": int(s["offered"]), "completed": int(s["completed"]),
           "goodput_rps": s["goodput_rps"], "p99_latency_s": s["p99_latency_s"],
           "shed_rate": s["shed_rate"], "mean_acc": s["mean_acc"],
           "events": report.n_events, "events_per_s": report.n_events / report.wall_s,
           "loop_wall_s": report.wall_s, "host_wall_s": wall, **extra,
           "clock": "host", "card": card}
    print(json.dumps(row))
    return row


def sim_phase(card):
    """The online simulator and the control plane on the card's machine:
    pure host code over analytic ``H100_SXM`` tables, so it launches no
    kernel (asserted). Each digest case runs twice and must give the same
    digest; the sharded control plane at ``cells=1`` must equal the
    unsharded gateway record for record. Times are the host's. Returns the
    launch counts across the phase (all 0)."""
    reset_counts()
    t0 = time.perf_counter()
    print(f"sim: {len(SIM_SCENARIOS)} scenarios x proportional x (none, full), "
          f"horizon {SIM_HORIZON_S} s, seed {SIM_SEED}, {SIM_STANDBY} standby, "
          "tables H100_SXM; host times on the card's machine")
    for scenario in SIM_SCENARIOS:
        for control in ("none", "full"):
            (a, wall), (b, _) = _sim_run(scenario, control), _sim_run(scenario, control)
            digest = sim_digest(a)
            assert digest == sim_digest(b), f"{scenario}/{control}: two runs differ"
            _sim_line(f"{scenario}/proportional/{control}", a, wall, card,
                      digest=digest[:16])
    base, _ = _sim_run(SIM_FLEET, "full")
    one, wall = _sim_run(SIM_FLEET, "full", cells=1)
    assert len(one.records) == len(base.records) > 0
    for x, y in zip(one.records, base.records):
        assert (x.request, x.arrival_s, x.dispatch_s, x.finish_s, x.rejected,
                x.reject_reason, x.degraded_admission, x.redistributed,
                x.dispatch) == (y.request, y.arrival_s, y.dispatch_s, y.finish_s,
                                y.rejected, y.reject_reason, y.degraded_admission,
                                y.redistributed, y.dispatch), x.request.rid
    assert one.log == base.log and sim_digest(one) == sim_digest(base)
    _sim_line(f"{SIM_FLEET}/proportional/full/cells1", one, wall, card,
              equals_unsharded=True)
    # fleet-64 sizes its requests for the whole fleet, so a 16-node cell
    # meets no deadline: these two runs exercise the router and the gate only
    for control in ("none", "full"):
        four, wall = _sim_run(SIM_FLEET, control, cells=4)
        _sim_line(f"{SIM_FLEET}/proportional/{control}/cells4", four, wall, card)
    (a, wall), (b, _) = (_sim_run(SIM_CELLS_FLEET, "full", cells=SIM_CELLS,
                                  horizon_s=SIM_CELLS_HORIZON_S) for _ in range(2))
    case = f"{SIM_CELLS_FLEET}/proportional/full/cells{SIM_CELLS}"
    digest = sim_digest(a)
    assert digest == sim_digest(b), f"{case}: two runs differ"
    met = int(sum(r.meets_deadline for r in a.records))
    assert met > len(a.records) // 2, f"{case}: {met} of {len(a.records)} within deadline"
    _sim_line(case, a, wall, card, digest=digest[:16], within_deadline=met)
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    assert not any(counts.values()), f"the sim phase launched kernels: {counts}"
    print(f"sim: launches {counts}; phase wall {time.perf_counter() - t0:.2f} s (host)")
    return counts


# ----------------------------------------------------------------------
# the dryrun phase: launch.dryrun.run_cell with the kernels on, at full
# published width, on the cells that carry each kernel's new shapes
DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k"), ("phi4-mini-3.8b", "prefill_32k"),
                ("phi4-mini-3.8b", "decode_32k"), ("gemma2-2b", "prefill_32k"),
                ("qwen3-32b", "decode_32k"), ("rwkv6-1.6b", "prefill_32k"),
                ("rwkv6-1.6b", "long_500k"))
# the FLOP check: kernels-off count against kernels-on count plus the
# kernels' analytic FLOPs, on phi4-mini cut to 2 layers. Both counts are
# sums of integer products, so the two sides agree to rounding only.
DRYRUN_FLOPS_TOL = 1e-9


def expected_launches(cfg, kind: str, microbatches: int, steps: int) -> dict:
    """Each kernel's launches in ``steps`` steps of ``kind``: layers x calls.
    Training reruns each attention forward under remat (K1 twice, K5 once a
    layer and microbatch); prefill runs K1, K3 or K4 once a layer; decode
    K2 once an attention layer."""
    from repro_torch.models import transformer as tfm
    n = {m: 0 for m in ("gqa", "mla", "mamba", "rwkv")}
    for g in tfm.layer_plan(cfg):
        for sl in g.pattern:
            n[sl.mixer] += g.n_units
    out = dict.fromkeys(KERNELS, 0)
    if kind == "train":
        out["flash_attention"] = 2 * n["gqa"] * microbatches * steps
        out["flash_attention_bwd"] = n["gqa"] * microbatches * steps
    elif kind == "prefill":
        out["flash_attention"] = n["gqa"] * steps
        out["ssm_scan"] = n["mamba"] * steps
        out["rwkv6_wkv"] = n["rwkv"] * steps
    else:
        out["decode_attention"] = n["gqa"] * steps
    return out


def dryrun_flops_check(device):
    """Counted FLOPs with the kernels off against the count with them on
    plus their analytic FLOPs, on phi4-mini cut to 2 layers at its full
    width: prefill (b 2, S 2048), where the einsum path multiplies the whole
    S x S square (masked) and the kernel its causal half, so the difference
    is twice the flash term; decode (b 8 over 32768 slots, all filled),
    where the einsum path reads every slot as K2 does."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    cfg = dr.reduced_config(get_config("phi4-mini-3.8b"), 2)
    out = {}
    for kind, b, s, factor in (("prefill", 2, 2048, 2.0), ("decode", 8, 32768, 1.0)):
        on = dr.measure(cfg, kind, b, s, use_kernels=True, device=device, timed=False)
        off = dr.measure(cfg, kind, b, s, use_kernels=False, device=device, timed=False)
        kf = dr.kernel_flops(cfg, kind, b, s)
        added = factor * (kf["flash"] + kf["decode"])
        rel = abs(off["flops"] - (on["flops"] + added)) / off["flops"]
        print(f"dryrun flops check, {kind} b {b} S {s}, 2 layers: kernels off "
              f"{off['flops']:.6e}, on {on['flops']:.6e} + {factor:g} x kernels' "
              f"{added / factor:.6e}; relative difference {rel:.2e} (limit "
              f"{DRYRUN_FLOPS_TOL:g})")
        assert rel <= DRYRUN_FLOPS_TOL, (kind, rel)
        out[kind] = rel
    return out


# the kernel entries the model reaches through ``ops``, by module
DRYRUN_ENTRIES = ((fa_k, "flash_attention"), (fab_k, "flash_attention_bwd"),
                  (dec_k, "decode_attention"), (wkv_k, "rwkv6_wkv"),
                  (wkv_k, "rwkv6_wkv_model"), (ssm_k, "ssm_scan"))
# a plain attention call is run in slices whose fp32 score matrix stays
# within this many bytes (the backward holds about six of them at once)
PLAIN_SLICE_BYTES = 1 << 30


def _signature(x):
    """A tensor's shape, strides, dtype and storage offset modulo 256 bytes
    (the alignment of its address: the allocator's blocks start on 256-byte
    boundaries); any other argument itself."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.stride(),
                x.storage_offset() % (256 // x.element_size()), x.dtype)
    return x


@contextlib.contextmanager
def recording_calls(calls):
    """Each entry of ``DRYRUN_ENTRIES`` wrapped to count its call's signature
    in ``calls`` (a Counter) before it calls through; put back on exit. A
    decode step captured into a CUDA graph (``serving/decode_graph.py``)
    calls the entries once, at its capture, and launches nothing then: as
    the launch counters do, ``calls`` follows the graphs' replays
    (``decode_graph.replayed_calls``) for the steps captured inside."""
    from repro_torch.serving import decode_graph as dg
    saved = []
    for mod, name in DRYRUN_ENTRIES:
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls[(_name, tuple(map(_signature, args)),
                   tuple(sorted((k, _signature(v)) for k, v in kw.items())))] += 1
            return _fn(*args, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        with dg.replayed_calls(calls):
            yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def holding_calls(errs):
    """K1's, K2's and K5's entries wrapped to hold each call's output
    against the plain version on the same inputs, at the kernels phase's
    tolerances (K1's and K5's plain versions in slices,
    :func:`_plain_in_slices`; K5's delta from the forward's output where
    the call hands that over); each call's max abs error is appended to
    ``errs[entry]``. The plain versions launch nothing, so the launch counts
    stay the path's own. Put back on exit."""
    flash, decode, bwd = fa_k.flash_attention, dec_k.decode_attention, fab_k.flash_attention_bwd

    def held_flash(q, k, v, **kw):
        got = flash(q, k, v, **kw)
        want = _plain_in_slices(fa_k.flash_attention_plain, (q, k, v), "qkk", **kw)
        errs.setdefault("flash_attention", []).append(max(
            _check(f"held flash {w}", x, y, TOL[q.dtype])
            for w, x, y in zip(("out", "lse"), got if isinstance(got, tuple) else (got,), want)))
        return got

    def held_decode(q, k, v, mask, **kw):
        got = decode(q, k, v, mask, **kw)
        errs.setdefault("decode_attention", []).append(_check(
            "held decode", got, dec_k.decode_attention_plain(q, k, v, mask, **kw), TOL[q.dtype]))
        return got

    def held_bwd(q, k, v, dout, lse, delta=None, **kw):
        # delta passed on as the caller passed it, so a recorder inside sees
        # the caller's signature
        got = bwd(q, k, v, dout, lse, **kw) if delta is None else bwd(q, k, v, dout, lse,
                                                                        delta, **kw)
        out = kw.pop("out", None)
        delta = fab_k.delta_of(dout, out) if delta is None else delta
        want = _plain_in_slices(fab_k.flash_attention_bwd_plain, (q, k, v, dout, lse, delta),
                                "qkkqqq", **kw)
        errs.setdefault("flash_attention_bwd", []).append(max(
            _check(f"held flash_bwd {w}", x, y, BWD_TOL[q.dtype])
            for w, x, y in zip(("dq", "dk", "dv"), got, want)))
        return got

    fa_k.flash_attention, dec_k.decode_attention = held_flash, held_decode
    fab_k.flash_attention_bwd = held_bwd
    try:
        yield errs
    finally:
        fa_k.flash_attention, dec_k.decode_attention = flash, decode
        fab_k.flash_attention_bwd = bwd


def _laid_out(sig, values):
    """``values`` copied into a tensor of the recorded shape, strides,
    storage offset and dtype."""
    _, shape, stride, offset, dtype = sig
    assert all(st or n == 1 for n, st in zip(shape, stride)), f"a broadcast view: {sig}"
    size = offset + 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    t = torch.empty(size, dtype=dtype, device=values.device).as_strided(shape, stride, offset)
    return t.copy_(values)


def _normal(gen, sig, scale=1.0):
    _, shape, _, _, dtype = sig
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return _laid_out(sig, x.to(dtype))


def _plain_in_slices(fn, args, kinds, budget=PLAIN_SLICE_BYTES, **kw):
    """``fn(*args, **kw)``, an attention plain version, run over each batch
    row and over groups of kv heads small enough that a group's fp32 score
    matrix stays within ``budget`` bytes; ``kinds`` says which of
    ``args`` are indexed by query head ("q") and which by kv head ("k").
    The pieces are joined back along both dims."""
    q, k = args[kinds.index("q")], args[kinds.index("k")]
    b, kvh, s = k.shape[0], k.shape[1], k.shape[2]
    g, sq = q.shape[1] // kvh, q.shape[2]
    step = max(1, budget // (g * sq * s * 4))
    rows = []
    for i in range(b):
        parts = []
        for j in range(0, kvh, step):
            hi = min(j + step, kvh)
            sl = {"q": slice(j * g, hi * g), "k": slice(j, hi)}
            part = fn(*(a[i:i + 1, sl[c]] for a, c in zip(args, kinds)), **kw)
            parts.append(part if isinstance(part, tuple) else (part,))
        rows.append([torch.cat(p, dim=1) for p in zip(*parts)])
    return [torch.cat(p, dim=0) for p in zip(*rows)]


def _replay_flash(gen, args, kw):
    q, k, v = (_normal(gen, a) for a in args)
    got = fa_k.flash_attention(q, k, v, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = _plain_in_slices(fa_k.flash_attention_plain, (q, k, v), "qkk", **kw)
    err = max(_check(f"dryrun replay flash {w}", x, y, TOL[q.dtype])
              for w, x, y in zip(("out", "lse"), got, want))
    return err, lambda: fa_k.flash_attention(q, k, v, **kw)


def _replay_flash_bwd(gen, args, kw):
    """q, k, v, dout drawn; out and lse from the forward's plain version on
    them, laid out as the recorded ``out`` and ``lse``; delta inside, from
    ``out``, as ``ops`` calls K5."""
    q, k, v, dout = (_normal(gen, a) for a in args[:4])
    fkw = {n: kw[n] for n in ("causal", "window", "softcap", "scale", "q_offset") if n in kw}
    out, lse = _plain_in_slices(fa_k.flash_attention_plain, (q, k, v), "qkk",
                                return_lse=True, **fkw)
    out, lse = _laid_out(kw["out"], out), _laid_out(args[4], lse)
    kw = {**kw, "out": out}
    got = fab_k.flash_attention_bwd(q, k, v, dout, lse, **kw)
    want = _plain_in_slices(fab_k.flash_attention_bwd_plain,
                            (q, k, v, dout, lse, fab_k.delta_of(dout, out)), "qkkqqq", **fkw)
    err = max(_check(f"dryrun replay flash_bwd {w}", x, y, BWD_TOL[q.dtype])
              for w, x, y in zip(("dq", "dk", "dv"), got, want))
    return err, lambda: fab_k.flash_attention_bwd(q, k, v, dout, lse, **kw)


def _replay_decode(gen, args, kw):
    """Every slot valid, as the dry run's caches are filled to ``S - 1``
    before the step writes the last."""
    q, k, v = (_normal(gen, a) for a in args[:3])
    mask = _laid_out(args[3], torch.ones(args[3][1], dtype=torch.bool, device=gen.device))
    err = _check("dryrun replay decode", dec_k.decode_attention(q, k, v, mask, **kw),
                 dec_k.decode_attention_plain(q, k, v, mask, **kw), TOL[q.dtype])
    return err, lambda: dec_k.decode_attention(q, k, v, mask, **kw)


def _replay_wkv(entry):
    def replay(gen, args, kw):
        """Drawn as :func:`_wkv_inputs` draws them: small k and u, decays
        in (0, 1)."""
        r, v = _normal(gen, args[0]), _normal(gen, args[2])
        k, u = _normal(gen, args[1], 0.3), _normal(gen, args[4], 0.1)
        w = _laid_out(args[3], torch.sigmoid(torch.randn(args[3][1], generator=gen,
                                                         device=gen.device)).to(args[3][4]))
        fn, plain = getattr(wkv_k, entry), getattr(wkv_k, entry + "_plain")
        got, want = fn(r, k, v, w, u), plain(r, k, v, w, u)
        err = max(_check(f"dryrun replay {entry} {n}", x, y, WKV_TOL[r.dtype])
                  for n, x, y in zip(("y", "s_final"), got, want))
        return err, lambda: fn(r, k, v, w, u)
    return replay


REPLAYS = {"flash_attention": _replay_flash, "flash_attention_bwd": _replay_flash_bwd,
           "decode_attention": _replay_decode, "rwkv6_wkv": _replay_wkv("rwkv6_wkv"),
           "rwkv6_wkv_model": _replay_wkv("rwkv6_wkv_model")}


def _describe(args, kw):
    """A signature as text: each tensor's shape and dtype, its strides where
    it is not contiguous and its offset where it is not 0."""
    def one(x):
        if not (isinstance(x, tuple) and x and x[0] == "tensor"):
            return repr(x)
        _, shape, stride, offset, dtype = x
        dense = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        return (f"{shape} {str(dtype).replace('torch.', '')}"
                + ("" if stride == dense else f" strides {stride}")
                + (f" offset {offset}" if offset else ""))
    return ", ".join([one(a) for a in args] + [f"{k}={one(v)}" for k, v in kw])


def dryrun_replay(device, timer, calls, label="dryrun"):
    """Each distinct signature in ``calls`` replayed once on random inputs
    laid out as recorded and held against its kernel's plain version, then
    timed; ``label`` names the phase in the printed lines. A signature of an
    entry with no replay fails the phase."""
    gen = torch.Generator(device=device).manual_seed(7)
    rows = []
    for (name, args, kw), n in sorted(calls.items(), key=lambda c: (c[0][0], repr(c[0][1:]))):
        assert name in REPLAYS, f"the {label} phase reached {name}, which has no replay here"
        err, fn = REPLAYS[name](gen, args, dict(kw))
        ms = timer(fn, warmup=1, iters=5) if device.type == "cuda" else None
        rows.append({"kernel": name.replace("_model", ""), "entry": name,
                     "signature": _describe(args, kw), "calls": n,
                     "max_abs_err": err, "ms": ms})
        print(f"  {label} replay {name}({rows[-1]['signature']}): {n} calls; max abs err "
              f"{err:.3e}" + ("" if ms is None else f", {ms:.4f} ms"), flush=True)
        del fn
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def dryrun_kernel_shapes(device, timer):
    """K1 and K2 at two shapes the dry-run cells give them for the first
    time, against their plain versions (the serving tolerance) and timed
    beside them and SDPA, contiguous: K1 on the ``wgmma`` route at gemma2-2b's prefill
    (q (2, 8, 8192, 256), k/v (2, 4, 8192, 256) bf16, causal, soft cap 50;
    SDPA has no soft cap and runs without it, so K1 is timed at cap 0 too,
    like for like), K2 on its tensor-core
    instance at qwen3-32b's decode (q (8, 8, 8, 128), k/v (8, 32768, 8, 128)
    bf16, every slot valid; its splits, cluster and route printed, and the
    other cluster size timed beside the rule's), and K5 at gemma2-2b's train
    microbatch (:func:`_k5_d256_shape`)."""
    gen = torch.Generator(device=device).manual_seed(5)
    dt = torch.bfloat16
    rows = {}
    b, h, kv, s, d = 2, 8, 4, 8192, 256
    q, k, v = _flash_inputs(gen, b, h, kv, s, s, d, dt, device)
    assert fa_k.route(dt, d) == "wgmma"
    fn = lambda: fa_k.flash_attention(q, k, v, softcap=50.0)  # noqa: E731
    err = _check("dryrun flash[d256]", fn(), fa_k.flash_attention_plain(q, k, v, softcap=50.0),
                 TOL[dt])
    before = dict(fa_k.launches_by_route)
    ms = timer(fn, iters=7)
    assert fa_k.launches_by_route["wgmma"] > before["wgmma"], "dryrun flash[d256] route"
    dev_ms, _ = device_ms(fn, iters=7)
    fn0 = lambda: fa_k.flash_attention(q, k, v)  # noqa: E731
    err0 = _check("dryrun flash[d256] cap 0", fn0(), fa_k.flash_attention_plain(q, k, v),
                  TOL[dt])
    ms_cap0 = timer(fn0, iters=7)
    plain_ms = timer(lambda: fa_k.flash_attention_plain(q, k, v, softcap=50.0), warmup=1,
                     iters=3)
    try:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                     enable_gqa=True)
        lib()
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
    _check("dryrun flash[d256] cap 0 vs library", fn0(), lib(), TOL[dt])
    library_ms = timer(lib, iters=7)
    nbytes = (2 * b * h * s * d + 2 * b * kv * s * d) * 2
    flops = 4 * d * b * h * _visible_pairs(s, s, True, None, 0)
    t_b, t_f = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    print(f"  dryrun flash[d256]: route wgmma {ms:.4f} ms at cap 50, {ms_cap0:.4f} ms at cap 0 "
          f"(error {err0:.3e}), SDPA {library_ms:.4f} ms")
    rows["flash_attention"] = {
        "shape": f"q({b},{h},{s},{d}) kv({b},{kv},{s},{d}) bf16 causal softcap 50, "
                 f"route wgmma (gemma2-2b prefill)",
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "ms_softcap0": ms_cap0, "max_abs_err_softcap0": err0,
        "library_ms": library_ms, "library_note": "SDPA without the soft cap, beside "
                                                  "ms_softcap0",
        "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations"}
    del q, k, v
    torch.cuda.empty_cache()

    b, kv, g, s, d = 8, 8, 8, 32768, 128
    q = _rand(gen, (b, kv, g, d), dt, device)
    k = _rand(gen, (b, s, kv, d), dt, device)
    v = _rand(gen, (b, s, kv, d), dt, device)
    mask = torch.ones((b, s), dtype=torch.bool, device=device)
    fn = lambda: dec_k.decode_attention(q, k, v, mask)  # noqa: E731
    err = _check("dryrun decode[g8 S 32768]", fn(),
                 dec_k.decode_attention_plain(q, k, v, mask), TOL[dt])
    ms = timer(fn)
    dev_ms, _ = device_ms(fn)
    plain_ms = timer(lambda: dec_k.decode_attention_plain(q, k, v, mask), warmup=1, iters=5)
    ql = q.reshape(b, kv * g, 1, d)
    kl, vl = k.transpose(1, 2), v.transpose(1, 2)
    try:
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True)  # noqa: E731
        lib()
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(g, dim=1) for t in (kl, vl))
        lib = lambda: F.scaled_dot_product_attention(ql, ke, ve)  # noqa: E731
    library_ms = timer(lib)
    library_masked_ms = timer(_sdpa_decode(q, k, v, mask))
    bound, by = _decode_bound(b, kv, g, d, b * s, s)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = dec_k.num_splits(b, kv, s, sms)
    other = 8 if splits != 8 else 4          # the cluster the rule did not pick, for the record
    ms_other = timer(lambda: dec_k.decode_attention(q, k, v, mask, splits=other))
    print(f"  dryrun decode[g8 S 32768]: splits {splits}, cluster "
          f"{dec_k.cluster_size(splits)}, route {dec_k.route(dt)}: {ms:.4f} ms; splits "
          f"{other}: {ms_other:.4f} ms; SDPA with attn_mask {library_masked_ms:.4f} ms")
    rows["decode_attention"] = {
        "shape": f"q({b},{kv},{g},{d}) kv({b},{s},{kv},{d}) bf16, every slot valid "
                 f"(qwen3-32b decode)", "splits": splits,
        "cluster": dec_k.cluster_size(splits), "route": dec_k.route(dt),
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_masked_ms": library_masked_ms,
        f"ms_splits_{other}": ms_other, "bound_ms": bound, "bound_by": by}
    del q, k, v, mask
    torch.cuda.empty_cache()
    rows["flash_attention_bwd"] = _k5_d256_shape(gen, device, timer)
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"  dryrun {name} at {r['shape']}: {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ({r.get('library_note', '')}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return rows


def _k5_d256_shape(gen, device, timer):
    """K5 at gemma2-2b's train microbatch (q/dout (1, 8, 4096, 256), k/v (1,
    4, 4096, 256) bf16, causal, soft cap 50, delta inside from ``out``) on
    its ``wgmma`` route against its plain version, timed beside the plain
    version and the SDPA backward alone (``torch.autograd.grad`` after one
    forward), which has no soft cap and runs without it; where PyTorch
    refuses D 256 there, the row says so. (The parent commit's ``mma`` route
    on the same inputs is timed by ``tools/time_k2_k5.py``.)"""
    dt = torch.bfloat16
    b, h, kv, s, d, cap = 1, 8, 4, 4096, 256, 50.0
    (q, k, v, dout, lse, delta), out = _bwd_inputs(gen, b, h, kv, s, s, d, dt, device,
                                                   softcap=cap)
    assert fab_k.route(dt, d) == "wgmma"
    fn = lambda: fab_k.flash_attention_bwd(q, k, v, dout, lse, out=out, softcap=cap)  # noqa: E731
    want = fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta, softcap=cap)
    before = dict(fab_k.launches_by_route)
    err = max(_check(f"dryrun flash_bwd[d256] {w}", x, y, BWD_TOL[dt])
              for w, x, y in zip(("dq", "dk", "dv"), fn(), want))
    assert {r: fab_k.launches_by_route[r] - before[r] for r in before} == {
        "fma": 0, "mma": 0, "wgmma": 1}
    del want
    ms = timer(fn, iters=7)
    dev_ms, _ = device_ms(fn, iters=7, label="K5 d256")
    plain_ms = timer(lambda: fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                             softcap=cap), warmup=1, iters=3)
    note = "SDPA backward alone, without the soft cap"
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    try:
        try:
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        except TypeError:
            kg, vg = (t.repeat_interleave(h // kv, dim=1).detach().requires_grad_(True)
                      for t in (k, v))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout,  # noqa: E731
                                          retain_graph=True)
        lib()
        library_ms = timer(lib, iters=7)
    except RuntimeError as e:
        library_ms, note = None, f"PyTorch refused the SDPA backward at D 256: {str(e)[:160]}"
    pair_flops = 2 * d * b * h * _visible_pairs(s, s, True, None, 0)
    nbytes = (3 * b * h * s * d + 4 * b * kv * s * d) * 2 + 2 * 4 * b * h * s
    t_b, t_f = nbytes / HBM_BW * 1e3, 5 * pair_flops / PEAK_FLOPS[dt] * 1e3
    print(f"  dryrun flash_bwd[d256]: route wgmma {ms:.4f} ms; the design's 7 products at "
          f"989 TFLOP/s {7 * pair_flops / PEAK_FLOPS[dt] * 1e3:.4f} ms")
    return {"shape": f"q/dout({b},{h},{s},{d}) kv({b},{kv},{s},{d}) bf16 causal softcap 50, "
                     f"route wgmma (gemma2-2b train microbatch)",
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_note": note,
            "bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations"}


def dryrun_phase(device, args, card, timer):
    """``launch.dryrun.run_cell`` with the kernels on for each of
    ``DRYRUN_CELLS`` (or every cell with ``--all``): one JSON line a cell,
    each kernel's launches held to layers x calls at the depths run, every
    output finite; then the FLOP check, every kernel call signature of the
    cells replayed against its plain version, and the new shapes' kernel
    times. Returns the launch counts of the cells' runs."""
    from repro_torch.configs import cells, get_config, get_shape
    from repro_torch.launch import dryrun as dr
    todo = ([(a, s) for a, s, skip in cells() if not skip] if args.all
            else list(DRYRUN_CELLS))
    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    calls = collections.Counter()
    for arch, shape in todo:
        reset_counts()
        with recording_calls(calls):
            rec = dr.run_cell(arch, shape, use_kernels=True, device=device)
        got = {k: m.launches for k, m in KERNELS.items()}
        routes = {k: dict(m.launches_by_route) for k, m in ROUTED.items()}
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        if not args.all:
            assert rec["fits"], (arch, shape, rec["method"])
        if not rec["fits"]:
            continue
        assert rec["finite"], (arch, shape)
        cfg = get_config(arch)
        want = dict.fromkeys(KERNELS, 0)
        for run in rec["runs"] if rec["kernels"] == "on" else ():
            for k, n in expected_launches(cfg.scaled(num_layers=run["num_layers"]),
                                          get_shape(shape).kind, rec["microbatches"],
                                          2).items():
                want[k] += n
        assert got == want == rec["launches"], (arch, shape, got, want)
        if rec["kernels"] == "on":
            rt = fa_k.route(torch.bfloat16, cfg.head_dim)
            assert routes["flash_attention"][rt] == got["flash_attention"], routes
        for k in total:
            total[k] += got[k]
        print(f"dryrun {arch} x {shape}: launches {got} = layers x calls at the depths "
              f"run; routes {rec['launches_by_route']}")
    reset_counts()
    checks = dryrun_flops_check(device)
    print(f"dryrun: {len(calls)} distinct kernel call signatures in the cells, "
          f"replayed against the plain versions:")
    replayed = dryrun_replay(device, timer, calls)
    shapes = dryrun_kernel_shapes(device, timer)
    print(f"dryrun: {len(todo)} cells, launches {total}; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return total, {"flops_check": checks, "replayed": replayed, "kernel_shapes": shapes}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "main", "archs", "train", "sim",
                                        "dryrun", "profile"), default="all")
    ap.add_argument("--all", action="store_true",
                    help="--phase dryrun: every cell of configs.cells(), not only DRYRUN_CELLS")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", choices=("phi4-mini-3.8b", "rwkv6-1.6b", JAMBA, DEEPSEEK)
                    + tuple(a for a, _ in ARCH_TRACES) + STUB_ARCHS,
                    default="phi4-mini-3.8b", help="the model --phase profile runs "
                    f"({JAMBA}: cut to one super-block and 8 experts; {DEEPSEEK}: cut "
                    f"to {DEEPSEEK_LAYERS} layers; {MIXTRAL}: cut to {MIXTRAL_LAYERS} layers)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda)

    t0 = time.time()
    _build.load()   # every phase builds, the sim phase too: its launches are counted
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
        for fn, frame, st, ld, nreg in re.findall(
                r"Function properties for (\S*(?:mma|sm90)_kernel\S*)\n\s*(\d+) bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
                log):
            print(f"  ptxas {src}: {fn}: {nreg} registers, {frame} bytes stack frame, "
                  f"{st} bytes spill stores, {ld} bytes spill loads")

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
                      f"{kd['device_ms']:.4f} ms ({_per_call(kd['device_kernels_per_call'])})"
                      + ("; library: " if ldev is not None else "")
                      + (f"call {lcall:.4f} ms, " if lcall is not None else "")
                      + (f"device {ldev:.4f} ms "
                         f"({_per_call(kd['library_kernels_per_call'])})"
                         if ldev is not None else ""))
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
    if args.phase in ("all", "archs"):
        archs, archs_replayed = archs_phase(device, args, Timer(device))
        paths.update(archs)
        for kd in kernels:
            kd["archs_replayed"] = [r for r in archs_replayed if r["kernel"] == kd["name"]]
    if args.phase in ("all", "train"):
        train_paths, train_replayed = train_phase(device, args, Timer(device))
        paths.update(train_paths)
        for kd in kernels:
            kd["train_replayed"] = [r for r in train_replayed if r["kernel"] == kd["name"]]
    if args.phase in ("all", "sim"):
        paths["sim"] = sim_phase(card)
    if args.phase in ("all", "dryrun"):
        paths["dryrun"], dryrun_extra = dryrun_phase(device, args, card, Timer(device))
        for kd in kernels:
            if kd["name"] in dryrun_extra["kernel_shapes"]:
                kd["dryrun_shape"] = dryrun_extra["kernel_shapes"][kd["name"]]
            kd["dryrun_replayed"] = [r for r in dryrun_extra["replayed"]
                                     if r["kernel"] == kd["name"]]
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
