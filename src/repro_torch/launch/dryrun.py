"""One-card dry run: every (arch x shape) cell's step, run on one H100.

  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k --use-kernels
  python -m repro_torch.launch.dryrun --all --use-kernels [--json out.jsonl]

The JAX package lowers and compiles each cell on 512 placeholder devices and
reads FLOPs, bytes and memory from the compiled artifact. PyTorch has no
such artifact and one card has no mesh, so here each cell's step **runs**:

  * what runs: ``train_step``, ``prefill`` or ``decode_step`` in the cell's
    dtype (bf16; fp32 master weights and bf16 moments in training), at one
    data shard's batch of the reference's mesh, ``b = max(global_batch //
    16, 1)``, at the full published width (no model-axis split). Decode
    runs with every cache slot filled (``lengths = S - 1``).
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one step. It
    cannot see inside the hand kernels, so with kernels on the analytic
    ``roofline.flash_attention_correction`` (K1, K5) and
    ``ssm_scan_correction`` (K3, K4) are added, as the reference adds them
    for the calls ``cost_analysis`` cannot see, and
    :func:`decode_attention_flops` for K2, which the reference does not
    correct. The train cells of archs with a Mamba or RWKV mixer run with
    the kernels off: K3 and K4 have no backward (``ops._no_grad`` raises).
  * bytes: reckoned by :func:`reckon_bytes` (weights, caches, activations at
    the flash ideal); PyTorch counts none.
  * peak memory (``torch.cuda.max_memory_allocated``) and step time (CUDA
    events around a second step, the first being the counted warm-up), at
    the depths and lengths actually run.
  * extrapolation, the reference's method: depth from two unit counts
    (``m(U) = m_k2 + (m_k2 - m_k1) / (k2 - k1) * (U - k2)``), and for
    prefill a quadratic in the sequence length through three S points;
    FLOPs and bytes are extrapolated.
  * fit, decided before anything is allocated, from :func:`reckon_footprint`:
    the reference's units (2, 4) where they fit the card, otherwise the
    largest pair k1 < k2 <= 4 that does, with microbatches for a train cell
    where one batch does not fit (a recurrent arch's train cell, whose
    kernels are off, runs its per-token loop at units 0 and 1). A cell that no pair fits gives one record,
    ``"fits": false``, with its reckoned bytes. Nothing catches an
    out-of-memory error and nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_NAMES, SHAPES, ShapeConfig, cells, get_config,
                                 get_shape)
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ops import KERNELS, ROUTED, launch_counts
from repro_torch.launch.inputs import input_specs, token_seq_len
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import layer_window
from repro_torch.models.layers import resolve_device
from repro_torch.roofline import analysis as roofline
from repro_torch.train import train_step as ts

DATA_AXIS = 16          # the reference mesh's data axis: a card runs one shard's batch
K_SMALL, K_BIG = 2, 4
# share of the card's memory a plan may fill: the rest covers what the
# reckoning leaves out (the allocator's rounding, cuBLAS workspaces)
HEADROOM = 0.7


def card_batch(shape) -> int:
    return max(shape.global_batch // DATA_AXIS, 1)


def step_mode(shape) -> str:
    if shape.kind == "train":
        return "train"
    return "serve_long" if shape.kind == "decode" and shape.global_batch == 1 else "serve"


def cell_kernels(cfg, kind: str, use_kernels: bool) -> Tuple[bool, str]:
    """Whether the cell's step runs the kernels, and why not where asked."""
    if use_kernels and kind == "train" and cfg.ssm is not None:
        return False, ("off: K3 and K4 have no backward (ops._no_grad raises "
                       "under autograd)")
    return use_kernels, "on" if use_kernels else "off"


# ----------------------------------------------------------------------
# depth scaling for the extrapolation method (as the reference's)
def _unit_block(cfg) -> int:
    """Layers per unit of the scalable (last) group."""
    if cfg.hybrid_block_size > 1:
        return cfg.hybrid_block_size
    if cfg.attention_kind == "local_global":
        return 2
    return 1


def scalable_units(cfg) -> int:
    return (cfg.num_layers - cfg.num_dense_layers) // _unit_block(cfg)


def reduced_config(cfg, units: int):
    """Same width, the scalable group reduced to ``units``."""
    return cfg.scaled(num_layers=cfg.num_dense_layers + units * _unit_block(cfg))


def prefill_s_points(cfg) -> Tuple[int, ...]:
    return (4096, 6144, 8192) if cfg.frontend_stub else (2048, 4096, 8192)


def _extrapolate(m1: Dict, m2: Dict, k1: int, k2: int, units: int) -> Dict:
    def ext(a, b):
        return b + (b - a) / (k2 - k1) * (units - k2)
    return {key: max(ext(m1[key], m2[key]), 0.0) for key in ("flops", "bytes")}


def _quad_fit(ss, vals, s_target: float) -> float:
    """Exact quadratic through three (S, value) points, evaluated at
    s_target — prefill costs are polynomial (<= deg 2) in sequence length."""
    coef = np.polyfit(np.asarray(ss, float), np.asarray(vals, float), 2)
    return float(max(np.polyval(coef, s_target), 0.0))


# ----------------------------------------------------------------------
# reckoning: no allocation
def _nbytes(tree) -> int:
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
    shd.tree_map(add, tree)
    return total[0]


def _n_params(cfg) -> int:
    return _nbytes(tfm.abstract_params(cfg, torch.float32)) // 4


def _unit_params(cfg) -> int:
    """Parameters of one unit of the scalable group."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return math.prod(tree.shape)
    return count(tfm.unit_param_specs(cfg, tfm.layer_plan(cfg)[-1]))


def _cache_bytes(cfg, kind: str, b: int, seq_len: int) -> float:
    """Bytes of the caches a step reads (decode) or writes (prefill: the K/V
    of every position, windowed layers too; the engine pads them into the
    decode caches)."""
    if kind == "train":
        return 0.0
    if kind == "prefill":
        cfg = cfg.scaled(sliding_window=max(cfg.sliding_window, seq_len))
    return float(_nbytes(tfm.abstract_cache(cfg, b, seq_len)))


def _sublayers(cfg):
    """(sublayer, count) of every sublayer kind of the model."""
    return [(sl, g.n_units) for g in tfm.layer_plan(cfg) for sl in g.pattern]


def _stream_elems(cfg, sl) -> float:
    """Elements a token moves through the mixer's kernel at the flash ideal:
    its inputs read once and its outputs written once (2-byte units)."""
    if sl.mixer == "gqa":
        return 2 * cfg.q_dim + 2 * cfg.kv_dim
    if sl.mixer == "mla":
        m = cfg.mla
        return cfg.num_heads * (2 * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                                + 2 * m.v_head_dim)
    if sl.mixer == "mamba":
        d_in = cfg.ssm.expand * cfg.d_model
        return 3 * d_in + 4 * cfg.ssm.d_state           # u, dt, y; B, C fp32
    return 7 * cfg.d_model                              # r, k, v; w, y fp32


def reckon_bytes(cfg, kind: str, b: int, seq_len: int) -> Dict[str, float]:
    """HBM bytes of one step, reckoned: the least the step must move.

    * weights: serving reads every bf16 parameter once (2 B a parameter);
      training reads the fp32 masters for the forward, the recompute and the
      backward (12), writes the fp32 gradient (4), and the AdamW update reads
      p, g, mu, nu and writes p, mu, nu (12 + 8; bf16 moments): 36 B.
    * caches: decode reads the whole cache (every slot filled); prefill
      writes the K/V (or latents, states) of every position; training has
      none.
    * activations at the flash ideal, 2 B an element: each sublayer reads
      and writes the residual stream once (4 d a token), each mixer's kernel
      streams its inputs and outputs once (q, k, v, out for attention; no
      S x S scores), and the fp32 logits are written once (every token in
      training, the last position otherwise); training moves them three
      times (forward, recompute, backward).

    Linear in the unit count and in the sequence length, so the
    reference's extrapolation reproduces the full-depth value."""
    n = _n_params(cfg)
    weights = (36.0 if kind == "train" else 2.0) * n
    caches = _cache_bytes(cfg, kind, b, seq_len)
    t = b if kind == "decode" else b * seq_len
    per_token = sum(cnt * (4 * cfg.d_model + _stream_elems(cfg, sl)) * 2
                    for sl, cnt in _sublayers(cfg))
    s_tok = seq_len - cfg.stub_embed_len if cfg.frontend_stub else seq_len
    logits = 4.0 * cfg.vocab_size * (b * s_tok if kind == "train" else b)
    acts = (t * per_token + logits) * (3 if kind == "train" else 1)
    return {"weights": weights, "caches": caches, "activations": acts,
            "total": weights + caches + acts}


def _work_per_token(cfg, sl) -> float:
    """Bytes a token's temporaries take in one sublayer, generously
    (fp32 norm and RoPE copies, projections, MLP hidden, expert buffers)."""
    d = cfg.d_model
    w = 12.0 * d + 4.0 * d
    if sl.mixer == "gqa":
        w += 16.0 * (cfg.q_dim + cfg.kv_dim) + 2 * d
    elif sl.mixer == "mla":
        m = cfg.mla
        w += 24.0 * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                     + m.v_head_dim) + 8.0 * m.q_lora_rank
    elif sl.mixer == "mamba":
        w += 40.0 * cfg.ssm.expand * d
    else:                                           # rwkv: time and channel mix
        w += 60.0 * d + 8.0 * cfg.d_ff
    if sl.mlp == "dense":
        w += (8.0 if cfg.mlp_kind in ("swiglu", "geglu") else 4.0) * sl.d_ff
    elif sl.mlp == "moe":
        m = cfg.moe
        w += 24.0 * m.num_experts + m.top_k * 1.25 * (4.0 * d + 8.0 * m.d_ff_expert)
        w += 8.0 * d + 8.0 * m.d_ff_expert * m.num_shared_experts
    return w


def _quadratic_work(cfg, sl, kind: str, b: int, seq_len: int, kernels: bool) -> float:
    """Bytes of a sublayer's temporaries that do not scale with tokens alone:
    the S x S scores of the einsum paths, the state sequence a recurrence's
    loop keeps for its backward, the fp32 copies of a decode cache."""
    h, s = cfg.num_heads, seq_len
    if kind == "decode":
        if sl.mixer == "gqa" and not kernels:
            win = layer_window(cfg, sl.is_global)
            s_c = s if win is None else min(s, win)
            return 4.0 * b * s_c * cfg.kv_dim + 12.0 * b * h * s_c
        if sl.mixer == "mla":
            return 8.0 * b * s * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) \
                + 12.0 * b * h * s
        return 0.0
    if sl.mixer == "gqa" and not kernels:
        return 14.0 * b * h * s * s
    if sl.mixer == "mla":
        return 24.0 * b * h * s * s
    if kind == "train" and sl.mixer == "rwkv":       # the loop's saved states
        return 12.0 * b * s * cfg.d_model * cfg.ssm.wkv_head_dim
    if kind == "train" and sl.mixer == "mamba":
        return 16.0 * b * s * cfg.ssm.expand * cfg.d_model * cfg.ssm.d_state
    return 0.0


def reckon_footprint(cfg, kind: str, b: int, seq_len: int, *, microbatches: int = 1,
                     kernels: bool = False, remat_policy: str = "nothing") -> float:
    """Peak device bytes of one step, reckoned before anything is allocated:
    the resident state (bf16 parameters; in training the fp32 masters and
    gradient and the bf16 moments), the caches, and the largest working set
    of activations (one sublayer at a time in serving; in training the
    unit inputs kept by remat, one unit's recompute and backward, and the
    logits with their gradient)."""
    n = _n_params(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    subs = _sublayers(cfg)
    if kind == "train":
        bm = max(b // microbatches, 1)
        t = bm * seq_len
        s_tok = seq_len - cfg.stub_embed_len if cfg.frontend_stub else seq_len
        unit_params = _unit_params(cfg)
        state = 12.0 * n + 4.0 * unit_params + 4.0 * v * d + 1.0e9
        n_units = sum(g.n_units for g in tfm.layer_plan(cfg))
        kept = 2.0 * t * d * n_units * (1 + (len(subs) if remat_policy == "save_attn" else 0))
        unit = 2.0 * sum(t * _work_per_token(cfg, sl)
                         + _quadratic_work(cfg, sl, kind, bm, seq_len, kernels)
                         for g in tfm.layer_plan(cfg)[-1:] for sl in g.pattern)
        logits = (24.0 if cfg.final_logit_softcap else 16.0) * bm * s_tok * v
        total = state + kept + unit + logits
    else:
        cache = _cache_bytes(cfg, kind, b, seq_len)
        t = b if kind == "decode" else b * seq_len
        work = max((t * _work_per_token(cfg, sl)
                    + _quadratic_work(cfg, sl, kind, b, seq_len, kernels)
                    for sl, _ in subs), default=0.0)
        # prefill stacks its per-unit caches: the list and the stack at once
        state = 2.0 * n + (2.0 if kind == "prefill" else 1.0) * cache
        total = state + work + 12.0 * t * d + 8.0 * b * v
    return total * 1.1


def decode_attention_flops(cfg, cache_len: int, batch: int) -> float:
    """FLOPs of the decode-attention kernel (K2) over full caches, which a
    FLOP count cannot see inside: 4 B H S_cache D per attention layer, the
    window on windowed layers. (Port-only: the JAX package adds no term for
    its decode kernel.)"""
    total = 0.0
    for g in tfm.layer_plan(cfg):
        for sl in g.pattern:
            if sl.mixer != "gqa":
                continue
            win = layer_window(cfg, sl.is_global)
            s_c = cache_len if win is None else min(cache_len, win)
            total += g.n_units * 4.0 * batch * cfg.num_heads * s_c * cfg.head_dim
    return total


def kernel_flops(cfg, kind: str, b: int, seq_len: int) -> Dict[str, float]:
    """The analytic FLOPs of the kernels a step with kernels on runs, which
    FlopCounterMode does not see (one card: data and model axes of 1)."""
    one = {"data_axis": 1, "model_axis": 1}
    out = {"flash": roofline.flash_attention_correction(cfg, seq_len, b, 1, kind, **one)["flops"],
           "ssm": roofline.ssm_scan_correction(cfg, seq_len, b, 1, kind, **one)["flops"]}
    out["decode"] = decode_attention_flops(cfg, seq_len, b) if kind == "decode" else 0.0
    return out


# ----------------------------------------------------------------------
# measurement
def _diff(after: Dict, before: Dict) -> Dict:
    return {"launches": {k: after["launches"][k] - before["launches"][k]
                         for k in after["launches"]},
            "routes": {k: {r: n - before["routes"][k][r] for r, n in v.items()}
                       for k, v in after["routes"].items()}}


def _materialize(spec, name: str, cfg, gen, device, seq_len: int):
    """A spec tree of ``meta`` tensors made real on ``device``: token ids
    drawn from ``gen``, stub embeddings normal, caches zero, lengths ``S -
    1`` (every slot filled). Integer inputs are int64, as the engine's."""
    if name == "caches":
        return shd.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                            spec)
    if name == "lengths":
        return torch.full(spec.shape, seq_len - 1, dtype=torch.long, device=device)
    if name == "tokens":
        return torch.randint(1, cfg.vocab_size, tuple(spec.shape), generator=gen,
                             device=device, dtype=torch.long)
    return torch.empty(spec.shape, dtype=spec.dtype, device=device).normal_(0.0, 1.0,
                                                                            generator=gen)


def measure(cfg, kind: str, b: int, seq_len: int, *, use_kernels: bool,
            remat_policy: str = "nothing", microbatches: int = 1, device=None,
            seed: int = 0, timed: bool = True) -> Dict[str, Any]:
    """Runs one step of ``kind`` for ``cfg`` at batch ``b`` and length
    ``seq_len`` (decode: the cache length) on ``device`` (None: the card):
    once under FlopCounterMode, then, if ``timed``, once more between CUDA
    events. Returns the counted FLOPs, the peak memory and step time (card
    only) and the kernel launches of both runs."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    shape = ShapeConfig(kind, seq_len, b, kind)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = input_specs(cfg, shape)
    if kind == "train":
        tcfg = ts.TrainConfig(remat=True, microbatches=microbatches,
                              use_kernels=use_kernels, remat_policy=remat_policy)
        state = ts.init_train_state(cfg, tcfg, gen, device=device)
        batch = {k: _materialize(v, k, cfg, gen, device, seq_len)
                 for k, v in specs["batch"].items()}

        def step():
            return ts.train_step(cfg, tcfg, state, batch)[1]["loss"]
        grad = contextlib.nullcontext
    else:
        params = model_lib.init_params(cfg, gen, dtype=cfg.dtype, device=device)
        inp = {k: _materialize(v, k, cfg, gen, device, seq_len) for k, v in specs.items()}
        if kind == "prefill":
            def step():
                return model_lib.prefill(cfg, params, inp["tokens"], inp.get("embeds"),
                                         use_kernels=use_kernels)[0]
        else:
            def step():
                return model_lib.decode_step(cfg, params, inp["caches"], inp["lengths"],
                                             inp["tokens"], use_kernels=use_kernels)[0]
        grad = torch.no_grad
    before = launch_counts()
    counter = FlopCounterMode(display=False)
    with grad(), counter:
        out = step()
    flops = float(counter.get_total_flops())
    ok = bool(torch.isfinite(out).all())
    ms = None
    if timed:
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(device)
            t0.record()
            with grad():
                out = step()
            t1.record()
            torch.cuda.synchronize(device)
            ms = t0.elapsed_time(t1)
        else:
            with grad():
                out = step()
        ok = ok and bool(torch.isfinite(out).all())
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return {"flops": flops, "peak_bytes": peak, "step_ms": ms, "finite": ok,
            **_diff(launch_counts(), before)}


# ----------------------------------------------------------------------
def plan_cell(cfg, shape, *, use_kernels: bool, capacity: float, microbatches: int = 1,
              method: str = "extrapolate", remat_policy: str = "nothing") -> Dict[str, Any]:
    """What runs, decided before anything is allocated: the depths (units
    pair, or None for the full depth), the sequence lengths, the
    microbatches, and the reckoned peak of the deepest run."""
    kind = shape.kind
    b = card_batch(shape)
    kernels, _ = cell_kernels(cfg, kind, use_kernels)
    units = scalable_units(cfg)
    s_list = (prefill_s_points(cfg) if kind == "prefill" and method == "extrapolate"
              else (shape.seq_len,))
    if method == "direct" or units <= K_BIG:
        pairs: List[Optional[Tuple[int, int]]] = [None]
    elif kind == "train" and cfg.ssm is not None and not kernels:
        # the recurrences run as a per-token Python loop (about 110 dispatched
        # ops a token and layer): its time, not memory, sets the depths
        pairs = [(0, 1)]
    else:
        pairs = [(K_SMALL, K_BIG)] + [(k2 - 1, k2) for k2 in (3, 2, 1)]
    mbs = [microbatches]
    if kind == "train":
        mbs += [m for m in (2, 4, 8, 16, 32, 64, 128, 256)
                if m > microbatches and b % m == 0]
    budget = HEADROOM * capacity
    foot = None
    for pair in pairs:
        cfg_k = cfg if pair is None else reduced_config(cfg, pair[1])
        for mb in mbs:
            foot = reckon_footprint(cfg_k, kind, b, max(s_list), microbatches=mb,
                                    kernels=kernels, remat_policy=remat_policy)
            if foot <= budget:
                return {"fits": True, "pair": pair, "s_list": s_list, "microbatches": mb,
                        "reckoned_peak_bytes": foot, "kernels": kernels,
                        "budget_bytes": budget}
    return {"fits": False, "pair": pairs[-1], "s_list": s_list, "microbatches": mbs[-1],
            "reckoned_peak_bytes": foot, "kernels": kernels,
            "budget_bytes": budget}


def _ref_plan_bytes(cfg, shape) -> Dict[str, int]:
    """Bytes one device of the reference's 16x16 mesh holds under the cell's
    rules (bf16 parameters; decode caches)."""
    rules = shd.make_rules(make_production_mesh(), step_mode(shape))
    out = {"params": shd.per_device_bytes(rules, tfm.abstract_params(cfg, torch.bfloat16),
                                          tfm.param_logical_axes(cfg))}
    if shape.kind == "decode":
        c = tfm.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        out["caches"] = shd.per_device_bytes(rules, c, shd.cache_logical_axes(c))
    return out


def run_cell(arch: str, shape_name: str, *, use_kernels: bool = False,
             remat_policy: str = "nothing", microbatches: int = 1,
             method: str = "extrapolate", device=None, capacity: Optional[float] = None,
             verbose: bool = True, cfg_override=None) -> Dict[str, Any]:
    """One cell: plan, run the depths and lengths of the plan, extrapolate,
    add the kernels' analytic FLOPs, and the roofline with H100 peaks."""
    cfg = cfg_override or get_config(arch)
    shape = get_shape(shape_name)
    device = resolve_device(device)
    if capacity is None:
        if device.type != "cuda":
            raise ValueError("run_cell on the CPU needs the memory capacity to plan for")
        capacity = torch.cuda.get_device_properties(device).total_memory
    kind, b = shape.kind, card_batch(shape)
    t_start = time.time()
    plan = plan_cell(cfg, shape, use_kernels=use_kernels, capacity=capacity,
                     microbatches=microbatches, method=method, remat_policy=remat_policy)
    kernels = plan["kernels"]
    full_bytes = reckon_bytes(cfg, kind, b, shape.seq_len)
    mf = roofline.model_flops(cfg, dataclasses.replace(shape, global_batch=b), 1)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name, "mesh": "1 card", "mode": step_mode(shape),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "batch": b, "seq_len": shape.seq_len, "token_seq_len": token_seq_len(cfg, shape),
        "kernels": cell_kernels(cfg, kind, use_kernels)[1], "fits": plan["fits"],
        "reckoned_peak_bytes": plan["reckoned_peak_bytes"],
        "budget_bytes": plan["budget_bytes"], "microbatches": plan["microbatches"],
        "model_flops": mf, "hbm_bytes": full_bytes["total"],
        "bytes_terms": {k: full_bytes[k] for k in ("weights", "caches", "activations")},
        "ref_16x16_bytes_per_device": _ref_plan_bytes(cfg, shape),
    }
    if not plan["fits"]:
        pair = plan["pair"]
        rec["method"] = (f"no pair fits: units {pair[1]} reckoned at "
                         f"{plan['reckoned_peak_bytes'] / 1e9:.1f} GB")
        if verbose:
            print(f"== {cfg.name} x {shape_name}: does not fit one card "
                  f"({rec['method']}, budget {plan['budget_bytes'] / 1e9:.1f} GB)")
        return rec

    pair, s_list = plan["pair"], plan["s_list"]
    depths = [None] if pair is None else list(pair)
    runs, at = [], {}
    for s in s_list:
        for k in depths:
            cfg_k = cfg if k is None else reduced_config(cfg, k)
            m = measure(cfg_k, kind, b, s, use_kernels=kernels, remat_policy=remat_policy,
                        microbatches=plan["microbatches"], device=device)
            m["bytes"] = reckon_bytes(cfg_k, kind, b, s)["total"]
            runs.append({"units": scalable_units(cfg_k) if k is not None else None,
                         "num_layers": cfg_k.num_layers, "seq_len": s, **m})
            at[(k, s)] = m
    units = scalable_units(cfg)
    per_s = {}
    for s in s_list:
        if pair is None:
            per_s[s] = {key: at[(None, s)][key] for key in ("flops", "bytes")}
        else:
            per_s[s] = _extrapolate(at[(pair[0], s)], at[(pair[1], s)], pair[0], pair[1], units)
    if len(s_list) > 1:
        raw = {key: _quad_fit(s_list, [per_s[s][key] for s in s_list], shape.seq_len)
               for key in ("flops", "bytes")}
    else:
        raw = per_s[s_list[0]]
    depth_tag = "direct" if pair is None else f"extrapolate({pair[0]},{pair[1]})->{units}"
    rec["method"] = depth_tag + (f"xquadS{tuple(s_list)}->{shape.seq_len}"
                                 if len(s_list) > 1 else "") + (
        f", microbatches {plan['microbatches']}" if kind == "train" else "")
    # on the CPU the wrappers run the plain versions, which the count sees
    corr = kernel_flops(cfg, kind, b, shape.seq_len) if kernels and device.type == "cuda" else {}
    flops = raw["flops"] + sum(corr.values())
    peak = max(r["peak_bytes"] or 0 for r in runs)
    rl = roofline.analyze_counts(flops, raw["bytes"], 0.0, model_flops_per_device=mf,
                                 peak_mem_bytes=peak)
    launches = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}
    routes = {k: {r: sum(x["routes"][k][r] for x in runs) for r in KERNELS[k].ROUTES}
              for k in ROUTED}
    rec.update({
        "counted_flops": raw["flops"], "kernel_flops": corr, "flops": flops,
        "extrapolated_bytes": raw["bytes"], "collective_bytes": 0.0,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s, "collective_s": rl.collective_s,
        "dominant": rl.dominant, "useful_flops_ratio": rl.useful_flops_ratio,
        "roofline_fraction": rl.roofline_fraction,
        "peak_bytes": peak, "finite": all(r["finite"] for r in runs),
        "runs": [{k: r[k] for k in ("units", "num_layers", "seq_len", "peak_bytes",
                                    "step_ms", "flops", "launches")} for r in runs],
        "launches": launches,
        "launches_by_route": {k: {r: n for r, n in v.items() if n} for k, v in routes.items()},
        "wall_s": time.time() - t_start,
    })
    if verbose:
        deepest = runs[-1]
        print(f"== {cfg.name} x {shape_name} [1 card, {rec['mode']}, b {b}, "
              f"{rec['method']}, kernels {rec['kernels']}] {rec['wall_s']:.1f} s")
        print(f"   flops {flops:.4e} (counted {raw['flops']:.4e}, kernels "
              f"{sum(corr.values()):.4e}), model {mf:.4e}, useful "
              f"{rl.useful_flops_ratio:.3f}; bytes {raw['bytes']:.4e}")
        print(f"   roofline: compute {rl.compute_s * 1e3:.3f} ms, memory "
              f"{rl.memory_s * 1e3:.3f} ms, collective 0 (one card) -> {rl.dominant}; "
              f"fraction {rl.roofline_fraction:.3f}")
        print(f"   at {deepest['num_layers']} layers, S {deepest['seq_len']}: peak "
              f"{(deepest['peak_bytes'] or 0) / 1e9:.2f} GB (reckoned "
              f"{plan['reckoned_peak_bytes'] / 1e9:.2f} GB), step "
              f"{deepest['step_ms'] or 0:.2f} ms; launches "
              f"{{{', '.join(f'{k}: {n}' for k, n in launches.items() if n)}}}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--remat-policy", default="nothing", choices=tfm.REMAT_POLICIES)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--direct", action="store_true",
                    help="run the full depth and length (no extrapolation)")
    ap.add_argument("--json", help="append records to this JSON-lines file")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a, s, skip in cells() if not skip]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        if args.shape == "long_500k" and not get_config(args.arch).sub_quadratic:
            print(f"SKIP {args.arch} x long_500k: pure full-attention arch")
            return 0
        todo = [(args.arch, args.shape)]
    device = resolve_device(None)
    for arch, shape in todo:
        rec = run_cell(arch, shape, use_kernels=args.use_kernels,
                       remat_policy=args.remat_policy, microbatches=args.microbatches,
                       method="direct" if args.direct else "extrapolate", device=device)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.json:
            with open(args.json, "a") as f:
                f.write(line + "\n")
    print(f"\n{len(todo)} cell(s) done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
