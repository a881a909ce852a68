"""Serving launcher: the paper's full system — heterogeneous worker groups,
profiling, Gateway dispatch (Algorithm 1), accuracy-configured variants —
with every share executed by a real model variant on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --policy proportional --requests 6 --disconnect

runs the full-width variants in bf16 on the card. ``--smoke`` runs the
reduced variant configs instead; ``--device cpu`` is the only way onto the
CPU (there is no silent fallback).

The gateway plans every request over the analytic profiling table of the
*full* config (or of the config passed as ``cfg=``, e.g. a depth- and
expert-cut jamba that fits one card). Each share then runs through the
serving engine of its accuracy level: one engine per level, built lazily and
shared by all nodes that run that level (a full-width variant is several GB;
one copy per node and level would not fit on one card). ``max_engines``
bounds how many levels stay resident: before a new level is built the least
recently used engine is dropped, and it is rebuilt from its seed when its
level comes back.
"""
from __future__ import annotations

import argparse
import gc
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import (ARCH_NAMES, ModelConfig, get_config,
                                 get_smoke_config)
from repro_torch.core.cluster import DEFAULT_NODES, SimBackend
from repro_torch.core.profiling import (H100_SXM, HardwareSpec, NodeProfile,
                                        ProfilingTable)
from repro_torch.core.requests import InferenceRequest
from repro_torch.core.resource_manager import Event, GatewayNode
from repro_torch.core.variants import VariantPool
from repro_torch.models import model as model_lib
from repro_torch.models.layers import resolve_device, resolve_dtype
from repro_torch.sched import registered_policies
from repro_torch.serving.engine import BatchScheduler, Engine, EngineConfig


def build_gateway(cfg, *, policy: str = "proportional",
                  nodes=DEFAULT_NODES, seq_len: int = 512,
                  noise_std: float = 0.0, seed: int = 0,
                  hw: HardwareSpec = H100_SXM) -> GatewayNode:
    pool = VariantPool(cfg)
    node_profiles = [NodeProfile(n.name, n.chips, n.capability) for n in nodes]
    table = ProfilingTable(pool, node_profiles, seq_len=seq_len, hw=hw)
    backend = SimBackend(table, noise_std=noise_std, seed=seed)
    gn = GatewayNode(table, backend, policy=policy)
    gn.startup()
    return gn


def demo_requests(gn: GatewayNode, n: int, seed: int = 0) -> List[InferenceRequest]:
    """Paper §IV-B style scenario generator: perf_req between full-accuracy
    capacity and max-approximation capacity; acc_req in a feasible band."""
    rng = np.random.default_rng(seed)
    full_cap = gn.table.perf[0].sum()
    max_cap = gn.table.perf[-1].sum()
    out = []
    for i in range(n):
        perf = rng.uniform(0.9 * full_cap, 0.95 * max_cap)
        acc = rng.uniform(86.0, 90.5)
        items = int(rng.choice([260, 390, 520, 650]))
        out.append(InferenceRequest(rid=i, num_items=items,
                                    perf_req=perf, acc_req=acc))
    return out


class EnginePool:
    """One serving engine per accuracy level, built on first use. Weights
    are random, drawn on the device in the working dtype from a generator
    seeded with ``seed + level``, so a dropped engine is rebuilt bit for
    bit. ``max_engines`` (None: no bound) caps the engines kept: before a
    new level is built, the least recently used engine is dropped and its
    memory returned to the device."""

    def __init__(self, cfg, *, device=None, dtype="bfloat16",
                 max_len: int = 1024, seed: int = 0,
                 max_engines: Optional[int] = None):
        if max_engines is not None and max_engines < 1:
            raise ValueError(f"max_engines must be at least 1, got {max_engines}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.pool = VariantPool(cfg)
        self.ecfg = EngineConfig(max_len=max_len)
        self.seed = seed
        self.max_engines = max_engines
        self.engines: Dict[int, Engine] = OrderedDict()   # least recent first
        self.builds = 0

    def engine_for(self, level: int) -> Engine:
        if level in self.engines:
            self.engines.move_to_end(level)
        else:
            if self.max_engines is not None and len(self.engines) >= self.max_engines:
                self.engines.popitem(last=False)
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
            name = "bfloat16" if self.dtype == torch.bfloat16 else "float32"
            vcfg = self.pool[level].config.scaled(dtype=name)
            gen = torch.Generator(device=self.device).manual_seed(self.seed + level)
            params = model_lib.init_params(vcfg, gen, dtype=self.dtype,
                                           device=self.device)
            self.engines[level] = Engine(vcfg, params, self.ecfg,
                                         device=self.device)
            self.builds += 1
        return self.engines[level]


def make_prompts(vocab_size: int, batch: int, prompt_len: int, *,
                 seed: int = 0, device=None) -> torch.Tensor:
    """(batch, prompt_len) token ids from a seeded numpy generator, formed
    into one engine batch by the ``BatchScheduler``."""
    rng = np.random.default_rng(seed)
    sched = BatchScheduler(batch_size=batch)
    for _ in range(batch):
        sched.add(rng.integers(1, vocab_size, size=prompt_len, dtype=np.int32))
    return torch.as_tensor(sched.next_batch(), dtype=torch.long).to(
        resolve_device(device))


def run_shares(engines: EnginePool, gn: GatewayNode, request: InferenceRequest,
               *, batch: int = 8, prompt_len: int = 512, decode_steps: int = 16,
               seed: int = 0) -> List[dict]:
    """The Local Node Inference state with real compute: run every share of
    the request's dispatch through the engine of its accuracy level (the
    first engine batch of each share; a real group runs them all). No
    engine is held between shares, so a bounded pool can free it."""
    d = gn.dispatches[-1]
    runs = []
    for a in d.assignments:
        if a.items == 0:
            continue
        eng = engines.engine_for(a.apx_level)
        n = min(a.items, batch)
        toks = make_prompts(eng.cfg.vocab_size, n, prompt_len,
                            seed=seed + 1000 * request.rid + a.apx_level,
                            device=engines.device)
        out = eng.generate(toks, num_steps=decode_steps)
        runs.append({"rid": request.rid, "node": a.node, "level": a.apx_level,
                     "items": a.items, "tokens": out, **eng.last_stats})
        del eng
    return runs


def serve_trace(arch: str = "phi4-mini-3.8b", *, policy: str = "proportional",
                requests: int = 6, disconnect: bool = False, smoke: bool = False,
                device=None, dtype="bfloat16", batch: Optional[int] = None,
                prompt_len: Optional[int] = None,
                decode_steps: Optional[int] = None,
                max_len: Optional[int] = None, seed: int = 0,
                cfg: Optional[ModelConfig] = None,
                max_engines: Optional[int] = None,
                verbose: bool = True) -> dict:
    """Gateway start-up, a request trace (with an optional node disconnect
    in the middle, paper Fig. 9), and real inference for every share.

    ``cfg`` replaces the arch's own config (``arch`` is then ``cfg.name``):
    the gateway's profiling table and variant ladder, and the engines unless
    ``smoke``, are built from it. ``max_engines`` bounds the engines kept
    resident (see :class:`EnginePool`)."""
    device = resolve_device(device)
    batch = batch or (4 if smoke else 8)
    prompt_len = prompt_len or (16 if smoke else 512)
    decode_steps = decode_steps or (4 if smoke else 16)
    max_len = max_len or (64 if smoke else 1024)
    say = print if verbose else (lambda *a, **k: None)

    if cfg is None:
        cfg = get_config(arch)
    arch = cfg.name
    gn = build_gateway(cfg, policy=policy, seq_len=512, seed=seed)
    reqs = demo_requests(gn, requests, seed=seed)
    engines = EnginePool(get_smoke_config(arch) if smoke else cfg,
                         device=device, dtype=dtype, max_len=max_len, seed=seed,
                         max_engines=max_engines)

    say(f"policy={policy} arch={arch} device={device} "
        f"{'smoke' if smoke else 'full-width'} variants")
    say(f"{'rid':>3} {'items':>6} {'perf_req':>10} {'acc_req':>7} "
        f"{'perf':>10} {'acc':>6} {'ok':>5}")
    results, runs, disconnected = [], [], []
    for i, r in enumerate(reqs):
        if disconnect and i == len(reqs) // 2:
            victim = gn.table.nodes[1].name
            gn.handle(Event(kind="disconnect", node=victim))
            disconnected.append(victim)
            say(f"-- node {victim} disconnected --")
        res = gn.handle(Event(kind="workload", request=r))
        results.append(res)
        say(f"{r.rid:3d} {r.num_items:6d} {r.perf_req:10.1f} "
            f"{r.acc_req:7.2f} {res.achieved_perf:10.1f} "
            f"{res.achieved_acc:6.2f} "
            f"{'y' if res.meets_perf and res.meets_acc else 'N':>5}")
        share_runs = run_shares(engines, gn, r, batch=batch,
                                prompt_len=prompt_len,
                                decode_steps=decode_steps, seed=seed)
        runs.extend(share_runs)
        for s in share_runs:
            say(f"     {s['node']}: level {s['level']} {s['items']} items -> "
                f"prefill {s['prefill_ms']:.1f} ms, "
                f"{s['decode_ms_per_step']:.2f} ms/step, "
                f"tokens {s['tokens'][0][:4].tolist()}")
    summary = gn.summary()
    say("summary:", {k: round(v, 4) for k, v in summary.items()})
    return {"gateway": gn, "results": results, "runs": runs,
            "engines": engines.engines, "engine_builds": engines.builds,
            "disconnected": disconnected, "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="phi4-mini-3.8b")
    ap.add_argument("--policy", choices=tuple(registered_policies()),
                    default="proportional")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--smoke", action="store_true",
                    help="run the reduced variant configs instead of full width")
    ap.add_argument("--disconnect", action="store_true",
                    help="disconnect a node mid-trace (paper Fig. 9)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (fails without one); 'cpu' to force the CPU")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--decode-steps", type=int, default=None)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return serve_trace(
        args.arch, policy=args.policy, requests=args.requests,
        disconnect=args.disconnect, smoke=args.smoke, device=args.device,
        dtype=args.dtype, batch=args.batch, prompt_len=args.prompt_len,
        decode_steps=args.decode_steps, max_len=args.max_len, seed=args.seed)


if __name__ == "__main__":
    main()
