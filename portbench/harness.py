"""One run of one cell: set-up, the measured window, the check, the line.

The path the window drives is the one users run. A closed loop of one
client: for each request of the mix, the gateway plans it
(``GatewayNode.handle``: DISTRIBUTE and an accuracy level for each node),
every share with items is cut into engine batches of at most
``max_batch``, and each batch runs through ``Engine.generate`` of its
level; all six levels stay resident. The window serves whole passes over
the mix's deck (see ``traffic.py``) and ends with the pass in flight once
``seconds`` have passed; rates divide by the time from its start to the
last batch's return.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``configs/<file>``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``end_to_end/<metric>.py``, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import flops, seeds, traffic, weights
from portbench.reference import ladder
from portbench.reference import module as reference_module

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LEVELS = len(ladder.ALPHAS)
SPAN_FIRST, SPAN_BATCHES = 1, 3      # the profiled batches: early in the window


# ----------------------------------------------------------------------
# The cell, from BENCHMARK.json and the files it names
def load_cell(root: Path, workload: str) -> SimpleNamespace:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = _named(bench["workloads"], workload, "workload")
    cfg_entry = _named(bench["configs"], wl["config"], "config")
    applies = lambda m: "workloads" not in m or workload in m["workloads"]  # noqa: E731
    return SimpleNamespace(
        root=root, name=workload, chips=wl["chips"],
        config=json.loads((root / cfg_entry["file"]).read_text()),
        mix=traffic.load(root / "portbench" / "traffic" / f"{wl['traffic']}.json"),
        limits=json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def model_sizes(config: dict) -> dict:
    """The configuration file's model keys: those the port's ModelConfig has."""
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"name"}
    return {k: v for k, v in config.items() if k in fields}


def port_config(config: dict):
    """The program's configuration: its own for ``port_arch``, with every
    model key of the file set to the file's value."""
    from repro_torch.configs import MoEConfig, get_config
    sizes = model_sizes(config)
    if sizes.get("moe"):
        sizes["moe"] = MoEConfig(**sizes["moe"])
    return get_config(config["port_arch"]).scaled(**sizes)


def reader(root: Path, kind: str, name: str) -> Callable:
    """``read(run)`` of metric ``name`` from ``portbench/<kind>/<name>.py``."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------
# Set-up
def _flat(tree: dict, prefix: str = "") -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def build(cell, seed: int, device) -> SimpleNamespace:
    """The system under test and the weights: the gateway, the deck, and one
    engine a level with the benchmark's weights."""
    from repro_torch.core.variants import VariantPool
    from repro_torch.launch.serve import build_gateway
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = port_config(cell.config)
    sizes = model_sizes(cell.config)
    ref = reference_module(cell.config["reference"])
    ref.check_supported(sizes)
    pool = VariantPool(cfg)
    if len(pool) != LEVELS:
        raise ValueError(f"the program has {len(pool)} levels, the benchmark {LEVELS}")
    max_len = traffic.longest(cell.mix)
    engines, params = {}, {}
    for level in range(LEVELS):
        vcfg = pool[level].config.scaled(dtype="bfloat16")
        lay = ref.layout(ladder.level_sizes(sizes, level))
        prog = _flat(model_lib.abstract_params(vcfg))
        ours = {p: s for p, (s, _) in lay.items()}
        if prog != ours:
            diff = sorted(set(prog.items()) ^ set(ours.items()))
            raise ValueError(f"level {level}: the program's parameters differ from the "
                             f"reference's layout: {diff[:6]}")
        params[level] = weights.make(lay, seed, level, device)
        engines[level] = Engine(vcfg, params[level], EngineConfig(max_len=max_len),
                                device=device)
    gn = build_gateway(cfg, policy=cell.mix["policy"])
    deck = traffic.deck(cell.mix, gn.table.perf[0].sum(), gn.table.perf[-1].sum())
    return SimpleNamespace(cfg=cfg, sizes=sizes, ref=ref, engines=engines, params=params,
                           gn=gn, deck=deck, max_len=max_len,
                           vocab=sizes["vocab_size"])


def plan_shapes(cell, sut) -> set:
    """The (level, batch, prompt length) shapes one pass of the deck runs,
    planned on a gateway of its own."""
    from repro_torch.core.resource_manager import Event
    from repro_torch.launch.serve import build_gateway
    gn = build_gateway(sut.cfg, policy=cell.mix["policy"])
    shapes = set()
    for rid, r in enumerate(sut.deck):
        gn.handle(Event(kind="workload", request=_request(rid, r)))
        for a in gn.dispatches[-1].assignments:
            for n in traffic.batches(a.items, cell.mix["max_batch"]):
                shapes.add((a.apx_level, n, r.prompt_len))
    return shapes


def warm_up(cell, sut, seed: int) -> int:
    """One prefill and one decode step at every shape the window runs."""
    rng = seeds.rng(seed, "prompts", 1)
    shapes = sorted(plan_shapes(cell, sut))
    for level, n, plen in shapes:
        sut.engines[level].generate(rng.integers(1, sut.vocab, size=(n, plen)), num_steps=1)
    return len(shapes)


def _request(rid: int, r: traffic.Request):
    from repro_torch.core.requests import InferenceRequest
    return InferenceRequest(rid=rid, num_items=r.items, perf_req=r.perf_req,
                            acc_req=r.acc_req, seq_len=r.prompt_len)


# ----------------------------------------------------------------------
# The window
def serve(cell, sut, seed: int, seconds: float, *, span=None) -> SimpleNamespace:
    """The closed loop. ``span`` (a ``trace.Span``) profiles batches
    SPAN_FIRST .. SPAN_FIRST + SPAN_BATCHES - 1 and brackets them with the
    port's launch counters; host ranges are opened only in a traced run."""
    from repro_torch.core.resource_manager import Event
    from repro_torch.kernels import decode_attention as k2_mod
    from repro_torch.kernels import flash_attention as k1_mod
    rng_order, rng_prompts = seeds.rng(seed, "order"), seeds.rng(seed, "prompts")
    rf = torch.profiler.record_function if span is not None else (
        lambda name: contextlib.nullcontext())
    max_batch = cell.mix["max_batch"]
    batches, requests, counters = [], [], {}
    rid, span_wall_s = 0, 0.0
    t0 = t_end = time.perf_counter()
    while True:
        for j in rng_order.permutation(len(sut.deck)):
            r = sut.deck[j]
            ts = time.perf_counter()
            with rf("portbench.gateway"):
                sut.gn.handle(Event(kind="workload", request=_request(rid, r)))
            d = sut.gn.dispatches[-1]
            requests.append({"rid": rid, "items": r.items, "gateway_s": time.perf_counter() - ts,
                             "planned": sum(a.items for a in d.assignments),
                             "in_span": span is not None
                             and SPAN_FIRST < len(batches) < SPAN_FIRST + SPAN_BATCHES})
            for a in d.assignments:
                for n in traffic.batches(a.items, max_batch):
                    k = len(batches)
                    if span is not None and k == SPAN_FIRST:
                        t_span = time.perf_counter()
                        counters["before"] = (k1_mod.launches, k2_mod.launches)
                        span.start()
                    with rf("portbench.prompts"):
                        prompts = rng_prompts.integers(1, sut.vocab, size=(n, r.prompt_len))
                    eng = sut.engines[a.apx_level]
                    tb = time.perf_counter()
                    with rf("portbench.generate"):
                        served = eng.generate(prompts, num_steps=r.out_len)
                    t_end = time.perf_counter()
                    batches.append({"rid": rid, "level": a.apx_level, "n": n,
                                    "plen": r.prompt_len, "out": r.out_len,
                                    "host_s": t_end - tb, "prompts": prompts.astype(np.int32),
                                    "served": served, **eng.last_stats,
                                    "in_span": span is not None
                                    and SPAN_FIRST <= k < SPAN_FIRST + SPAN_BATCHES})
                    if span is not None and k == SPAN_FIRST + SPAN_BATCHES - 1:
                        span.stop()
                        counters["after"] = (k1_mod.launches, k2_mod.launches)
                        span_wall_s = time.perf_counter() - t_span
            rid += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return SimpleNamespace(batches=batches, requests=requests, window_s=t_end - t0,
                           span=span.summary() if span is not None else None,
                           span_wall_s=span_wall_s, counters=counters)


# ----------------------------------------------------------------------
# The check
def sample(batches: List[dict], seed: int, min_tokens: int = 0) -> List[int]:
    """Indices of the batches the check compares: one drawn from the seed
    for every level that ran, the longest (prompt plus output; then the most
    items), and further batches in an order drawn from the seed until the
    sample holds ``min_tokens`` served tokens."""
    rng = seeds.rng(seed, "sample")
    picked = {max(range(len(batches)), key=lambda i: (
        batches[i]["plen"] + batches[i]["out"], batches[i]["n"], -i))}
    for level in sorted({b["level"] for b in batches}):
        idx = [i for i, b in enumerate(batches) if b["level"] == level]
        picked.add(idx[int(rng.integers(len(idx)))])
    tokens = sum(batches[i]["n"] * batches[i]["out"] for i in picked)
    for i in rng.permutation(len(batches)).tolist():
        if tokens >= min_tokens:
            break
        if i not in picked:
            picked.add(i)
            tokens += batches[i]["n"] * batches[i]["out"]
    return sorted(picked)


def compare(sut, batch: dict, device, *, control: bool = False, near: float = 0.0) -> dict:
    """The reference over one batch's prompts and served tokens: for every
    served token, the gap by which the reference's logit of it lies below
    the reference's best, and whether it is counted: not where the
    reference's routing of it is unsure for a margin of ``near`` (see
    ``moe`` of the reference). With ``control``, also the gap of the token
    that the reference in float8 puts first at each position."""
    sizes = ladder.level_sizes(sut.sizes, batch["level"])
    plen, out = batch["plen"], batch["out"]
    seq = np.concatenate([batch["prompts"], batch["served"][:, :out - 1]], axis=1)
    toks = torch.as_tensor(seq, dtype=torch.long, device=device)
    positions = range(plen - 1, plen + out - 1)
    logits, info = sut.ref.logits_at(sizes, sut.params[batch["level"]], toks, plen, positions,
                                     near=near)
    best = logits.max(dim=-1).values
    served = torch.as_tensor(batch["served"], dtype=torch.long, device=device)
    gap = best - logits.gather(-1, served[..., None])[..., 0]          # (n, out)
    res = {"token_gap": gap.cpu().numpy(), "counted": (~info["unsure"]).cpu().numpy(),
           "dropped": info["dropped"], "finite": bool(torch.isfinite(logits).all())}
    if control:
        low, _ = sut.ref.logits_at(sizes, sut.params[batch["level"]], toks, plen, positions,
                                   quant="fp8")
        first = low.argmax(dim=-1, keepdim=True)
        res["control_token_gap"] = (best - logits.gather(-1, first)[..., 0]).cpu().numpy()
    return res


def compare_sample(cell, sut, win, seed: int, device, *, control: bool = False) -> List[dict]:
    """``compare`` over each batch that ``sample`` draws for the cell."""
    near = cell.limits.get("route_margin", 0.0)
    return [dict(compare(sut, win.batches[i], device, control=control, near=near),
                 served_finite=win.batches[i]["finite"])
            for i in sample(win.batches, seed, cell.limits.get("sample_tokens", 0))]


def check(cell, win, compared: List[dict], *, judge: str = "token_gap") -> dict:
    """The numbers compared, each with its limit, and the items that failed.
    ``judge`` names the gaps judged: the served tokens' (``token_gap``), or,
    for the control, those of the tokens that the reference in float8 puts
    first at the same positions (``control_token_gap``)."""
    lim = cell.limits
    failed = 0
    cons = [r for r in win.requests if r["planned"] != r["items"]]
    failed += sum(r["items"] for r in cons)
    max_gap, dropped, nonfinite, counted, tokens = 0.0, 0, 0, 0, 0
    for res in compared:
        gap = np.where(res["counted"], res[judge], 0.0)
        max_gap = max(max_gap, float(gap.max()))
        failed += int((gap.max(axis=1) > lim["max_gap"]).sum())
        counted += int(res["counted"].sum())
        tokens += gap.size
        dropped += res["dropped"]
        nonfinite += (not res["finite"]) + (not res["served_finite"])
    checks = {
        "max_gap": {"value": max_gap, "limit": lim["max_gap"]},
        "conservation_errors": {"value": len(cons), "limit": 0},
        "nonfinite_batches": {"value": nonfinite, "limit": 0},
    }
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok and failed == 0, "failed": failed, "checks": checks,
            "sampled": len(compared), "dropped_pairs": dropped,
            "tokens": tokens, "counted": counted}


# ----------------------------------------------------------------------
# One run
def process_start_s() -> float:
    """Seconds since this process started (Linux; else since import)."""
    try:
        import os
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / ticks
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", err=None) -> Optional[dict]:
    """One run; returns the result's line as a dict, or None when the run
    may print no result (a message on ``err``, standard error by default,
    says why)."""
    err = err or sys.stderr
    t_setup0 = time.perf_counter() - process_start_s()
    cell = load_cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return None
    sut = build(cell, seed, dev)
    shapes = warm_up(cell, sut, seed)
    _sync(dev)
    setup_s = time.perf_counter() - t_setup0
    span = None
    if trace and dev.type == "cuda":
        from portbench.trace import Span
        span = Span()
    win = serve(cell, sut, seed, seconds, span=span)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    # the program's state goes before the reference runs; the weights stay
    sut.engines.clear()
    sut.gn = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check(cell, win, compare_sample(cell, sut, win, seed, dev))
    check_s = time.perf_counter() - t_check

    runinfo = SimpleNamespace(
        cell=cell, sizes=sut.sizes, levels=[ladder.level_sizes(sut.sizes, lv)
                                            for lv in range(LEVELS)],
        batches=win.batches, requests=win.requests, window_s=win.window_s,
        setup_s=setup_s, span=win.span, span_wall_s=win.span_wall_s,
        counters=win.counters, max_len=sut.max_len,
        peak=flops.peaks(root, kind) if dev.type == "cuda" else None, device=dev.type)
    entries = cell.per_layer if trace else cell.end_to_end
    kind_dir = "metrics" if trace else "end_to_end"
    metrics = {}
    for m in entries:
        value = reader(root, kind_dir, m["name"])(runinfo)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    host_ms = np.array([b["host_s"] for b in win.batches]) * 1e3
    items = int(sum(b["n"] for b in win.batches))
    print(f"portbench: {workload} seed {seed}: set-up {setup_s:.3f} s ({shapes} shapes warmed), "
          f"window {win.window_s:.3f} s, {len(win.requests)} requests, {len(win.batches)} "
          f"batches, {items} items; batch ms median {np.median(host_ms):.3f} "
          f"p95 {np.percentile(host_ms, 95):.3f} over {len(host_ms)}; check {check_s:.3f} s "
          f"over {verdict['sampled']} batches, {verdict['counted']} of {verdict['tokens']} "
          f"served tokens compared, {verdict['dropped_pairs']} expert pairs dropped by "
          f"capacity", file=err)
    if win.counters:
        _print_counters(runinfo, err)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": cell.chips if dev.type == "cuda" else 0,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": verdict["correct"], "attempted": items,
              "failed": verdict["failed"], "metrics": metrics, "device": device_info}
    if win.span is not None:
        device_info["busy_s"] = win.span["busy_s"]
        device_info["window_s"] = win.span["window_s"]
        result["breakdown"] = {"device_ops": win.span["device_ops"],
                               "idle_gaps": win.span["idle_gaps"]}
    result["checks"] = verdict["checks"]
    for name, c in verdict["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    # the last step: whatever the run loaded, the metric readers included
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of {found} are loaded; the benchmark may load none",
              file=err)
        return None
    return result


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _print_counters(run, err):
    """The port's launch counters over the profiled span beside the
    profiler's kernel records and the calls the span's batches make."""
    from portbench import calls
    (k1a, k2a), (k1b, k2b) = run.counters["before"], run.counters["after"]
    k1_calls, k2_calls = calls.k1(run), calls.k2(run)
    k1_rec = len(calls.kernel_times(run, calls.K1_NAMES))
    k2_rec = len(calls.kernel_times(run, calls.K2_NAMES))
    print(f"portbench: profiled span: K1 {len(k1_calls)} calls, counter {k1b - k1a}, "
          f"profiler {k1_rec}; K2 {len(k2_calls)} calls, counter {k2b - k2a}, "
          f"profiler {k2_rec}", file=err)
    if k1_rec < k1b - k1a or k2_rec < k2b - k2a:
        print("portbench: the profiler lost kernel records in the span", file=err)
