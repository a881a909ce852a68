#!/usr/bin/env python3
"""Throwaway builds of K3 (the Mamba selective scan), timed in turns on one
NVIDIA H100: what sets the kernel's pace, and where the redesign's split of
exps between the two pipes should sit.

    python3 tools/k3_variants.py                  # both sets below
    python3 tools/k3_variants.py --set breakdown  # or: split

Each variant is a committed source under ``src/repro_torch/kernels/csrc``
with a few exact text substitutions (each must match exactly once, so a
source that has drifted fails the run instead of timing something else),
compiled by ``nvcc`` into a library of its own under
``build/k3_variants/`` and called through its C entry with ``ctypes`` at
the serving shape of jamba-1.5-large's prefill: u/dt (8, 512, 16384) bf16,
B/C (8, 512, 16) fp32. Nothing here is part of the port: the kernels the
port runs are built by ``kernels/_build.py`` from the sources as they are.

Sets:

* ``breakdown``: the simple route ``ssm_scan.cu`` (the kernel of the
  parent design) as it is (a); its exp replaced by one FMA (b: no exp, the
  result is wrong and not checked); every exp as the FMA-pipe polynomial
  ``sm90::ex2_poly`` (c); the y sum split into 4 partial sums (d); 2 and 4
  of the 16 exps a step as the polynomial; and the register cap of 64 that
  gives 8 blocks an SM.
* ``split``: the TMA route ``ssm_scan_sm90.cu`` at each of ``TMA_CONFIGS``:
  0-6 of its 16 exps a step on the polynomial (``kPolyStates``), the
  register cap of 4, 6 or 8 blocks an SM (``kMinBlocks``), 8 or 16 steps a
  stage (``TS``); with a ring of 2 stages in bf16 instead
  of 3, with each step's exps issued during the step before, and with one y
  sum instead of two; and, to see what each
  costs, without its exps (one FMA each) and with B and C from registers
  instead of shared memory (both wrong, not checked); beside (a). The
  first of ``TMA_CONFIGS`` is the committed kernel.

Each variant's bf16 N 16 kernel is also disassembled (``cuobjdump
-sass``): its instructions by opcode, a static count of the unrolled
step loop's mix.

Variants run in turns (v1..vn, then vn..v1, and so on): each turn takes the
median of 10 launches timed by CUDA events, with 256 MB written before each
launch to flush the 50 MB L2, and a variant's figure is the median of its
turns. One sustained loop a variant is sampled by ``nvidia-smi`` for the SM
clock and the power draw. Each variant that computes the scan is held
against ``ssm_scan_plain`` at the serving shape and at a small shape whose
``dt * a`` reaches about -1000, within the tolerances of ``chip_smoke.py``.
The last line of its output is the whole report as one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_k  # noqa: E402

B, S, DIN, N = 8, 512, 16384, 16
TOL = {torch.bfloat16: 8e-2, torch.float32: 4e-4}   # chip_smoke.py's WKV_TOL
TAG = {torch.bfloat16: "bf16", torch.float32: "fp32"}
SIMPLE, TMA = "ssm_scan.cu", "ssm_scan_sm90.cu"
ENTRY = {SIMPLE: "ssm_scan_fwd", TMA: "ssm_scan_tma_fwd"}

EXP_CALL = "ex2(dtv * a2[n])"
HEADER = '#include "common.cuh"\n'


def _poly_first(k):
    return [(HEADER, HEADER + '#include "sm90.cuh"\n'),
            (EXP_CALL, f"(n < {k} ? sm90::ex2_poly(dtv * a2[n]) : {EXP_CALL})")]


BREAKDOWN = {
    "a parent": (SIMPLE, [], True),
    "b no exp (one FMA)": (SIMPLE, [(EXP_CALL, "fmaf(dtv, a2[n], 1.f)")], False),
    "c all exps on the polynomial": (
        SIMPLE, [(HEADER, HEADER + '#include "sm90.cuh"\n'),
                 (EXP_CALL, "sm90::ex2_poly(dtv * a2[n])")], True),
    "d y sum in 4 partial sums": (SIMPLE, [
        ("float acc = 0.f;", "float acc4[4] = {0.f, 0.f, 0.f, 0.f};"),
        ("acc = fmaf(h[n], cc[c], acc);", "acc4[c] = fmaf(h[n], cc[c], acc4[c]);"),
        ("fmaf(uv, dsk, acc)", "fmaf(uv, dsk, (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]))"),
    ], True),
    "parent, 2 of 16 exps on the polynomial": (SIMPLE, _poly_first(2), True),
    "parent, 4 of 16 exps on the polynomial": (SIMPLE, _poly_first(4), True),
    "parent at 64 registers (8 blocks an SM)": (
        SIMPLE, [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 8)")], True),
}
KNOBS = {"poly": "constexpr int kPolyStates = ", "blocks": "constexpr int kMinBlocks = ",
         "ts": "constexpr int TS = "}
WAIT = "    mbar_wait(&sm.full[s], (k / NS) & 1);\n"
DECAYS = "      float e[NP];\n      decays(dtv, e);\n"
Y_SUMS = ("          if (j & 1) acc1 = fmaf(h[n], cc[j], acc1);\n"
          "          else acc0 = fmaf(h[n], cc[j], acc0);\n")
EXTRAS = {
    # each step's exps issued during the step before (one step ahead)
    "exps a step ahead": [
        (WAIT, WAIT + "    float e_next[NP];\n    decays(to_float(dts[0]), e_next);\n"),
        (DECAYS, "      float e[NP];\n#pragma unroll\n"
                 "      for (int n = 0; n < NP; ++n) e[n] = e_next[n];\n"
                 "      if (i + 1 < TS) decays(to_float(dts[(i + 1) * kThreads]), e_next);\n")],
    "one y sum": [(Y_SUMS, "          acc0 = fmaf(h[n], cc[j], acc0);\n")],
    # a ring of 2 stages in bf16 instead of 3 (28 KB a block instead of 38)
    "2 bf16 stages": [("kStages = sizeof(T) == 2 ? 3 : 2;", "kStages = 2;")],
    # wrong results, not checked: what the exps and the B/C reads cost
    "no exp (one FMA)": [("e[n] = on_poly(n) ? ex2_poly(x) : ex2(x);",
                          "e[n] = fmaf(dtv, a2[n], 1.f);")],
    "B and C from registers": [
        ("const float4 b4 = *reinterpret_cast<const float4*>(&sm.bm[s][i * NP + n4]);",
         "const float4 b4 = make_float4(dsk, uv, du, dtv);"),
        ("const float4 c4 = *reinterpret_cast<const float4*>(&sm.cm[s][i * NP + n4]);",
         "const float4 c4 = make_float4(1.f, 0.5f, 0.25f, 0.125f);")],
}
# (polynomial exps of 16, blocks an SM, steps a stage, extras); the first
# is the committed kernel
TMA_CONFIGS = [
    (1, 4, 16, ()), (0, 4, 16, ()), (2, 4, 16, ()), (3, 4, 16, ()), (4, 4, 16, ()),
    (6, 4, 16, ()), (1, 6, 16, ()), (1, 8, 16, ()), (1, 4, 8, ()),
    (1, 4, 16, ("2 bf16 stages",)), (0, 4, 16, ("exps a step ahead",)),
    (1, 4, 16, ("exps a step ahead",)), (1, 4, 16, ("one y sum",)),
    (1, 4, 16, ("no exp (one FMA)",)), (1, 4, 16, ("B and C from registers",)),
]
UNCHECKED = ("no exp (one FMA)", "B and C from registers")


def _split_set(configs=TMA_CONFIGS):
    """(a), then the TMA route at each of ``configs``."""
    out = {"a parent": (SIMPLE, [], True)}
    src = (_build.CSRC / TMA).read_text()
    lines = {}
    for knob, key in KNOBS.items():
        m = re.search(re.escape(key) + r"(\d+);", src)
        assert m, f"{TMA} has no line '{key}<k>;'"
        lines[knob] = m.group(0)
    for poly, blocks, ts, extras in configs:
        vals = {"poly": poly, "blocks": blocks, "ts": ts}
        subs = [(lines[k], f"{KNOBS[k]}{v};") for k, v in vals.items()
                if lines[k] != f"{KNOBS[k]}{v};"]
        for x in extras:
            subs += EXTRAS[x]
        name = (f"tma, {poly} of 16 exps on the polynomial, register cap for {blocks} "
                f"blocks an SM, TS {ts}" + "".join(f", {x}" for x in extras))
        out[name] = (TMA, subs, not any(x in UNCHECKED for x in extras))
    return out


def _variant_source(src_name, subs):
    text = (_build.CSRC / src_name).read_text()
    for old, new in subs:
        n = text.count(old)
        assert n == 1, f"{src_name}: {old!r} matches {n} times, not once"
        text = text.replace(old, new)
    return text


def build(variants, out_dir):
    """Compiles every variant at once; returns {name: (ctypes function, ptxas
    line of the scan kernels)}."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, (src_name, subs, _)) in enumerate(variants.items()):
        cu = os.path.join(out_dir, f"v{i}_{src_name}")
        with open(cu, "w") as f:
            f.write(_variant_source(src_name, subs))
        so = os.path.join(out_dir, f"v{i}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", so, cu]
        procs[name] = (so, src_name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, src_name, proc) in procs.items():
        so_out, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{so_out}{se}")
        regs = re.findall(r"Function properties for (\S*scan\S*)\n.*?\n.*?Used (\d+) registers",
                          se, re.S)
        spills = re.findall(r"(\d+) bytes spill stores", se)
        sass = _opcode_mix(so)
        fn = getattr(ctypes.CDLL(so), ENTRY[src_name])
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = (fn, f"registers {sorted({int(r) for _, r in regs})}, "
                         f"spill stores {sorted({int(s) for s in spills})} bytes; "
                         f"bf16 N16 kernel SASS {sass}")
    return out


def _opcode_mix(so):
    """Instructions of the bf16, N 16 scan kernel in ``so`` by opcode (the
    most frequent 14), with their total."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    counts, live = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            live = "scan_kernel" in line and "__nv_bfloat16Li16E" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if live and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:14]
    return f"{sum(counts.values())} instructions: " + " ".join(f"{k} {v}" for k, v in top)


def call(fn, ins):
    u, dt, bm, cm, a, d_skip = ins
    b, s, d_in = u.shape
    n = a.shape[1]
    y = torch.empty_like(u)
    h = torch.empty((b, d_in, n), dtype=torch.float32, device=u.device)
    err = fn(u.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), a.data_ptr(),
             d_skip.data_ptr(), y.data_ptr(), h.data_ptr(), b, s, d_in, n,
             1 if u.dtype == torch.bfloat16 else 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed (code {err})")
    return y, h


def inputs(gen, b, s, d_in, n, dtype, extreme=False):
    """As chip_smoke.py draws them; ``extreme``: dt up to ~50 and a down to
    ~-20, so that dt * a * log2(e) reaches about -1000."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u = rn(b, s, d_in).to(dtype)
    if extreme:
        dt = (torch.rand((b, s, d_in), generator=gen, device="cuda") * 50).to(dtype)
        a = -torch.rand((d_in, n), generator=gen, device="cuda") * 20
    else:
        dt = F.softplus(rn(b, s, d_in) * 0.5).to(dtype)
        a = -torch.exp(rn(d_in, n) * 0.3)
    bm, cm = rn(b, s, n), rn(b, s, n)
    return u, dt, bm, cm, a, 1.0 + 0.1 * rn(d_in)


def max_err(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), "non-finite values"
    err = (got - want).abs()
    atol = tol * min(1.0, want.abs().max().item())
    bad = (err > atol + tol * want.abs()).sum().item()
    assert bad == 0, f"{bad} elements beyond atol={atol:.3e}, rtol={tol}"
    return err.max().item()


def time_once(fn, flush, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        flush.zero_()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ts.append(t0.elapsed_time(t1))
    return statistics.median(ts)


def sustained_clock(fn, seconds=1.0):
    """SM clock (MHz) and power draw (W) sampled while ``fn`` runs back to
    back for about ``seconds``: medians of the samples."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.time() + seconds
        while time.time() < t_end:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines()[1:] if ln.strip()]
    if not rows:
        return None, None
    return statistics.median(r[0] for r in rows), statistics.median(r[1] for r in rows)


def run_set(title, variants, rounds, report):
    print(f"== {title}: building {len(variants)} variants", flush=True)
    t0 = time.time()
    built = build(variants, os.path.join(ROOT, "build", "k3_variants", title))
    print(f"   built in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(7)
    serving = {dt: inputs(gen, B, S, DIN, N, dt) for dt in (torch.bfloat16, torch.float32)}
    small = [(dt, inputs(gen, 2, 64, 1024, N, dt, extreme=True))
             for dt in (torch.bfloat16, torch.float32)]
    refs = {dt: ssm_k.ssm_scan_plain(*ins) for dt, ins in serving.items()}
    refs_small = [ssm_k.ssm_scan_plain(*ins) for _, ins in small]
    rows = {}
    for name, (fn, regs) in built.items():
        errs = {}
        if variants[name][2]:
            for dt, ins in serving.items():
                y, h = call(fn, ins)
                torch.cuda.synchronize()
                errs[TAG[dt]] = max(max_err(y, refs[dt][0], TOL[dt]),
                                             max_err(h, refs[dt][1], TOL[dt]))
            for (dt, ins), (ry, rh) in zip(small, refs_small):
                y, h = call(fn, ins)
                torch.cuda.synchronize()
                errs[f"extreme {TAG[dt]}"] = max(max_err(y, ry, TOL[dt]),
                                                     max_err(h, rh, TOL[dt]))
        rows[name] = {"ptxas": regs, "max_abs_err": errs, "bf16_ms": [], "fp32_ms": []}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    names = list(built)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn = built[name][0]
            for dt in (torch.bfloat16, torch.float32):
                rows[name][f"{TAG[dt]}_ms"].append(
                    time_once(lambda: call(fn, serving[dt]), flush))
    for name in names:
        row = rows[name]
        clk, watts = sustained_clock(lambda: call(built[name][0], serving[torch.bfloat16]))
        row["sustained_sm_mhz"], row["sustained_power_w"] = clk, watts
        for k in ("bf16_ms", "fp32_ms"):
            row[k.replace("_ms", "_median_ms")] = statistics.median(row[k])
        print(f"  {name:45s} bf16 {row['bf16_median_ms']:.4f} ms "
              f"(turns {', '.join(f'{t:.4f}' for t in row['bf16_ms'])}), fp32 "
              f"{row['fp32_median_ms']:.4f} ms; {row['ptxas']}; SM {clk} MHz, {watts} W; "
              f"err {', '.join(f'{k} {v:.2e}' for k, v in row['max_abs_err'].items()) or '-'}",
              flush=True)
    report[title] = rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", choices=("all", "breakdown", "split"), default="all")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print("card:", card)
    report = {"card": card, "shape": f"u/dt({B},{S},{DIN}) bf16 and fp32, N {N}"}
    if args.set in ("all", "breakdown"):
        run_set("breakdown", BREAKDOWN, args.rounds, report)
    if args.set in ("all", "split"):
        run_set("split", _split_set(), args.rounds, report)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
