#!/usr/bin/env python3
"""Throwaway builds of K1's bf16 D 256 instance (the ``wgmma`` route of
``csrc/flash_attention_sm90.cu``), timed in turns on one NVIDIA H100: what
sets its pace at gemma2-2b's shapes.

    python3 tools/k1_variants.py

Each variant is the committed ``flash_attention_sm90.cu`` with a few exact
text substitutions (each must match exactly once, so a source that has
drifted fails the run instead of timing something else), compiled with the
committed ``flash_attention.cu`` (the C entry) by ``nvcc`` into a library of
its own under ``build/k1_variants/``, and called through the port's wrapper
``flash_attention`` with the wrapper's library swapped for the variant's.
Nothing here is part of the port: the kernels the port runs are built by
``kernels/_build.py`` from the sources as they are.

Variants (``VARIANTS``): the committed kernel (80-row K/V stages, the
consumers taking turns on the tensor cores); without the turns; with
64-row stages (S on ``wgmma`` m64n64k16); with 1 in 4 of the softmax's exps
on the FMA pipe (``sm90::ex2_poly``) instead of the special-function unit;
and, to see what the softmax and the copies cost, with no exp at all, with
no K/V copy after the ring's first stages, and with neither (all three
wrong, not checked).

Shapes: gemma2-2b's prefill cell, q (2, 8, 8192, 256), k/v (2, 4, 8192,
256), causal, soft cap 50 and 0; its train microbatch, q (1, 8, 5120, 256),
soft cap 50. Variants run in turns (v1..vn, then vn..v1, and so on): each
turn takes the median of 7 launches timed by CUDA events, with 256 MB
written before each launch to flush the 50 MB L2, and a variant's figure is
the median of its turns. Each variant that computes attention is held
against ``flash_attention_plain`` at q (1, 16, 333, 256) with k/v of 2
heads, causal, soft cap 50, and at the train shape, at the bf16 tolerance
of ``chip_smoke.py``. The SM clock and power draw are sampled by
``nvidia-smi`` while the committed kernel runs back to back. The last line
of the output is the whole report as one JSON object.
"""
from __future__ import annotations

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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_k  # noqa: E402

SM90 = "flash_attention_sm90.cu"
TOL = 2e-2

_EXP_FULL = "                  const float p = ex2(fmaf(sc[4 * j + e], k, -m_new));"
_EXP_MASKED = ("                  const float p = x > 0.5f * NEG_INF ? ex2(fmaf(x, k, -m_new)) "
               ": 0.f;")
_CAP = "                sc[e] = fmaf(-2.f * cap_l2, rcp(1.f + ex2(sc[e] * c2)), cap_l2);"

_NO_TURNS = [
    ("      if constexpr (R::kInline) bar_sync(kBarTurn + cw, 256);",
     "      if constexpr (false) bar_sync(kBarTurn + cw, 256);"),
    ("      if constexpr (R::kInline) bar_arrive(kBarTurn + 1 - cw, 256);",
     "      if constexpr (false) bar_arrive(kBarTurn + 1 - cw, 256);"),
]
_NO_EXP = [
    (_EXP_FULL, "                  const float p = fmaf(sc[4 * j + e], k, -m_new);"),
    (_EXP_MASKED, "                  const float p = x > 0.5f * NEG_INF ? fmaf(x, k, -m_new) : 0.f;"),
    (_CAP, "                sc[e] = sc[e] * c2;"),
]
# after the ring's first stages, the refill thread completes a stage's full
# barrier without a copy: the stage keeps its old K and V
_NO_COPIES = [("    auto load_tile = [&]() {\n      const int s = lp % L::ST;\n",
               "    auto load_tile = [&]() {\n      const int s = lp % L::ST;\n"
               "      if (lp >= L::ST) { mbar_arrive(&full[s]); ++li; ++lp; return; }\n")]

# name -> (substitutions, held against the plain version)
VARIANTS = {
    "committed": ([], True),
    "no turns": (_NO_TURNS, True),
    "64-row K/V stages": ([("  static constexpr int BN = kInline ? 80 : 128;",
                            "  static constexpr int BN = kInline ? 64 : 128;")], True),
    "1 in 4 softmax exps on the FMA pipe": ([
        (_EXP_FULL, "                  const float y = fmaf(sc[4 * j + e], k, -m_new);\n"
                    "                  const float p = (j & 3) == 3 ? ex2_poly(y) : ex2(y);"),
    ], True),
    "no exp (wrong)": (_NO_EXP, False),
    "no K/V copies after the first stages (wrong)": (_NO_COPIES, False),
    "no K/V copies, no exp (wrong)": (_NO_COPIES + _NO_EXP, False),
}

SHAPES = (("prefill cap 50", 2, 8, 4, 8192, 50.0), ("prefill cap 0", 2, 8, 4, 8192, 0.0),
          ("train cap 50", 1, 8, 4, 5120, 50.0))


def _variant_source(subs):
    text = (_build.CSRC / SM90).read_text()
    for old, new in subs:
        n = text.count(old)
        assert n == 1, f"{SM90}: {old!r} matches {n} times, not once"
        text = text.replace(old, new)
    return text


def build(out_dir):
    """Compiles every variant at once; returns {name: (ctypes function, ptxas
    line of the D 256 kernel)}."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        cu = os.path.join(out_dir, f"v{i}_{SM90}")
        with open(cu, "w") as f:
            f.write(_variant_source(subs))
        so = os.path.join(out_dir, f"v{i}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", so,
               str(_build.CSRC / "flash_attention.cu"), cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        so_out, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{so_out}{se}")
        m = re.search(r"Function properties for \S*flash_fwd_sm90_kernelILi256E\S*\n\s*(.*)\n"
                      r".*?(Used \d+ registers)", so_out + se)
        fn = ctypes.CDLL(so).flash_attention_fwd
        fn.argtypes = fa_k._kernel_fn().argtypes
        fn.restype = ctypes.c_int
        out[name] = (fn, f"{m.group(2)}, {m.group(1)}" if m else "no ptxas line")
    return out


def run(fn, *args, **kw):
    """The port's wrapper with its library's entry swapped for ``fn``."""
    saved = fa_k._fn
    fa_k._fn = fn
    try:
        return fa_k.flash_attention(*args, **kw)
    finally:
        fa_k._fn = saved


def inputs(gen, b, h, kv, s):
    q = torch.randn((b, s, h, 256), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, kv, 256), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def max_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), "non-finite values"
    err = (got - want).abs()
    atol = TOL * min(1.0, want.abs().max().item())
    bad = (err > atol + TOL * want.abs()).sum().item()
    assert bad == 0, f"{bad} elements beyond atol={atol:.3e}, rtol={TOL}"
    return err.max().item()


def time_once(fn, flush, warmup=2, iters=7):
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


def sustained_clock(fn, seconds=2.0):
    """SM clock (MHz) and power draw (W), medians of ``nvidia-smi`` samples
    taken while ``fn`` runs back to back for about ``seconds``."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.time() + seconds
        while time.time() < t_end:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [[float(x) for x in ln.split(",")] for ln in out.splitlines()[1:] if ln.strip()]
    if not rows:
        return None, None
    return statistics.median(r[0] for r in rows), statistics.median(r[1] for r in rows)


def main(rounds=4) -> int:
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    built = build(os.path.join(ROOT, "build", "k1_variants"))
    print(f"built {len(built)} variants in {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(31)
    small = inputs(gen, 1, 16, 2, 333)
    ins = {name: inputs(gen, b, h, kv, s) for name, b, h, kv, s, _ in SHAPES}
    caps = {name: cap for name, *_, cap in SHAPES}
    report = {"card": card, "variants": {}}
    for name, (fn, ptxas) in built.items():
        row = {"ptxas": ptxas, "checked": VARIANTS[name][1]}
        if VARIANTS[name][1]:
            row["max_abs_err"] = max(
                max_err(run(fn, *x, softcap=50.0), fa_k.flash_attention_plain(*x, softcap=50.0))
                for x in (small, ins["train cap 50"]))
        report["variants"][name] = row
        print(f"{name}: {ptxas}" + (f", error {row['max_abs_err']:.3e}" if row["checked"]
                                    else ", not checked"), flush=True)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    names = list(built)
    times = {(n, s): [] for n in names for s, *_ in SHAPES}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            for s, *_ in SHAPES:
                times[(n, s)].append(time_once(
                    lambda: run(built[n][0], *ins[s], softcap=caps[s]), flush))
    for n in names:
        for s, *_ in SHAPES:
            report["variants"][n][f"{s} ms"] = statistics.median(times[(n, s)])
            report["variants"][n][f"{s} turns ms"] = times[(n, s)]
        print(f"{n}: " + ", ".join(f"{s} {report['variants'][n][f'{s} ms']:.4f} ms"
                                   for s, *_ in SHAPES), flush=True)
    x = ins["prefill cap 50"]
    report["committed_clock_mhz"], report["committed_power_w"] = sustained_clock(
        lambda: run(built["committed"][0], *x, softcap=50.0))
    print(f"committed, back to back at the prefill shape: SM clock "
          f"{report['committed_clock_mhz']} MHz, power {report['committed_power_w']} W")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
