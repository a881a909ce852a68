#!/usr/bin/env python3
"""K1 (flash attention, the prefill forward) of one checkout of the port,
timed on one NVIDIA H100 at head dim 256, gemma2-2b's, where it loses the most
time, so that two checkouts can be compared in one call, in turns:

    python3 tools/time_k1.py --src parent/src --label parent   # a checkout's src
    python3 tools/time_k1.py --label change                    # this one's

``--src`` names the ``src`` directory whose ``repro_torch`` is imported; its
kernels are built into that checkout's own ``build/`` (``kernels/_build``),
and the registers and spill bytes ptxas reported for its K1 kernels are
printed. The inputs come from a fixed seed, so every run times the same
values, laid out as the model hands them over (transposed views of (B, S, H,
D) tensors). Each shape is held against the kernel's plain version at the
bf16 tolerance, out and lse, and timed as ``chip_smoke.py`` times it (CUDA
events, L2 flushed before each launch, median), beside the bound: the
visible pairs' two products at 989 TFLOP/s or q, k, v and out at 3.35 TB/s,
whichever is longer. bf16, causal, soft cap 50 unless said:

* gemma2-2b's prefill cell, q (2, 8, 8192, 256), k/v (2, 4, 8192, 256),
  global and with its 4096 window;
* its train microbatch, q (1, 8, 5120, 256), k/v (1, 4, 5120, 256), global
  and with the window;
* its served prefill, q (8, 8, 512, 256), k/v (8, 4, 512, 256);
* phi4-mini's served prefill at D 128, q (8, 24, 512, 128), k/v (8, 8, 512,
  128), no soft cap: the D 128 instance, for the record.

At each global shape K1 is timed at soft cap 0 too, beside
``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``, which
has no soft cap: the like-for-like comparison with the library.

One JSON line a run, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BW, PEAK_BF16 = 3.35e12, 989e12
TOL = 2e-2

# name, b, h, kv, s, d, window, softcap
SHAPES = (
    ("gemma2-2b prefill", 2, 8, 4, 8192, 256, None, 50.0),
    ("gemma2-2b prefill, window", 2, 8, 4, 8192, 256, 4096, 50.0),
    ("gemma2-2b train", 1, 8, 4, 5120, 256, None, 50.0),
    ("gemma2-2b train, window", 1, 8, 4, 5120, 256, 4096, 50.0),
    ("gemma2-2b served", 8, 8, 4, 512, 256, None, 50.0),
    ("phi4-mini served", 8, 24, 8, 512, 128, None, 0.0),
)


def _check(got, want):
    """Max abs error after holding every element to ``atol + TOL * |want|``
    (``atol`` scaled by the largest reference value below 1), as
    ``chip_smoke._check``."""
    import torch

    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    atol = TOL * min(1.0, want.abs().max().item())
    assert not (err > atol + TOL * want.abs()).any(), err.max().item()
    return err.max().item()


def _timer(fn, flush, warmup=3, iters=15):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def visible_pairs(s, window):
    """(row, column) pairs a causal row of ``s`` sees, summed over the rows."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def time_shape(fa_k, gen, flush, name, b, h, kv, s, d, window, cap):
    import torch
    import torch.nn.functional as F

    dev, bf = "cuda", torch.bfloat16
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf).transpose(1, 2)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(bf).transpose(1, 2)
            for _ in range(2))
    kw = dict(window=window, softcap=cap)
    out, lse = fa_k.flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    err = max(_check(out, want), _check(lse, want_lse))
    del out, lse, want, want_lse
    iters = 7 if s > 4096 else 15 if s > 512 else 41   # a short launch varies more
    before = fa_k.launches
    ms = _timer(lambda: fa_k.flash_attention(q, k, v, **kw), flush, iters=iters)
    assert fa_k.launches > before
    flops = 4 * d * b * h * visible_pairs(s, window)
    nbytes = (2 * b * h * s * d + 2 * b * kv * s * d) * 2
    t_f, t_b = flops / PEAK_BF16 * 1e3, nbytes / HBM_BW * 1e3
    row = {"kernel": "flash_attention", "name": name,
           "shape": f"q({b},{h},{s},{d}) kv({b},{kv},{s},{d}) bf16 causal cap {cap:g}"
                    + (f" window {window}" if window else ""),
           "route": fa_k.route(bf, d), "ms": ms, "bound_ms": max(t_f, t_b),
           "bound_by": "operations" if t_f >= t_b else "bytes", "max_abs_err": err}
    if window is None:
        if cap > 0:
            fn0 = lambda: fa_k.flash_attention(q, k, v)  # noqa: E731
            row["max_abs_err_cap0"] = _check(fn0(), fa_k.flash_attention_plain(q, k, v))
            row["ms_cap0"] = _timer(fn0, flush, iters=iters)
        try:
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                         enable_gqa=True)
        except TypeError:
            ke, ve = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
            lib = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
        row["sdpa_no_cap_ms"] = _timer(lib, flush, iters=iters)
    return row


def ptxas_k1(build_log: str):
    """Registers and spill bytes ptxas reported for each K1 kernel."""
    return [{"kernel": fn, "registers": int(nreg), "spill_stores": int(st),
             "spill_loads": int(ld)}
            for fn, st, ld, nreg in re.findall(
                r"Function properties for (\S*flash_fwd\S*_kernel\S*)\n\s*\d+ bytes stack "
                r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) "
                r"registers", build_log)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"),
                    help="the src directory of the checkout to time")
    ap.add_argument("--label", default="change")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_k1: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa_k

    _build.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    ptxas = ptxas_k1(_build.build_log())
    for p in ptxas:
        print(f"{args.label}: ptxas {p['kernel']}: {p['registers']} registers, "
              f"{p['spill_stores']} / {p['spill_loads']} bytes spill stores / loads", flush=True)
    for line in sorted(set(re.findall(r"^.*wgmma.*$", _build.build_log(), re.M))):
        print(f"{args.label}: ptxas: {line.strip()[:200]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(29)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    rows = []
    for shape in SHAPES:
        r = time_shape(fa_k, gen, flush, *shape)
        rows.append(r)
        extra = "".join(f", {k} {r[k]:.4f} ms" for k in ("ms_cap0", "sdpa_no_cap_ms") if k in r)
        print(f"{args.label}: K1 {r['name']} at {r['shape']}, route {r['route']}: "
              f"{r['ms']:.4f} ms{extra}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"err {r['max_abs_err']:.3e}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "src": os.path.abspath(args.src), "card": card,
                      "ptxas": ptxas, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
