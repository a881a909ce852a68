#!/usr/bin/env python3
"""K2 (decode attention) and K5 (flash-attention backward) of one checkout of
the port, timed on one NVIDIA H100 at the shapes where they lose the most
time, so that two checkouts can be compared in one call, in turns:

    python3 tools/time_k2_k5.py --src parent/src --label parent   # a checkout's src
    python3 tools/time_k2_k5.py --label change                    # this one's

``--src`` names the ``src`` directory whose ``repro_torch`` is imported; its
kernels are built into that checkout's own ``build/`` (``kernels/_build``).
The inputs come from a fixed seed, so every run times the same values. Each
shape is held against the kernel's plain version at the bf16 tolerance, and
timed as ``chip_smoke.py`` times it (CUDA events, L2 flushed before each
launch, median), beside SDPA and the bound:

* K2 at qwen3-32b's decode, q (8, 8, 8, 128) over 32768 slots, every slot
  valid; and over 1024 slots with 520 valid a row: qwen3-32b (G 8), phi4
  (G 3), musicgen (D 64, G 1), gemma2-2b (D 256, G 2, soft cap 50). SDPA
  with ``attn_mask`` (no soft cap). The bound: the valid slots' K and V, q
  and out, and the mask, at 3.35 TB/s;
* K5 at gemma2-2b's train microbatch, q/dout (1, 8, 4096, 256), k/v (1, 4,
  4096, 256) bf16, causal, soft cap 50, delta from the forward's output
  inside the call; the SDPA backward alone without the soft cap. The bound:
  the function's 5 products at 989 TFLOP/s.

``--sweep`` first times K2 at qwen3-32b's decode over 32768 slots at each
number of splits 1-8 (and the four served shapes over 1024 slots at 1, 2, 4
and 8), with 64 valid slots of the 32768 (the mask scan alone, nearly), at G 1
and D 64 beside
G 8 and D 128, and with the caches laid out head-major, (B, KV, S, D) read
through a transposed view, where each (batch, kv head) reads one contiguous
run of rows: what sets the kernel's pace at long rows.

One JSON line a run, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BW, PEAK_BF16 = 3.35e12, 989e12
TOL = 2e-2


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


def time_decode(dec_k, gen, flush, b, kv, g, s, d, n_valid, cap, splits=None,
                head_major=False, sdpa=True):
    import torch
    import torch.nn.functional as F

    dev, bf = "cuda", torch.bfloat16
    q = torch.randn((b, kv, g, d), generator=gen, device=dev).to(bf)
    if head_major:
        k, v = (torch.randn((b, kv, s, d), generator=gen, device=dev).to(bf).transpose(1, 2)
                for _ in range(2))
    else:
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(bf) for _ in range(2))
    mask = torch.arange(s, device=dev)[None, :] < torch.full((b, 1), n_valid, device=dev)
    fn = lambda: dec_k.decode_attention(q, k, v, mask, softcap=cap, splits=splits)  # noqa: E731
    err = _check(fn(), dec_k.decode_attention_plain(q, k, v, mask, softcap=cap))
    ms = _timer(fn, flush)
    nbytes = 2 * b * n_valid * kv * d * 2 + 2 * b * kv * g * d * 2 + b * s
    if not sdpa:
        return {"kernel": "decode_attention",
                "shape": f"q({b},{kv},{g},{d}) kv({b},{s},{kv},{d}) bf16 cap {cap:g}, "
                         f"{n_valid} valid slots a row, splits {splits or 'rule'}"
                         + (", head-major caches" if head_major else ""),
                "ms": ms, "bound_ms": nbytes / HBM_BW * 1e3, "bound_by": "bytes",
                "max_abs_err": err}
    ql, kl, vl = q.reshape(b, kv * g, 1, d), k.transpose(1, 2), v.transpose(1, 2)
    am = mask[:, None, None, :]
    try:
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am, enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am,  # noqa: E731
                                                     enable_gqa=True)
    except (TypeError, RuntimeError):
        ke, ve = (t.repeat_interleave(g, dim=1) for t in (kl, vl))
        lib = lambda: F.scaled_dot_product_attention(ql, ke, ve, attn_mask=am)  # noqa: E731
    sdpa_ms = _timer(lib, flush)
    return {"kernel": "decode_attention",
            "shape": f"q({b},{kv},{g},{d}) kv({b},{s},{kv},{d}) bf16 cap {cap:g}, "
                     f"{n_valid} valid slots a row",
            "ms": ms, "sdpa_attn_mask_ms": sdpa_ms, "bound_ms": nbytes / HBM_BW * 1e3,
            "bound_by": "bytes", "max_abs_err": err}


def time_bwd(fa_k, fab_k, gen, flush):
    import torch
    import torch.nn.functional as F

    dev, bf = "cuda", torch.bfloat16
    b, h, kv, s, d, cap = 1, 8, 4, 4096, 256, 50.0
    q, dout = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf).transpose(1, 2)
               for _ in range(2))
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(bf).transpose(1, 2)
            for _ in range(2))
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, softcap=cap)
    delta = fab_k.delta_of(dout, out)
    fn = lambda: fab_k.flash_attention_bwd(q, k, v, dout, lse, out=out, softcap=cap)  # noqa: E731
    want = fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta, softcap=cap)
    err = max(_check(x, y) for x, y in zip(fn(), want))
    del want
    ms = _timer(fn, flush, iters=7)
    plain_ms = _timer(lambda: fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                              softcap=cap),
                      flush, warmup=1, iters=3)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    try:
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    except TypeError:
        kg, vg = (t.repeat_interleave(h // kv, dim=1).detach().requires_grad_(True)
                  for t in (k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_ms = _timer(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True),
                     flush, iters=7)
    pairs = h * s * (s + 1) // 2
    return {"kernel": "flash_attention_bwd",
            "shape": f"q/dout({b},{h},{s},{d}) kv({b},{kv},{s},{d}) bf16 causal cap {cap:g}, "
                     f"delta from out",
            "route": fab_k.route(bf, d), "ms": ms, "plain_ms": plain_ms,
            "sdpa_backward_no_cap_ms": sdpa_ms,
            "bound_ms": 5 * 2 * d * pairs / PEAK_BF16 * 1e3, "bound_by": "operations",
            "max_abs_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"),
                    help="the src directory of the checkout to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", action="store_true", help="K2's splits / layout sweep first")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("time_k2_k5: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import flash_attention_bwd as fab_k

    _build.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(23)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    if args.sweep:
        rows = [time_decode(dec_k, gen, flush, 8, 8, 8, 32768, 128, 32768, 0.0, splits=n,
                            sdpa=False) for n in range(1, 9)]
        rows += [time_decode(dec_k, gen, flush, 8, 8, 8, 32768, 128, 32768, 0.0, splits=n,
                             head_major=True, sdpa=False) for n in (4, 8)]
        # 64 valid of 32768 slots: little more than the blocks' scan of the mask
        rows += [time_decode(dec_k, gen, flush, 8, 8, 8, 32768, 128, 64, 0.0, sdpa=False),
                 time_decode(dec_k, gen, flush, 8, 8, 1, 32768, 128, 32768, 0.0, sdpa=False),
                 time_decode(dec_k, gen, flush, 8, 8, 8, 32768, 64, 32768, 0.0, sdpa=False)]
        rows += [time_decode(dec_k, gen, flush, 8, kv, g, 1024, d, 520, cap, splits=n, sdpa=False)
                 for kv, g, d, cap in ((8, 8, 128, 0.0), (8, 3, 128, 0.0), (24, 1, 64, 0.0),
                                       (4, 2, 256, 50.0))
                 for n in (1, 2, 4, 8)]
    else:
        rows = []
    rows += [time_decode(dec_k, gen, flush, 8, 8, 8, 32768, 128, 32768, 0.0),
            time_decode(dec_k, gen, flush, 8, 8, 8, 1024, 128, 520, 0.0),
            time_decode(dec_k, gen, flush, 8, 8, 3, 1024, 128, 520, 0.0),
            time_decode(dec_k, gen, flush, 8, 24, 1, 1024, 64, 520, 0.0),
            time_decode(dec_k, gen, flush, 8, 4, 2, 1024, 256, 520, 50.0),
            time_bwd(fa_k, fab_k, gen, flush)]
    for r in rows:
        print(f"{args.label}: {r['kernel']} at {r['shape']}: {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms, err {r['max_abs_err']:.3e}", flush=True)
    print(json.dumps({"label": args.label, "src": os.path.abspath(args.src), "card": card,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
