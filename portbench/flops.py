"""The benchmark's own arithmetic: model FLOPs of a served batch, and the
FLOPs and bytes of one call of each attention kernel, from shapes alone.

A product of an (m, k) by a (k, n) matrix is 2 m k n FLOPs. Kernel bytes
count each input read once and each output written once, in the call's
types (bf16 2 bytes, fp32 lse 4, the bool mask 1).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional


def peaks(root: Path, kind: str) -> dict:
    """The published peaks of device ``kind`` from ``peaks.json``."""
    table = json.loads((Path(root) / "portbench" / "peaks.json").read_text())["devices"]
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in portbench/peaks.json")
    return table[kind]


def causal_pairs(s: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal (windowed) attention over s positions scores."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def linear_flops_per_token(sizes: dict) -> int:
    """Products with weights for one token through every layer (no head)."""
    d, h, kv, hd = sizes["d_model"], sizes["num_heads"], sizes["num_kv_heads"], sizes["head_dim"]
    attn = 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d
    moe = sizes.get("moe")
    if moe:
        e, k, f = moe["num_experts"], moe["top_k"], moe["d_ff_expert"]
        mlp = 2 * d * e + k * 3 * 2 * d * f
    else:
        mlp = 3 * 2 * d * sizes["d_ff"]
    return sizes["num_layers"] * (attn + mlp)


def head_flops(sizes: dict) -> int:
    """The LM head for one position."""
    return 2 * sizes["d_model"] * sizes["vocab_size"]


def _window(sizes: dict) -> Optional[int]:
    return sizes["sliding_window"] if sizes["attention_kind"] == "sliding" else None


def batch_flops(sizes: dict, n: int, prompt_len: int, out_len: int) -> int:
    """Model FLOPs to serve ``n`` sequences: the prompt's prefill with the
    head at its last position, then ``out_len - 1`` decode steps, each one
    token attending to every earlier one; the last served token comes from
    the step before, so no step past it counts."""
    lin, head = linear_flops_per_token(sizes), head_flops(sizes)
    per_pair = 4 * sizes["num_heads"] * sizes["head_dim"] * sizes["num_layers"]
    w = _window(sizes)
    total = n * (prompt_len * lin + head + per_pair * causal_pairs(prompt_len, w))
    for i in range(out_len - 1):
        ctx = prompt_len + i + 1
        total += n * (lin + head + per_pair * (ctx if w is None else min(ctx, w)))
    return total


def k1_call(n: int, h: int, kv: int, s: int, hd: int,
            window: Optional[int] = None) -> tuple:
    """(FLOPs, bytes) of one causal flash-attention forward call on bf16
    q (n, h, s, hd), k/v (n, kv, s, hd): q.k and p.v over the pairs scored;
    q, k, v read, out written, and the fp32 log-sum-exp written."""
    flops = 4 * n * h * hd * causal_pairs(s, window)
    nbytes = 2 * (2 * n * h * s * hd + 2 * n * kv * s * hd) + 4 * n * h * s
    return flops, nbytes


def k2_call(n: int, h: int, kv: int, hd: int, valid: int, slots: int) -> tuple:
    """(FLOPs, bytes) of one decode-attention call: ``n`` rows of one query
    token each on bf16 caches of ``slots`` slots, ``valid`` of them valid in
    every row: q.k and p.v over the valid slots; q read, out written, the
    valid K and V slots read, and the bool mask (n, slots) read."""
    flops = 4 * n * h * hd * valid
    nbytes = 2 * (2 * n * h * hd + 2 * n * kv * valid * hd) + n * slots
    return flops, nbytes


def bound_s(flops: int, nbytes: int, peak: dict) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])
