"""Model FLOPs of a served batch of an RWKV-6 configuration (rwkv6-1.6b), and
the FLOPs and bytes of one call of K4, the WKV recurrence, from shapes
alone. A product of an (m, k) by a (k, n) matrix is 2 m k n FLOPs.

Per token and layer, in the form the program runs it: the token-shift LoRA
(``maa_w1``, ``maa_w2``), r, k, v, g and the output, the decay LoRA, the
channel mix's key, value and receptance; the recurrence at K4's count, 5
FLOPs per (head, Dk, Dv) element (k^T v, u times it, the sum with the
state, the product with r and its sum, the decayed state: the kernel's
count). The head at the prompt's last position and at each step. Norms,
the token shift's interpolations and the gates' elementwise work are not
counted.

K4 runs in float32 on the FMA pipes: its bound is the larger of its FLOPs
at the H100's fp32 rate and its bytes at ``peaks.json``'s HBM rate.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# NVIDIA H100 Tensor Core GPU data sheet, SXM5: FP32 67 TFLOPS (not tensor
# cores), at the full 700 W power limit
FP32_FLOPS = 67e12
K4_NAMES = ("wkv_kernel",)
DECAY_LORA = 64


def _dims(sizes: dict):
    ssm = sizes["ssm"]
    hd = ssm["wkv_head_dim"]
    return sizes["d_model"], sizes["d_model"] // hd, hd, ssm["token_shift_lora"]


def is_rwkv(sizes: dict) -> bool:
    return bool(sizes.get("ssm")) and sizes["ssm"].get("kind") == "rwkv6"


def layer_flops_per_token(sizes: dict) -> int:
    """One token through one block."""
    d, heads, hd, rank = _dims(sizes)
    time_mix = 2 * (d * 5 * rank + 5 * rank * d + 5 * d * d + 2 * d * DECAY_LORA)
    wkv = 5 * heads * hd * hd
    channel_mix = 2 * (2 * d * sizes["d_ff"] + d * d)
    return time_mix + wkv + channel_mix


def head_flops(sizes: dict) -> int:
    return 2 * sizes["d_model"] * sizes["vocab_size"]


def batch_flops(sizes: dict, n: int, prompt_len: int, out_len: int) -> int:
    """Model FLOPs to serve ``n`` sequences: the prompt's prefill with the
    head at its last position, then ``out_len - 1`` decode steps (the last
    served token comes from the step before, so no step past it counts); a
    recurrent step's work does not grow with the context."""
    per_token = sizes["num_layers"] * layer_flops_per_token(sizes)
    head = head_flops(sizes)
    return n * (prompt_len * per_token + head) + n * (out_len - 1) * (per_token + head)


def k4_call(n: int, s: int, heads: int, dk: int, dv: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K4 call over ``n`` sequences of ``s`` tokens:
    5 FLOPs per (token, head, Dk, Dv) element; r, k, v read in bf16, w read
    and y written in fp32, the final state written in fp32."""
    flops = 5 * n * s * heads * dk * dv
    tokens = n * s * heads
    nbytes = 2 * tokens * (2 * dk + dv) + 4 * tokens * (dk + dv) + 4 * n * heads * dk * dv
    return flops, nbytes


def k4_bound_s(flops: int, nbytes: int, peak: dict) -> float:
    return max(flops / FP32_FLOPS, nbytes / peak["hbm_bytes_per_s"])


def k4_calls(run) -> List[Tuple[int, int]]:
    """(FLOPs, bytes) of every K4 call of the profiled span: one a layer and
    prefill."""
    out = []
    for b in run.batches:
        if b["in_span"]:
            s = run.levels[b["level"]]
            _, heads, hd, _ = _dims(s)
            out += [k4_call(b["n"], b["plen"], heads, hd, hd)] * s["num_layers"]
    return out


def k4_roofline(run, times: List[float]) -> Optional[float]:
    """The K4 calls' bound over K4's device time (``times``, one a record),
    in %. Where the profiler recorded fewer kernels than calls were made,
    the mean bound a call is taken over the calls recorded."""
    costs = k4_calls(run)
    if not costs or not times or run.peak is None:
        return None
    bounds = [k4_bound_s(f, b, run.peak) for f, b in costs]
    n = min(len(times), len(bounds))
    return 100.0 * (sum(bounds) / len(bounds) * n) / sum(times[:n])
