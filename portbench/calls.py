"""The attention kernels' calls in the profiled span, from the batches'
shapes, and their device records, by kernel name."""
from __future__ import annotations

from typing import List, Optional, Tuple

from portbench import flops

K1_NAMES = ("flash_fwd_sm90_kernel", "flash_fwd_mma_kernel", "flash_fwd_kernel")
K2_NAMES = ("decode_mma_kernel", "decode_fma_kernel")


def _window(sizes: dict) -> Optional[int]:
    return sizes["sliding_window"] if sizes["attention_kind"] == "sliding" else None


def k1(run) -> List[Tuple[int, int]]:
    """(FLOPs, bytes) of every K1 call of the span: one a layer and prefill."""
    out = []
    for b in run.batches:
        if b["in_span"]:
            s = run.levels[b["level"]]
            cost = flops.k1_call(b["n"], s["num_heads"], s["num_kv_heads"], b["plen"],
                                 s["head_dim"], _window(s))
            out += [cost] * s["num_layers"]
    return out


def k2(run) -> List[Tuple[int, int]]:
    """(FLOPs, bytes) of every K2 call of the span: one a layer and decode
    step; step i of a batch reads plen + i + 1 valid slots of the cache."""
    out = []
    for b in run.batches:
        if b["in_span"]:
            s = run.levels[b["level"]]
            w = _window(s)
            slots = run.max_len if w is None else min(run.max_len, w)
            for i in range(b["out"]):
                valid = min(b["plen"] + i + 1, slots)
                cost = flops.k2_call(b["n"], s["num_heads"], s["num_kv_heads"],
                                     s["head_dim"], valid, slots)
                out += [cost] * s["num_layers"]
    return out


def kernel_times(run, names) -> List[float]:
    """Seconds of each device record of the span whose name holds one of ``names``."""
    if run.span is None:
        return []
    return [dt for name, dt in run.span["kernels"] if any(n in name for n in names)]


def roofline(run, costs, names) -> Optional[float]:
    """The calls' bound over the kernels' device time, in %. Where the
    profiler recorded fewer kernels than calls were made, the mean bound a
    call is taken over the calls recorded."""
    times = kernel_times(run, names)
    if not costs or not times or run.peak is None:
        return None
    bounds = [flops.bound_s(f, b, run.peak) for f, b in costs]
    n = min(len(times), len(bounds))
    return 100.0 * (sum(bounds) / len(bounds) * n) / sum(times[:n])
