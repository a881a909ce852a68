"""Layer model step: the model FLOPs of the batches outside the profiled span
(``flops_rwkv.batch_flops``, from each level's shapes: the projections and
LoRAs, the recurrence at K4's count and the head) over the window's time
outside the span, as a share of the chip's bf16 peak. Nothing for a
configuration without RWKV layers."""
from portbench import flops_rwkv


def read(run):
    if run.peak is None or run.span is None or not flops_rwkv.is_rwkv(run.sizes):
        return None
    bs = [b for b in run.batches if not b["in_span"]]
    work = sum(flops_rwkv.batch_flops(run.levels[b["level"]], b["n"], b["plen"], b["out"])
               for b in bs)
    elapsed = run.window_s - run.span_wall_s
    return 100.0 * work / (elapsed * run.peak["bf16_flops"])
