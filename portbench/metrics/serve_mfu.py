"""Layer model step: the model FLOPs of the batches outside the profiled span
(``flops.batch_flops``, from each level's shapes) over the window's time
outside the span (from the profiler's start to its stop), as a share of the
chip's bf16 peak."""
from portbench import flops


def read(run):
    if run.peak is None or run.span is None:
        return None
    bs = [b for b in run.batches if not b["in_span"]]
    work = sum(flops.batch_flops(run.levels[b["level"]], b["n"], b["plen"], b["out"])
               for b in bs)
    elapsed = run.window_s - run.span_wall_s
    return 100.0 * work / (elapsed * run.peak["bf16_flops"])
