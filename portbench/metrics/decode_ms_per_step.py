"""Layer engine: the engine's decode time (``last_stats["decode_ms_per_step"]``
x steps, CUDA events) summed over the batches outside the profiled span,
over their decode steps."""


def read(run):
    bs = [b for b in run.batches if not b["in_span"]]
    steps = sum(b["out"] for b in bs)
    return sum(b["decode_ms_per_step"] * b["out"] for b in bs) / steps if steps else None
