"""Layer engine: the engine's prefill time (``last_stats["prefill_ms"]``,
CUDA events) summed over the batches outside the profiled span, over their
prompt tokens, per thousand tokens."""


def read(run):
    bs = [b for b in run.batches if not b["in_span"]]
    tokens = sum(b["n"] * b["plen"] for b in bs)
    return 1e3 * sum(b["prefill_ms"] for b in bs) / tokens if tokens else None
