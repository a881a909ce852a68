"""Layer engine: the host's time in the engine's prefill (the upload, the
model's prefill, ``pad_caches``; ``last_stats["prefill_host_ms"]``, less the
upload's wait), the mean over the batches outside the profiled span. Beside
the device's prefill time it says whether prefill waits on the host's
launches. Nothing where the program does not time its phases, and nothing in
a CPU rehearsal."""


def read(run):
    bs = [b for b in run.batches if not b["in_span"]]
    if run.device != "cuda" or not bs or any("prefill_host_ms" not in b for b in bs):
        return None
    return sum(b["prefill_host_ms"] for b in bs) / len(bs)
