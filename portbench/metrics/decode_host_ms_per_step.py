"""Layer engine: the host's time in the engine's decode loop
(``last_stats["decode_host_ms"]``, less the waits of the host syncs counted
inside it) summed over the batches outside the profiled span, over their
decode steps: the time the host takes to launch a step. Nothing where the
program does not time its phases, and nothing in a CPU rehearsal."""


def read(run):
    bs = [b for b in run.batches if not b["in_span"]]
    if run.device != "cuda" or not bs or any("decode_host_ms" not in b for b in bs):
        return None
    steps = sum(b["out"] for b in bs)
    return sum(b["decode_host_ms"] for b in bs) / steps if steps else None
