"""Layer engine: the share of decode steps replayed from a CUDA graph
(``last_stats["graph_steps"]``) among all decode steps of every batch of the
window, in %. A count does not change under the profiler, so the span's
batches count too. Nothing in a CPU rehearsal, and nothing where the
program's batches carry no ``graph_steps``."""


def read(run):
    bs = run.batches
    if run.device != "cuda" or not bs or any("graph_steps" not in b for b in bs):
        return None
    steps = sum(b["out"] for b in bs)
    return 100.0 * sum(b["graph_steps"] for b in bs) / steps if steps else None
