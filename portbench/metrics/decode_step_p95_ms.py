"""Layer engine: the 95th percentile of every decode step's interval on the
device's timeline (``last_stats["step_ms"]``: one CUDA event a step) over the
batches outside the profiled span. Nothing where the program keeps no
per-step intervals, and nothing in a CPU rehearsal, whose intervals are the
host's."""
import numpy as np


def read(run):
    bs = [b for b in run.batches if not b["in_span"]]
    if run.device != "cuda" or not bs or any("step_ms" not in b for b in bs):
        return None
    t = [ms for b in bs for ms in b["step_ms"]]
    return float(np.percentile(t, 95)) if t else None
