"""Layer engine: the 95th percentile of the host time of ``Engine.generate``
over the batches outside the profiled span, in the decode-heavy cells. One
pass of phi4-mini's ``gen`` holds 62 batches, too few for a 95th percentile
with ten samples beyond it, and the host-bound cells' runs spread too widely
for the end-to-end bound that ``batch_p95_ms`` keeps for ``score``."""
import numpy as np


def read(run):
    t = [b["host_s"] * 1e3 for b in run.batches if not b["in_span"]]
    return float(np.percentile(t, 95)) if t else None
