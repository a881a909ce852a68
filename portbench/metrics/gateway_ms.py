"""Layer gateway: the harness's host span around each ``GatewayNode.handle``
(DISTRIBUTE and a level for each node), median over the requests outside
the profiled span."""
import numpy as np


def read(run):
    t = [r["gateway_s"] * 1e3 for r in run.requests if not r["in_span"]]
    return float(np.median(t)) if t else None
