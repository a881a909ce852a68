"""The 95th percentile, over every engine batch of the window, of the host
time from the call to ``Engine.generate`` to its return with the tokens on
the host."""
import numpy as np


def read(run):
    return float(np.percentile([b["host_s"] * 1e3 for b in run.batches], 95))
