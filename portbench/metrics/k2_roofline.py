"""Layer kernels: K2 (decode attention) in the profiled span: the bound of
its calls (bytes over the valid slots only) over its device time."""
from portbench import calls


def read(run):
    return calls.roofline(run, calls.k2(run), calls.K2_NAMES)
