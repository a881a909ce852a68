"""Layer kernels: K1 (flash attention forward) in the profiled span: the
bound of its calls (the larger of FLOPs over the bf16 peak and bytes over
the HBM bandwidth, from the calls' shapes) over its device time."""
from portbench import calls


def read(run):
    return calls.roofline(run, calls.k1(run), calls.K1_NAMES)
