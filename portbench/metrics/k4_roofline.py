"""Layer kernels: K4 (the RWKV-6 WKV recurrence) in the profiled span: the
bound of its calls (one a layer and prefill, from the batches' shapes: the
larger of FLOPs over the fp32 peak and bytes over the HBM bandwidth,
``flops_rwkv``) over its device time, by the kernel's name. Nothing for a
configuration without RWKV layers."""
from portbench import calls, flops_rwkv


def read(run):
    if not flops_rwkv.is_rwkv(run.sizes):
        return None
    return flops_rwkv.k4_roofline(run, calls.kernel_times(run, flops_rwkv.K4_NAMES))
