"""Helpers shared by the parity tests of the port's host-side stack
(simulator, control plane, sharded control plane, dispatch shim): the same
inputs go through the JAX package and the port, and what comes out is
compared in a canonical, package-independent form."""
import dataclasses
import importlib
import types
from collections.abc import Mapping

import numpy as np

from repro.roofline.analysis import HBM_BW, PEAK_FLOPS
from repro_torch.core.profiling import HardwareSpec

# the per-chip peaks every golden pin of the JAX package was computed with
REF_HW = HardwareSpec(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW)
PACKAGES = ("repro", "repro_torch")


def canon(x):
    """A comparable form of a result: dataclasses by class and field name,
    mappings sorted by key, floats as their shortest round-trip repr."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, Mapping):
        return tuple(sorted((str(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    if isinstance(x, np.integer):
        return int(x)
    return x


def pkg(name: str) -> types.SimpleNamespace:
    """The host-side modules of one package under common names."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name,
        configs=mod("configs"), admission=mod("control.admission"),
        autoscaler=mod("control.autoscaler"),
        fairshare=mod("control.fairshare"), cluster=mod("core.cluster"),
        dispatch=mod("core.dispatch"), profiling=mod("core.profiling"),
        requests=mod("core.requests"), sched=mod("sched"),
        shard=mod("sched.shard"))


def table(ns, nodes=None, *, measured=None, seq_len=512):
    """A ProfilingTable of phi4-mini-3.8b in package ``ns``: the port's is
    built over the JAX package's peaks so that both tables agree."""
    pool = ns.profiling.VariantPool(ns.configs.get_config("phi4-mini-3.8b"))
    nodes = nodes if nodes is not None else ns.cluster.cluster_nodes(2)
    kw = {"hw": REF_HW} if ns.name == "repro_torch" else {}
    return ns.profiling.ProfilingTable(pool, nodes, seq_len=seq_len,
                                       measured=measured, **kw)
