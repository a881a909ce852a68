"""Turns the JAX package's parameter pytree into the port's.

The port keeps the tree shape and the names, so the conversion is a tree map
(``numpy`` leaf -> tensor) plus a dtype cast, checked leaf by leaf against the
port's own parameter specs: attention (GQA, and MLA's ``w_dq`` ... ``w_uv``),
dense MLP, Mamba (``mamba/w_in`` ... ``a_log``, ``d_skip``), MoE
(``moe/w_router``, the stacked ``we_*`` experts, shared ``ws_*``) and RWKV
leaves alike, and deepseek's unstacked ``mtp`` subtree. The caller passes a tree of numpy
arrays (each JAX leaf through ``np.asarray``); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import ParamSpec, resolve_device, resolve_dtype


def _convert(specs: Dict[str, Any], tree: Dict[str, Any], path: str,
             stack, device, dtype) -> Dict[str, Any]:
    if not isinstance(tree, dict):
        raise TypeError(f"{path or '<root>'}: expected a dict, got {type(tree).__name__}")
    missing = sorted(set(specs) - set(tree))
    extra = sorted(set(tree) - set(specs))
    if missing or extra:
        raise KeyError(f"{path or '<root>'}: missing keys {missing}, extra keys {extra}")
    out = {}
    for name, spec in specs.items():
        where = f"{path}/{name}" if path else name
        if isinstance(spec, ParamSpec):
            arr = np.asarray(tree[name])
            want = tuple(spec.shape) if stack is None else (stack,) + tuple(spec.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{where}: shape {tuple(arr.shape)}, expected {want}")
            if arr.dtype.kind not in "fiu":   # e.g. ml_dtypes bfloat16
                arr = arr.astype(np.float32)
            out[name] = torch.tensor(arr).to(device=device, dtype=dtype)
        else:
            out[name] = _convert(spec, tree[name], where, stack, device, dtype)
    return out


def params_from_jax(cfg: ModelConfig, tree_of_numpy: Dict[str, Any],
                    device=None, dtype=torch.float32) -> Dict[str, Any]:
    """``tree_of_numpy``: the JAX package's ``init_params`` tree with every
    leaf a numpy array. Raises on a missing or extra key and on any shape that
    differs from the port's specs."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    specs = tfm.model_param_specs(cfg)
    plan = {g.name: g.n_units for g in tfm.layer_plan(cfg)}
    top_missing = sorted(set(specs) - set(tree_of_numpy))
    top_extra = sorted(set(tree_of_numpy) - set(specs))
    if top_missing or top_extra:
        raise KeyError(f"<root>: missing keys {top_missing}, extra keys {top_extra}")
    out = {}
    for name, sub in specs.items():
        if isinstance(sub, ParamSpec):
            out[name] = _convert({name: sub}, {name: tree_of_numpy[name]}, "",
                                 None, device, dtype)[name]
        else:
            out[name] = _convert(sub, tree_of_numpy[name], name, plan.get(name),
                                 device, dtype)
    return out


def train_state_from_jax(cfg: ModelConfig, jax_state, device=None):
    """The JAX package's ``TrainState`` (params, opt = (step, mu, nu)), every
    leaf a numpy array, as the port's ``TrainState``: fp32 params, moments in
    their own dtype (bf16 leaves come as ml_dtypes arrays and stay bf16),
    ``step`` an int32 scalar tensor."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    device = resolve_device(device)
    mu0 = np.asarray(_first_leaf(jax_state.opt.mu))
    mdt = torch.bfloat16 if mu0.dtype.kind not in "fiu" else resolve_dtype(str(mu0.dtype))
    opt = opt_lib.OptState(
        step=torch.tensor(int(np.asarray(jax_state.opt.step)), dtype=torch.int32,
                          device=device),
        mu=params_from_jax(cfg, jax_state.opt.mu, device=device, dtype=mdt),
        nu=params_from_jax(cfg, jax_state.opt.nu, device=device, dtype=mdt))
    return ts.TrainState(params=params_from_jax(cfg, jax_state.params, device=device),
                         opt=opt)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree
