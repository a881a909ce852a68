"""Helpers shared by the port's parity tests: inputs and weights are made
with numpy from a seed and handed to both frameworks."""
import numpy as np

import jax.numpy as jnp
import torch

from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import ParamSpec


def to_jax(x: np.ndarray, bf16: bool = False):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def to_torch(x: np.ndarray, bf16: bool = False):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16 if bf16 else torch.float32)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def numpy_params(cfg, seed: int = 0):
    """A parameter tree of float32 numpy arrays with the shapes of the
    port's specs (stacked ``n_units`` dim included). Norm scales get noise
    too, so that a swapped or dropped scale shows."""
    rng = np.random.default_rng(seed)
    plan = {g.name: g.n_units for g in ttfm.layer_plan(cfg)}

    def make(spec_tree, stack):
        if isinstance(spec_tree, ParamSpec):
            shape = spec_tree.shape if stack is None else (stack,) + spec_tree.shape
            if spec_tree.init in ("zeros", "ones"):
                base = 0.0 if spec_tree.init == "zeros" else 1.0
                return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
            fan_in = (spec_tree.shape[0] if len(spec_tree.shape) > 1
                      else max(spec_tree.shape[-1], 1))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        return {k: make(v, stack) for k, v in spec_tree.items()}

    return {name: make(sub, plan.get(name))
            for name, sub in ttfm.model_param_specs(cfg).items()}


def tree_to_jax(tree):
    if isinstance(tree, dict):
        return {k: tree_to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
