"""Helpers shared by the port's parity tests: inputs and weights are made
with numpy from a seed and handed to both frameworks, and the port's
configurations in the form the JAX package runs them."""
import dataclasses

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


# the port's fields that the JAX package lacks, at the values that reproduce it
PORT_ONLY = {"rope_scaling": None, "norm_kind": "rms", "embed_norm": False}
PORT_ONLY_MOE = {"scoring": "softmax", "n_group": 1, "topk_group": 1, "num_routed": 0}
PORT_ONLY_SSM = {"token_shift_lora": 0, "head_norm_eps": 0.0}


def jax_form(cfg):
    """``cfg`` as the JAX package runs it: a softmax top-k router over the
    experts held, plain RoPE, and RWKV-6 with static token-shift mixes, one
    LayerNorm over the WKV output and bias-free RMSNorm blocks. The port's
    deepseek-v3 takes the published sigmoid group-limited router and YaRN,
    and its rwkv6-1.6b Finch's data-dependent token shift, per-head
    GroupNorm and LayerNorm blocks (ln0 included), which the JAX package
    lacks; every other configuration comes back as it is."""
    if cfg.moe is not None and (cfg.moe.scoring, cfg.moe.n_group) != ("softmax", 1):
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, scoring="softmax", n_group=1,
                                                 topk_group=1))
    if cfg.rope_scaling is not None:
        cfg = cfg.scaled(rope_scaling=None)
    if cfg.ssm is not None and any(getattr(cfg.ssm, k) != v for k, v in PORT_ONLY_SSM.items()):
        cfg = cfg.scaled(ssm=dataclasses.replace(cfg.ssm, **PORT_ONLY_SSM))
    if (cfg.norm_kind, cfg.embed_norm) != ("rms", False):
        cfg = cfg.scaled(norm_kind="rms", embed_norm=False)
    return cfg


def jax_asdict(cfg) -> dict:
    """``dataclasses.asdict`` of ``jax_form(cfg)`` without the fields that only
    the port has (each must hold the value that reproduces the JAX package),
    to compare with the JAX package's configuration."""
    d = dataclasses.asdict(jax_form(cfg))
    for k, v in PORT_ONLY.items():
        assert d.pop(k) == v, k
    if d["moe"] is not None:
        for k, v in PORT_ONLY_MOE.items():
            assert d["moe"].pop(k) == v, k
    if d["ssm"] is not None:
        for k, v in PORT_ONLY_SSM.items():
            assert d["ssm"].pop(k) == v, k
    return d
