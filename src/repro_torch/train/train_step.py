"""Training step: loss -> grads -> AdamW update, with remat and optional
microbatch gradient accumulation (for memory-bound cells).

The state is updated **in place** (this replaces the JAX launcher's buffer
donation): ``train_step`` hands back the same parameter and moment tensors
it was given. Gradients land in one fp32 buffer per step, through the
per-unit leaves of ``models.transformer.split_units``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.OptimizerConfig = opt_lib.OptimizerConfig()
    remat: bool = True
    microbatches: int = 1           # grad accumulation
    use_kernels: bool = False
    remat_policy: str = "nothing"   # "nothing" | "save_attn"


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.OptState


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     gen: torch.Generator | int = 0, device=None) -> TrainState:
    """fp32 master parameters from a seeded generator on ``device`` (None:
    the card) and zero moments."""
    params = model_lib.init_params(cfg, gen, dtype=torch.float32, device=device)
    return TrainState(params=params, opt=opt_lib.init_opt_state(tcfg.opt, params))


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """The train state's shapes and dtypes as tensors on the ``meta`` device
    (no memory): a restore target."""
    mdt = opt_lib._moment_dtype(tcfg.opt)
    return TrainState(params=model_lib.abstract_params(cfg, torch.float32),
                      opt=opt_lib.OptState(
                          step=torch.empty((), dtype=torch.int32, device="meta"),
                          mu=model_lib.abstract_params(cfg, mdt),
                          nu=model_lib.abstract_params(cfg, mdt)))


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def grad_leaves(cfg: ModelConfig, params, grads):
    """The parameter tree a step differentiates: every stacked group cut
    into per-unit leaves (``split_units``), every other leaf a detached leaf;
    each leaf's ``.grad`` is preset to its slice of ``grads``, so the
    backward accumulates into ``grads`` in place."""
    groups = {g.name for g in tfm.layer_plan(cfg)}
    out = {}
    for name, sub in params.items():
        if name in groups:
            out[name] = tfm.split_units(sub, grads[name])
        else:
            out[name] = _top_leaves(sub, grads[name])
    return out


def _top_leaves(p, g):
    if isinstance(p, dict):
        return {k: _top_leaves(v, g[k]) for k, v in p.items()}
    leaf = p.detach().requires_grad_(True)
    leaf.grad = g
    return leaf


def _split_micro(batch: Dict[str, torch.Tensor], n: int, i: int):
    def sl(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: sl(v) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params,
                   batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads): the mean over ``tcfg.microbatches`` of the
    loss and of its fp32 gradients, as the JAX step accumulates them."""
    grads = _zeros_like_tree(params)
    leaves = grad_leaves(cfg, params, grads)
    n = max(1, tcfg.microbatches)
    loss = None
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(n):
        mb = batch if n == 1 else _split_micro(batch, n, i)
        with torch.enable_grad():
            l, m = model_lib.loss_fn(cfg, leaves, mb, use_kernels=tcfg.use_kernels,
                                     remat=tcfg.remat,
                                     remat_policy=tcfg.remat_policy)
            l.backward()
        loss = l.detach() if loss is None else loss + l.detach()
        if n == 1:
            metrics = {k: v.detach() for k, v in m.items()}
    if n > 1:
        with torch.no_grad():
            for g in opt_lib._leaves(grads):
                g.div_(n)
        loss = loss / n
    return loss, metrics, grads


def train_step(cfg: ModelConfig, tcfg: TrainConfig, state: TrainState,
               batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict]:
    """One step. ``batch``: {"tokens": (B, S) int} on the state's device.
    Returns (state, {"loss", "grad_norm", "lr"[, "ce", "aux"]}) with 0-d
    tensors on the device; the state's tensors are updated in place. The
    update is the profiler range ``train.apply_updates`` (``core.trace.span``),
    so a trace shows the optimizer's share of the step."""
    loss, metrics, grads = loss_and_grads(cfg, tcfg, state.params, batch)
    with trace.span("train.apply_updates"):
        params, opt, opt_metrics = opt_lib.apply_updates(tcfg.opt, state.params,
                                                         grads, state.opt)
    del grads
    return TrainState(params, opt), {"loss": loss, **opt_metrics, **metrics}
