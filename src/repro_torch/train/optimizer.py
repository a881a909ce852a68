"""AdamW + LR schedule + global-norm clipping, the JAX package's arithmetic.

Moments are kept in bf16 (``moment_dtype``), the update math in fp32, as in
the JAX package. Unlike JAX's functional update, :func:`apply_updates`
writes the parameters and the moments **in place** (under ``no_grad``), one
slice of at most ``CHUNK`` elements at a time: an eager update of a whole
32 x 3072 x 8192 fp32 leaf would make about six temporaries of 3.2 GB each.
The order of operations is the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

CHUNK = 1 << 25       # elements updated at a time (128 MB of fp32)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"


class OptState(NamedTuple):
    step: torch.Tensor        # () int32
    mu: Any
    nu: Any


def _leaves(tree) -> Iterator[torch.Tensor]:
    """Leaves in the JAX package's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _moment_dtype(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: OptimizerConfig, params) -> OptState:
    mdt = _moment_dtype(cfg)
    some = next(_leaves(params))
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu=_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        nu=_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in _leaves(tree):
        sq = leaf.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its first dim of at most ``CHUNK`` elements."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        yield t
        return
    rows = max(1, CHUNK // max(1, t[0].numel()))
    yield from t.split(rows, dim=0)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. Updates ``params``, ``state.mu`` and ``state.nu`` in
    place (``grads`` is multiplied by the clip factor in place too) and
    returns them with the new step and {"grad_norm", "lr"}. Weight decay goes to every leaf with
    ``ndim >= 2``, as in the JAX package; that includes the stacked
    ``(n_units, d)`` norm scales, but not ``final_norm``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    for p, g, mu, nu in zip(_leaves(params), _leaves(grads), _leaves(state.mu),
                            _leaves(state.nu)):
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        keep = 1 - lr * decay
        for pc, gc, mc, nc in zip(_chunks(p), _chunks(g), _chunks(mu), _chunks(nu)):
            g32 = gc.float().mul_(scale)
            mu32 = mc.to(torch.float32, copy=True).mul_(b1).add_(g32 * (1 - b1))
            nu32 = nc.to(torch.float32, copy=True).mul_(b2).add_(
                torch.square(g32).mul_(1 - b2))
            mc.copy_(mu32)
            nc.copy_(nu32)
            denom = nu32.div_(bc2).sqrt_().add_(cfg.eps)      # sqrt(vhat) + eps
            delta = mu32.div_(bc1).div_(denom)                # mhat / denom
            new_p = pc.float().mul_(keep).sub_(delta.mul_(lr))
            if new_p.data_ptr() != pc.data_ptr():     # fp32 masters: done in place
                pc.copy_(new_p)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
