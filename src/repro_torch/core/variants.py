"""Model variant pool: the accuracy-configuration ladder (paper §IV-A).

The paper approximates MobileNetV2 by selecting among pre-trained width
multipliers alpha in {1.4, 1.3, 1.0, 0.75, 0.5, 0.35} (accuracy 92.5%..82.9%
top-5). The analogue for LMs is a ladder of *real, runnable*
config variants per architecture:

  * dense archs — width-pruned d_ff (MobileNet-style alpha on the MLP);
  * MoE archs  — reduced routed top-k (fewer active experts per token), a
    knob the CNN pool cannot express (beyond-paper variant axis);
  * depth cut  — optional early-exit layer count for the smallest levels.

Each variant carries an analytic throughput model (FLOPs/bytes per item,
fed by the roofline constants) and an accuracy *proxy* calibrated to the
paper's MobileNet range: acc(v) maps relative active-parameter count
through a log-linear quality curve into [acc_min, acc_max]. This is a
documented proxy — on real hardware the Profile FSM state would measure it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from repro_torch.configs import ModelConfig

# paper's MobileNetV2 alpha ladder accuracy endpoints (top-5 %)
ACC_MAX = 92.5
ACC_MIN = 82.9
NUM_LEVELS = 6


def _round_ff(x: float) -> int:
    return max(128, int(round(x / 128)) * 128)


@dataclasses.dataclass(frozen=True)
class Variant:
    """One approximation level: a runnable ModelConfig + quality proxy."""
    level: int                  # 0 = most accurate (least approximate)
    alpha: float                # width/top-k multiplier
    config: ModelConfig
    accuracy: float             # proxy accuracy %
    rel_active_params: float    # active params / full active params


ALPHAS = (1.0, 0.85, 0.7, 0.55, 0.45, 0.35)


def make_variant_config(cfg: ModelConfig, alpha: float) -> ModelConfig:
    """Scale the config the way the MobileNet ladder scales width."""
    if alpha >= 0.999:
        return cfg
    changes = {}
    if cfg.moe is not None:
        m = cfg.moe
        # MoE: shrink routed top-k first (>=1), then expert width
        new_k = max(1, int(round(m.top_k * alpha)))
        new_ff = _round_ff(m.d_ff_expert * max(alpha, 0.5))
        changes["moe"] = dataclasses.replace(m, top_k=new_k,
                                             d_ff_expert=new_ff)
        if cfg.d_ff_dense:
            changes["d_ff_dense"] = _round_ff(cfg.d_ff_dense * alpha)
        changes["d_ff"] = _round_ff(cfg.d_ff * alpha) if cfg.moe is None else cfg.d_ff
    else:
        changes["d_ff"] = _round_ff(cfg.d_ff * alpha)
    # deepest approximation also cuts depth (early-exit style), keeping the
    # hybrid/alternating block structure intact
    if alpha <= 0.45:
        bs = max(cfg.hybrid_block_size, 2 if cfg.attention_kind == "local_global" else 1)
        units = cfg.num_layers // bs
        keep_units = max(1, int(round(units * 0.75)))
        changes["num_layers"] = keep_units * bs
        if cfg.num_dense_layers > changes["num_layers"]:
            changes["num_dense_layers"] = 0
    return cfg.scaled(**changes)


def accuracy_proxy(rel_active: float, *, acc_max: float = ACC_MAX,
                   acc_min: float = ACC_MIN, rel_min: float = 0.25) -> float:
    """Log-linear quality curve through the paper's MobileNet endpoints."""
    rel = min(max(rel_active, rel_min), 1.0)
    t = math.log(rel) / math.log(rel_min)          # 0 at full, 1 at rel_min
    return acc_max - t * (acc_max - acc_min)


class VariantPool:
    """The per-arch approximation ladder (levels 0..NUM_LEVELS-1)."""

    def __init__(self, cfg: ModelConfig, alphas: Tuple[float, ...] = ALPHAS):
        self.base = cfg
        full_active = cfg.param_count(active_only=True)
        self.variants: List[Variant] = []
        for lvl, a in enumerate(alphas):
            vcfg = make_variant_config(cfg, a)
            rel = vcfg.param_count(active_only=True) / full_active
            self.variants.append(Variant(
                level=lvl, alpha=a, config=vcfg,
                accuracy=accuracy_proxy(rel), rel_active_params=rel))

    def __len__(self) -> int:
        return len(self.variants)

    def __getitem__(self, level: int) -> Variant:
        return self.variants[level]

    @property
    def accuracies(self) -> List[float]:
        return [v.accuracy for v in self.variants]
