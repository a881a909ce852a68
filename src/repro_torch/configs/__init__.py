"""Architecture config registry: ``get_config(arch)`` / ``get_smoke_config``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig, SSMConfig, ShapeConfig, SHAPES

_ARCH_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma2-2b": "gemma2_2b",
    "gemma2-27b": "gemma2_27b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "musicgen-medium": "musicgen_medium",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells():
    """All assigned (arch, shape) dry-run cells, with documented skips.

    long_500k requires sub-quadratic attention; pure full-attention archs are
    skipped per the assignment (see DESIGN.md §Arch-applicability).
    """
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            skip = sname == "long_500k" and not cfg.sub_quadratic
            out.append((arch, sname, skip))
    return out


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "ARCH_NAMES", "get_config", "get_smoke_config", "get_shape",
    "cells",
]
