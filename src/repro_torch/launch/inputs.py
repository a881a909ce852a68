"""Stand-ins for every model input, per (arch x shape) cell: tensors on the
``meta`` device with the shapes and dtypes of the JAX package's
``ShapeDtypeStruct``s. No memory is allocated here; ``launch.dryrun``
materialises them on the card at one data shard's batch."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib


def token_seq_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token positions (total sequence length minus stub-embedding region)."""
    if cfg.frontend_stub:
        return max(shape.seq_len - cfg.stub_embed_len, 8)
    return shape.seq_len


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b = shape.global_batch
    s_tok = token_seq_len(cfg, shape)
    dt = _act_dtype(cfg)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, s_tok), torch.int32)}
        if cfg.frontend_stub:
            out["embeds"] = _meta((b, cfg.stub_embed_len, cfg.d_model), dt)
        return {"batch": out} if shape.kind == "train" else out
    if shape.kind == "decode":
        return {
            "caches": model_lib.abstract_cache(cfg, b, shape.seq_len, dtype=dt),
            "lengths": _meta((b,), torch.int32),
            "tokens": _meta((b,), torch.int32),
        }
    raise ValueError(shape.kind)
