"""Shared model primitives: param specs, norms, RoPE, MLPs, embeddings.

Convention: every layer module exposes ``*_param_specs(cfg) -> dict`` mapping
param name to ``ParamSpec(shape, dims, init)``. ``dims`` are *logical* axis
names (kept so the parameter tree matches the JAX package's leaf for leaf).
Parameters are plain nested dicts of tensors with the same tree shape and
names as the JAX package's pytree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dims: Tuple[Any, ...]           # logical dim names (None = replicated)
    init: str = "normal"            # normal | zeros | ones | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)


ParamTree = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """The port's device rule: ``None`` means the card, and raises when there
    is none; the CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the caller "
                "passes device='cpu'")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]


def init_from_specs(gen: torch.Generator, specs: Dict[str, Any],
                    dtype=torch.float32, device=None,
                    stack: Optional[int] = None) -> ParamTree:
    """Initialize a (possibly nested) spec tree into concrete tensors on
    ``device`` (the generator must live there). ``stack`` prepends a leading
    dim of that size: the stacked units of one layer group."""
    out: ParamTree = {}
    for name, spec in specs.items():
        if not isinstance(spec, ParamSpec):
            out[name] = init_from_specs(gen, spec, dtype, device, stack)
            continue
        shape = spec.shape if stack is None else (stack,) + tuple(spec.shape)
        if spec.init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
            std = spec.scale / math.sqrt(fan_in)
            t = torch.empty(shape, dtype=dtype, device=device)
            out[name] = t.normal_(0.0, std, generator=gen)
    return out


# ----------------------------------------------------------------------
# Norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if zero_centered else scale.float()
    return (x * w).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ----------------------------------------------------------------------
# Positional encodings
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split-halves
    form: the two halves of head_dim rotate against each other."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ----------------------------------------------------------------------
# MLPs
def mlp_param_specs(cfg, d_ff: int | None = None) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("d_model", "d_ff")),
            "w_up": ParamSpec((d, f), ("d_model", "d_ff")),
            "w_down": ParamSpec((f, d), ("d_ff", "d_model")),
        }
    return {
        "w_up": ParamSpec((d, f), ("d_model", "d_ff")),
        "w_down": ParamSpec((f, d), ("d_ff", "d_model")),
    }


def mlp_apply(cfg, p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    wu = p["w_up"].to(x.dtype)
    wd = p["w_down"].to(x.dtype)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ wu)
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh") * (x @ wu)
    else:
        h = F.gelu(x @ wu, approximate="tanh")
    return h @ wd


# ----------------------------------------------------------------------
# Embedding / head
def embed_param_specs(cfg) -> Dict[str, ParamSpec]:
    specs = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "d_model"))}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("d_model", "vocab"))
    if cfg.frontend_stub:
        # projection from stub modality embeddings into d_model
        specs["frontend_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                           ("d_model", "d_model_out"))
    return specs


def embed_tokens(cfg, p: ParamTree, tokens: torch.Tensor, dtype) -> torch.Tensor:
    x = p["embedding"][tokens].to(dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
    return x


def lm_logits(cfg, p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].to(x.dtype).T
    else:
        logits = x @ p["lm_head"].to(x.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)
