"""Public model API: forward (full sequence), prefill / decode_step (serve).

For ``frontend_stub`` archs (musicgen, llava-next) the modality frontend is a
stub: callers pass precomputed frame/patch embeddings which are projected and
prepended to the token embeddings; positions cover the concatenated stream.
``loss_fn`` is the training loss: next-token cross-entropy plus the MoE
load-balance term, plus deepseek's multi-token-prediction (MTP) term. Serving
(``prefill``, ``decode_step``) does not run the MTP head, as in the JAX
package; its parameters are carried all the same.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed_tokens, lm_logits, resolve_dtype,
                                       rms_norm, sinusoidal_embedding)

# re-exports for convenience
init_params = tfm.init_params
init_cache = tfm.init_cache


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return resolve_dtype(cfg.dtype)


def _embed_inputs(cfg: ModelConfig, params, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    dtype = _dtype(cfg)
    x = embed_tokens(cfg, params["embed"], tokens, dtype)
    if cfg.frontend_stub:
        assert embeds is not None, f"{cfg.name} needs stub frontend embeddings"
        fe = embeds.to(dtype) @ params["embed"]["frontend_proj"].to(dtype)
        x = torch.cat([fe, x], dim=1)
    if cfg.pos_kind == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal_embedding(pos, cfg.d_model).to(dtype)[None]
    return x


def _backbone(cfg: ModelConfig, params, x, positions, caches, lengths, *,
              mode: str, use_kernels: bool, remat: bool = False,
              remat_policy: str = "nothing"):
    """Returns (x, caches, aux): ``aux`` sums the MoE load-balance terms of
    mode 'dense' (0 without MoE layers and in the serving modes)."""
    new_caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in tfm.layer_plan(cfg):
        c = caches[g.name] if caches is not None else None
        x, c_out, aux = tfm.group_apply(cfg, g, params[g.name], x, positions, c,
                                        lengths, mode=mode, use_kernels=use_kernels,
                                        remat=remat, remat_policy=remat_policy)
        if c_out is not None:
            new_caches[g.name] = c_out
        aux_total = aux_total + aux
    if mode == "decode":
        new_caches = caches      # written in place: the same tree goes back
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 zero_centered=cfg.zero_centered_norm)
    return x, new_caches, aux_total


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, *,
            use_kernels: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits over token positions, aux_loss);
    the aux loss (the MoE load-balance term) is 0 for dense archs."""
    x = _embed_inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _backbone(cfg, params, x, positions, None, None,
                          mode="dense", use_kernels=use_kernels)
    if cfg.frontend_stub:   # logits only over the token region
        x = x[:, embeds.shape[1]:]
    logits = lm_logits(cfg, params["embed"], x)
    return logits, aux


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def _mtp_loss(cfg: ModelConfig, params, x_final, tokens, targets_mask):
    """DeepSeek MTP: predict token t+2 from (h_t, emb(t+1)) through one extra
    dense block (no kernels, as in the JAX package); returns the auxiliary
    CE term."""
    p = params["mtp"]
    dtype = x_final.dtype
    emb_next = embed_tokens(cfg, params["embed"], tokens[:, 1:], dtype)
    h = rms_norm(x_final[:, :-1], p["norm_h"], cfg.norm_eps)
    e = rms_norm(emb_next, p["norm_e"], cfg.norm_eps)
    merged = torch.cat([h, e], dim=-1) @ p["proj"].to(dtype)
    positions = torch.arange(merged.shape[1], device=merged.device)[None, :]
    merged, _, _ = tfm.sublayer_apply(cfg, tfm.mtp_sublayer(cfg), p["block"], merged,
                                      positions, None, None, mode="dense",
                                      use_kernels=False)
    merged = rms_norm(merged, p["final_norm"], cfg.norm_eps)
    logits = lm_logits(cfg, params["embed"], merged)      # (B, S-1, V)
    ce = _ce(logits[:, :-1], tokens[:, 2:]) * targets_mask[:, 2:]   # token t+2
    return ce.sum() / targets_mask[:, 2:].sum().clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = False,
            remat_policy: str = "nothing", aux_weight: float = 0.01,
            mtp_weight: float = 0.1) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE (+ ``aux_weight`` x the MoE load-balance term, 0 for
    dense archs, + ``mtp_weight`` x the MTP term where ``cfg.mtp_depth`` >
    0). ``batch``: ``tokens`` (B, S), and optionally ``loss_mask`` (B, S)
    and ``embeds`` (stub frontends). The backbone runs once; the LM head and
    the MTP head share its final hidden states. Returns (total, {"ce",
    "aux"[, "mtp"]}), as the JAX package's ``loss_fn``."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    x = _embed_inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _backbone(cfg, params, x, positions, None, None, mode="dense",
                          use_kernels=use_kernels, remat=remat,
                          remat_policy=remat_policy)
    if cfg.frontend_stub:
        x = x[:, embeds.shape[1]:]
    logits = lm_logits(cfg, params["embed"], x)

    targets = tokens[:, 1:]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    ce = _ce(logits[:, :-1], targets) * mask[:, 1:]
    loss = ce.sum() / mask[:, 1:].sum().clamp_min(1.0)
    metrics = {"ce": loss, "aux": aux}
    total = loss + aux_weight * aux
    if cfg.mtp_depth > 0:
        mtp = _mtp_loss(cfg, params, x, tokens, mask)
        metrics["mtp"] = mtp
        total = total + mtp_weight * mtp
    return total, metrics


# ----------------------------------------------------------------------
# Serving paths
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, *,
            use_kernels: bool = False) -> Tuple[torch.Tensor, Any]:
    """Process the prompt; returns (last-position logits, raw seq-length
    caches stacked (L, B, S, KV, D) per group and sublayer). The engine pads
    these into max_len decode caches."""
    x = _embed_inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, caches, _ = _backbone(cfg, params, x, positions, None, None,
                             mode="prefill", use_kernels=use_kernels)
    logits = lm_logits(cfg, params["embed"], x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params, caches, lengths: torch.Tensor,
                tokens: torch.Tensor, *, use_kernels: bool = False
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """One decode step. tokens: (B,) new token ids; lengths: (B,) current
    context lengths. Returns (logits (B,V), caches, lengths+1). ``caches`` is
    written **in place** and handed back (this replaces the JAX engine's
    buffer donation); ``lengths`` is not modified."""
    x = embed_tokens(cfg, params["embed"], tokens[:, None], _dtype(cfg))
    if cfg.pos_kind == "sinusoidal":
        x = x + sinusoidal_embedding(lengths[:, None], cfg.d_model).to(x.dtype)
    positions = lengths[:, None]
    x, caches, _ = _backbone(cfg, params, x, positions, caches, lengths,
                             mode="decode", use_kernels=use_kernels)
    logits = lm_logits(cfg, params["embed"], x)[:, 0]
    return logits, caches, lengths + 1
