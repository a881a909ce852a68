"""Model assembly: layer plan -> stacked super-blocks -> full model.

Every architecture is expressed as a list of *groups*; each group is a stack
of identical *units* (super-blocks) whose parameters carry a leading
``n_units`` dim, exactly as in the JAX package (which scans over it):

  * homogeneous archs: one group, unit = 1 layer, n_units = L
  * gemma2: unit = (local layer, global layer), n_units = L/2
  * jamba: unit = 8 layers (attn at idx 3, rest mamba; MoE on odd idx)
  * deepseek: group "dense" (3 units) + group "moe" (58 units)

Here a Python loop walks the units (PyTorch runs eagerly; there is no trace
to keep small). Every mixer of the JAX package runs here (``gqa``, ``mla``,
``mamba``, ``rwkv``) with dense or MoE MLPs, and deepseek's MTP head has its
parameter subtree (``models.model._mtp_loss`` applies it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (ParamSpec, embed_param_specs,
                                       init_from_specs, mlp_apply,
                                       mlp_param_specs, resolve_device,
                                       resolve_dtype, rms_norm)

@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str                    # gqa | mla | mamba | rwkv
    is_global: bool = True        # local_global archs: global vs sliding
    mlp: str = "dense"            # dense | moe | none (rwkv: channel-mix)
    d_ff: int = 0                 # dense MLP width for this sublayer


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    pattern: Tuple[SubLayer, ...]
    n_units: int


def layer_plan(cfg: ModelConfig) -> List[Group]:
    if cfg.attention_kind == "none":          # rwkv6
        return [Group("layers", (SubLayer("rwkv", mlp="none"),), cfg.num_layers)]

    if cfg.hybrid_block_size > 1:             # jamba
        bs = cfg.hybrid_block_size
        assert cfg.num_layers % bs == 0
        pattern = []
        for i in range(bs):
            mixer = "gqa" if i in cfg.attn_layer_idx else "mamba"
            is_moe = cfg.layer_is_moe(i)
            pattern.append(SubLayer(mixer, mlp="moe" if is_moe else "dense",
                                    d_ff=cfg.d_ff))
        return [Group("layers", tuple(pattern), cfg.num_layers // bs)]

    if cfg.attention_kind == "local_global":  # gemma2
        assert cfg.num_layers % 2 == 0
        pattern = (SubLayer("gqa", is_global=False, d_ff=cfg.d_ff),
                   SubLayer("gqa", is_global=True, d_ff=cfg.d_ff))
        return [Group("layers", pattern, cfg.num_layers // 2)]

    mixer = "mla" if cfg.attention_kind == "mla" else "gqa"
    groups: List[Group] = []
    if cfg.num_dense_layers > 0:              # deepseek dense prelude
        groups.append(Group("dense_layers",
                            (SubLayer(mixer, d_ff=cfg.d_ff_dense),),
                            cfg.num_dense_layers))
    rest = cfg.num_layers - cfg.num_dense_layers
    body_is_moe = cfg.moe is not None
    groups.append(Group(
        "layers",
        (SubLayer(mixer, mlp="moe" if body_is_moe else "dense", d_ff=cfg.d_ff),),
        rest))
    return groups


# ----------------------------------------------------------------------
# Param specs
def _norm_spec(cfg) -> ParamSpec:
    init = "zeros" if cfg.zero_centered_norm else "ones"
    return ParamSpec((cfg.d_model,), ("d_model",), init=init)


def sublayer_param_specs(cfg: ModelConfig, sl: SubLayer) -> Dict[str, Any]:
    specs: Dict[str, Any] = {"norm_mixer": _norm_spec(cfg)}
    if cfg.post_norms:
        specs["norm_mixer_post"] = _norm_spec(cfg)
    if sl.mixer == "rwkv":
        specs["rwkv"] = ssm.rwkv_param_specs(cfg)
        specs["norm_mlp"] = _norm_spec(cfg)   # channel-mix norm
        return specs
    if sl.mixer == "mamba":
        specs["mamba"] = ssm.mamba_param_specs(cfg)
    elif sl.mixer == "mla":
        specs["attn"] = attn.mla_param_specs(cfg)
    elif sl.mixer == "gqa":
        specs["attn"] = attn.attn_param_specs(cfg)
    else:
        raise ValueError(sl.mixer)
    if sl.mlp == "dense":
        specs["norm_mlp"] = _norm_spec(cfg)
        specs["mlp"] = mlp_param_specs(cfg, sl.d_ff)
        if cfg.post_norms:
            specs["norm_mlp_post"] = _norm_spec(cfg)
    elif sl.mlp == "moe":
        specs["norm_mlp"] = _norm_spec(cfg)
        specs["moe"] = moe_mod.moe_param_specs(cfg)
    return specs


def unit_param_specs(cfg: ModelConfig, group: Group) -> Dict[str, Any]:
    return {f"sub{i}": sublayer_param_specs(cfg, sl)
            for i, sl in enumerate(group.pattern)}


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Spec tree of one unit per group (the stacked ``n_units`` dim is added
    at init). Same tree and names as the JAX package's; ``mtp`` (deepseek's
    multi-token-prediction head: one dense-MLP block of the model's mixer)
    is not stacked."""
    specs: Dict[str, Any] = {"embed": embed_param_specs(cfg),
                             "final_norm": _norm_spec(cfg)}
    for g in layer_plan(cfg):
        specs[g.name] = unit_param_specs(cfg, g)
    if cfg.mtp_depth > 0:
        specs["mtp"] = {
            "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                              ("d_model", "d_model_out")),
            "norm_h": _norm_spec(cfg),
            "norm_e": _norm_spec(cfg),
            "block": sublayer_param_specs(cfg, mtp_sublayer(cfg)),
            "final_norm": _norm_spec(cfg),
        }
    return specs


def mtp_sublayer(cfg: ModelConfig) -> SubLayer:
    """The MTP head's block: the model's mixer with a dense MLP of
    ``d_ff_dense`` (``d_ff`` where there is no dense prelude)."""
    return SubLayer("mla" if cfg.attention_kind == "mla" else "gqa",
                    d_ff=cfg.d_ff_dense or cfg.d_ff)


def init_params(cfg: ModelConfig, gen: torch.Generator | int = 0,
                dtype=torch.float32, device=None):
    """Random parameters on ``device`` (None: the card) in ``dtype``, drawn
    from a seeded ``torch.Generator`` (an int makes one on the device)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    specs = model_param_specs(cfg)
    plan = {g.name: g for g in layer_plan(cfg)}
    out = {}
    for name, sub in specs.items():
        stack = plan[name].n_units if name in plan else None
        if isinstance(sub, ParamSpec):
            out[name] = init_from_specs(gen, {name: sub}, dtype, device)[name]
        else:
            out[name] = init_from_specs(gen, sub, dtype, device, stack)
    return out


# ----------------------------------------------------------------------
# Sublayer application
def _norm(cfg, scale, x):
    return rms_norm(x, scale, cfg.norm_eps, zero_centered=cfg.zero_centered_norm)


def sublayer_apply(cfg: ModelConfig, sl: SubLayer, p, x, positions,
                   cache, lengths, *, mode: str, use_kernels: bool):
    """mode: 'dense' (no cache out), 'prefill', 'decode'.
    Returns (x, new_cache, aux_router_logits | None); the router logits of
    an MoE sublayer come back in mode 'dense' only, for the aux loss. In
    decode mode a KV or MLA ``cache`` is updated in place; a Mamba or RWKV
    state comes back as new tensors (``group_apply`` copies them into the
    stacked buffers)."""
    if sl.mixer == "rwkv":
        return _rwkv_sublayer(cfg, p, x, cache, mode=mode, use_kernels=use_kernels)
    out, new_cache = mixer_apply(cfg, sl, p, x, positions, cache, lengths,
                                 mode=mode, use_kernels=use_kernels)
    x, aux = mlp_half_apply(cfg, sl, p, x, out, mode=mode)
    return x, new_cache, aux


def _rwkv_sublayer(cfg, p, x, cache, *, mode: str, use_kernels: bool):
    h = _norm(cfg, p["norm_mixer"], x)
    state = cache if mode == "decode" else ssm.init_rwkv_state(
        cfg, x.shape[0], x.dtype, device=x.device)
    out, new_wkv, new_shift = ssm.rwkv_time_mix(
        cfg, p["rwkv"], h, state, use_kernel=use_kernels and mode != "decode")
    x = x + out
    h2 = _norm(cfg, p["norm_mlp"], x)
    cm_out, new_shift_c = ssm.rwkv_channel_mix(cfg, p["rwkv"], h2, state)
    x = x + cm_out
    return x, ssm.RWKVState(wkv=new_wkv, shift_t=new_shift, shift_c=new_shift_c), None


def mixer_apply(cfg: ModelConfig, sl: SubLayer, p, x, positions, cache, lengths,
                *, mode: str, use_kernels: bool):
    """The mixer half of a (non-RWKV) sublayer: norm, mixer, post norm.
    Returns (mixer output, new cache); the output is what the JAX package
    names ``"mixer_out"`` for its ``save_attn`` remat policy."""
    h = _norm(cfg, p["norm_mixer"], x)
    if sl.mixer == "mamba":
        state = cache if mode == "decode" else None
        out, new_cache = ssm.mamba_apply_dense(
            cfg, p["mamba"], h, state,
            use_kernel=use_kernels and mode != "decode")
    elif sl.mixer == "mla":
        if mode == "decode":
            out, new_cache = attn.mla_attention_decode(cfg, p["attn"], h, cache, lengths)
        else:
            out, new_cache = attn.mla_attention_dense(cfg, p["attn"], h, positions)
    elif sl.mixer == "gqa":
        if mode == "decode":
            out, new_cache = attn.gqa_attention_decode(
                cfg, p["attn"], h, cache, lengths, is_global=sl.is_global,
                use_kernel=use_kernels)
        else:
            out, new_cache = attn.gqa_attention_dense(
                cfg, p["attn"], h, positions, is_global=sl.is_global,
                use_kernel=use_kernels)
    else:
        raise ValueError(sl.mixer)
    if cfg.post_norms:
        out = _norm(cfg, p["norm_mixer_post"], out)
    return out, new_cache


def mlp_half_apply(cfg: ModelConfig, sl: SubLayer, p, x, mixer_out, *, mode: str):
    """The rest of a (non-RWKV) sublayer: the mixer's residual, then the
    dense or MoE MLP with its residual. Returns (x, aux_router_logits |
    None)."""
    x = x + mixer_out
    aux = None
    if sl.mlp == "dense":
        h = _norm(cfg, p["norm_mlp"], x)
        out = mlp_apply(cfg, p["mlp"], h)
        if cfg.post_norms:
            out = _norm(cfg, p["norm_mlp_post"], out)
        x = x + out
    elif sl.mlp == "moe":
        h = _norm(cfg, p["norm_mlp"], x)
        if mode == "dense":  # router logits for the aux loss
            aux = h.reshape(-1, cfg.d_model) @ p["moe"]["w_router"].to(h.dtype)
        x = x + moe_mod.moe_apply(cfg, p["moe"], h)
    return x, aux


def init_sublayer_cache(cfg: ModelConfig, sl: SubLayer, batch: int,
                        max_len: int, dtype=torch.bfloat16, device=None):
    if sl.mixer == "rwkv":
        return ssm.init_rwkv_state(cfg, batch, dtype, device=device)
    if sl.mixer == "mamba":
        return ssm.init_mamba_state(cfg, batch, dtype, device=device)
    if sl.mixer == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device=device)
    if sl.mixer == "gqa":
        return attn.init_kv_cache(cfg, batch, max_len, is_global=sl.is_global,
                                  dtype=dtype, device=device)
    raise ValueError(sl.mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Full-model cache tree on ``device`` (None: the card): per group, per
    sublayer, stacked n_units."""
    device = resolve_device(device)
    out = {}
    for g in layer_plan(cfg):
        unit = {}
        for i, sl in enumerate(g.pattern):
            one = init_sublayer_cache(cfg, sl, batch, max_len, dtype, device)
            unit[f"sub{i}"] = type(one)(
                *(t.new_zeros((g.n_units,) + tuple(t.shape)) for t in one))
        out[g.name] = unit
    return out


# ----------------------------------------------------------------------
# Group application (loop over the stacked units)
def _unit_params(tree, u: int):
    """Unit ``u``'s parameters: ``leaf[u]`` of a stacked leaf, or the u-th
    entry of a leaf that :func:`split_units` already cut into units."""
    if isinstance(tree, dict):
        return {k: _unit_params(v, u) for k, v in tree.items()}
    return tree[u]


def split_units(params_stacked, grads_stacked):
    """Per-unit autograd leaves of one group for a training step.

    Taking ``stacked[u]`` under autograd would make the backward of every
    unit allocate a zero tensor of the whole stacked leaf (12.9 GB a unit at
    phi4-mini's width) to put one slice in. Here each unit's parameters are
    views ``stacked[u]`` detached into leaves whose ``.grad`` is preset to
    the view ``grads_stacked[u]``: the backward adds a unit's gradient in
    place into its slice of the stacked gradient, with no full-size
    temporary. ``grads_stacked`` has the tree of ``params_stacked`` and must
    start at zero. Returns that tree with every leaf a tuple of per-unit
    leaves (``_unit_params`` indexes it like a stacked leaf)."""
    if isinstance(params_stacked, dict):
        return {k: split_units(v, grads_stacked[k]) for k, v in params_stacked.items()}
    units = []
    for p, g in zip(params_stacked.unbind(0), grads_stacked.unbind(0)):
        leaf = p.detach().requires_grad_(True)
        leaf.grad = g
        units.append(leaf)
    return tuple(units)


REMAT_POLICIES = ("nothing", "save_attn")


def _remat_unit(cfg: ModelConfig, group: Group, p_unit, x, positions, *,
                use_kernels: bool, policy: str):
    """One training unit under non-reentrant activation checkpointing.
    Returns (x, the unit's MoE aux terms).

    "nothing": the unit's input is kept and the backward reruns the whole
    unit. "save_attn": each mixer's output (the JAX package's
    ``"mixer_out"``) is kept as well. The mixer half and the MLP half of each
    sublayer are two regions: the backward reruns the MLP half from the kept
    input and mixer output, and the mixer half from its input (the mixer's
    own backward needs its inner activations, which neither policy keeps).
    An RWKV sublayer names no mixer output and is one region."""
    ckpt = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)

    def whole(sl, p, h):
        return sublayer_apply(cfg, sl, p, h, positions, None, None, mode="dense",
                              use_kernels=use_kernels)

    def mixer(sl, p, h):
        return mixer_apply(cfg, sl, p, h, positions, None, None, mode="dense",
                           use_kernels=use_kernels)[0]

    def mlp_half(sl, p, h, out):     # a region returns tensors: aux 0 without MoE
        h, aux = mlp_half_apply(cfg, sl, p, h, out, mode="dense")
        return h, (torch.zeros((), dtype=torch.float32, device=h.device) if aux is None
                   else moe_mod.aux_load_balance_loss(cfg, aux))

    subs = [(sl, p_unit[f"sub{i}"]) for i, sl in enumerate(group.pattern)]
    if policy == "nothing":
        def unit(h):
            total = torch.zeros((), dtype=torch.float32, device=h.device)
            for sl, p in subs:
                h, _, aux = whole(sl, p, h)
                if aux is not None:
                    total = total + moe_mod.aux_load_balance_loss(cfg, aux)
            return h, total
        return ckpt(unit, x)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for sl, p in subs:
        if sl.mixer == "rwkv":       # no MLP half, no aux
            x = ckpt(lambda h, sl=sl, p=p: whole(sl, p, h)[0], x)
        else:
            out = ckpt(functools.partial(mixer, sl, p), x)
            x, a = ckpt(functools.partial(mlp_half, sl, p), x, out)
            total = total + a
    return x, total


def _empty_stack(cfg: ModelConfig, sl: SubLayer, x: torch.Tensor):
    """A prefill cache of zero units (a group that a depth cut emptied)."""
    one = init_sublayer_cache(cfg, sl, x.shape[0], x.shape[1], x.dtype, x.device)
    return type(one)(*(t.new_zeros((0,) + tuple(t.shape)) for t in one))


def group_apply(cfg: ModelConfig, group: Group, params_stacked, x, positions,
                caches_stacked, lengths, *, mode: str, use_kernels: bool,
                remat: bool = False, remat_policy: str = "nothing"):
    """Returns (x, caches_stacked | None, aux_sum).

    decode: each unit's cache is a view ``stacked[u]``; the attention writes
    its K/V (or MLA latent) row in place, and a new Mamba or RWKV state is
    copied into the view, so the stacked caches that come back are the ones
    that went in. prefill: the per-unit caches are stacked, K/V to
    ``(L, B, S, KV, D)``, MLA latents to ``(L, B, S, r)``, Mamba and RWKV
    states to ``(L, B, ...)``; a group of zero units gives caches with
    ``L = 0``. dense (training): ``aux_sum`` adds up the MoE load-balance
    terms of the group's sublayers (0 without MoE); ``remat`` recomputes in
    the backward under ``remat_policy`` "nothing" or "save_attn", as in the
    JAX package (see :func:`_remat_unit`); ``params_stacked`` may come from
    :func:`split_units`."""
    if remat and mode != "dense":
        raise ValueError(f"remat recomputes dense (training) units only, not mode={mode!r}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of {REMAT_POLICIES}")
    collected = {f"sub{i}": [] for i in range(len(group.pattern))}
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)

    for u in range(group.n_units):
        p_unit = _unit_params(params_stacked, u)
        if remat:
            x, unit_aux = _remat_unit(cfg, group, p_unit, x, positions,
                                      use_kernels=use_kernels, policy=remat_policy)
            aux_sum = aux_sum + unit_aux
            continue
        for i, sl in enumerate(group.pattern):
            c_in = None
            if mode == "decode":
                c = caches_stacked[f"sub{i}"]
                c_in = type(c)(*(t[u] for t in c))
            x, c_out, aux = sublayer_apply(
                cfg, sl, p_unit[f"sub{i}"], x, positions, c_in, lengths,
                mode=mode, use_kernels=use_kernels)
            if aux is not None:
                aux_sum = aux_sum + moe_mod.aux_load_balance_loss(cfg, aux)
            if mode == "decode":
                for dst, src in zip(c_in, c_out):
                    if src is not dst:
                        dst.copy_(src)
            elif mode == "prefill":
                collected[f"sub{i}"].append(c_out)
    if mode == "decode":
        return x, caches_stacked, aux_sum
    if mode == "prefill":
        return x, {f"sub{i}": (type(cs[0])(*(torch.stack(f) for f in zip(*cs))) if cs
                               else _empty_stack(cfg, group.pattern[i], x))
                   for i, cs in enumerate(collected.values())}, aux_sum
    return x, None, aux_sum
