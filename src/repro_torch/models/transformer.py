"""Model assembly: layer plan -> stacked super-blocks -> full model.

Every architecture is expressed as a list of *groups*; each group is a stack
of identical *units* (super-blocks) whose parameters carry a leading
``n_units`` dim, exactly as in the JAX package (which scans over it):

  * homogeneous archs: one group, unit = 1 layer, n_units = L
  * gemma2: unit = (local layer, global layer), n_units = L/2
  * jamba: unit = 8 layers (attn at idx 3, rest mamba; MoE on odd idx)
  * deepseek: group "dense" (3 units) + group "moe" (58 units)

Here a Python loop walks the units (PyTorch runs eagerly; there is no trace
to keep small). The port runs the ``gqa``, ``mamba`` and ``rwkv`` mixers
with dense or MoE MLPs; MLA (and the MTP head) raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
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

_NOT_PORTED = {
    "mla": "MLA attention is not ported yet (ROADMAP.md Queue 1 item 7)",
}


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


def _check_ported(sl: SubLayer):
    if sl.mixer not in ("gqa", "mamba", "rwkv"):
        raise NotImplementedError(_NOT_PORTED[sl.mixer])


# ----------------------------------------------------------------------
# Param specs
def _norm_spec(cfg) -> ParamSpec:
    init = "zeros" if cfg.zero_centered_norm else "ones"
    return ParamSpec((cfg.d_model,), ("d_model",), init=init)


def sublayer_param_specs(cfg: ModelConfig, sl: SubLayer) -> Dict[str, Any]:
    _check_ported(sl)
    specs: Dict[str, Any] = {"norm_mixer": _norm_spec(cfg)}
    if cfg.post_norms:
        specs["norm_mixer_post"] = _norm_spec(cfg)
    if sl.mixer == "rwkv":
        specs["rwkv"] = ssm.rwkv_param_specs(cfg)
        specs["norm_mlp"] = _norm_spec(cfg)   # channel-mix norm
        return specs
    if sl.mixer == "mamba":
        specs["mamba"] = ssm.mamba_param_specs(cfg)
    else:
        specs["attn"] = attn.attn_param_specs(cfg)
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
    at init). Same tree and names as the JAX package's."""
    if cfg.mtp_depth > 0:
        raise NotImplementedError(
            "the multi-token-prediction head is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")
    specs: Dict[str, Any] = {"embed": embed_param_specs(cfg),
                             "final_norm": _norm_spec(cfg)}
    for g in layer_plan(cfg):
        specs[g.name] = unit_param_specs(cfg, g)
    return specs


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
    decode mode a KV ``cache`` is updated in place; a Mamba or RWKV state
    comes back as new tensors (``group_apply`` copies them into the stacked
    buffers)."""
    _check_ported(sl)
    aux = None
    h = _norm(cfg, p["norm_mixer"], x)
    if sl.mixer == "rwkv":
        state = cache if mode == "decode" else ssm.init_rwkv_state(
            cfg, x.shape[0], x.dtype, device=x.device)
        out, new_wkv, new_shift = ssm.rwkv_time_mix(
            cfg, p["rwkv"], h, state,
            use_kernel=use_kernels and mode != "decode")
        x = x + out
        h2 = _norm(cfg, p["norm_mlp"], x)
        cm_out, new_shift_c = ssm.rwkv_channel_mix(cfg, p["rwkv"], h2, state)
        x = x + cm_out
        return x, ssm.RWKVState(wkv=new_wkv, shift_t=new_shift,
                                shift_c=new_shift_c), aux
    if sl.mixer == "mamba":
        state = cache if mode == "decode" else None
        out, new_cache = ssm.mamba_apply_dense(
            cfg, p["mamba"], h, state,
            use_kernel=use_kernels and mode != "decode")
    elif mode == "decode":
        out, new_cache = attn.gqa_attention_decode(
            cfg, p["attn"], h, cache, lengths, is_global=sl.is_global,
            use_kernel=use_kernels)
    else:
        out, new_cache = attn.gqa_attention_dense(
            cfg, p["attn"], h, positions, is_global=sl.is_global,
            use_kernel=use_kernels)
    if cfg.post_norms:
        out = _norm(cfg, p["norm_mixer_post"], out)
    x = x + out

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
    return x, new_cache, aux


def init_sublayer_cache(cfg: ModelConfig, sl: SubLayer, batch: int,
                        max_len: int, dtype=torch.bfloat16, device=None):
    _check_ported(sl)
    if sl.mixer == "rwkv":
        return ssm.init_rwkv_state(cfg, batch, dtype, device=device)
    if sl.mixer == "mamba":
        return ssm.init_mamba_state(cfg, batch, dtype, device=device)
    return attn.init_kv_cache(cfg, batch, max_len, is_global=sl.is_global,
                              dtype=dtype, device=device)


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


def group_apply(cfg: ModelConfig, group: Group, params_stacked, x, positions,
                caches_stacked, lengths, *, mode: str, use_kernels: bool,
                remat: bool = False, remat_policy: str = "nothing"):
    """Returns (x, caches_stacked | None, aux_sum).

    decode: each unit's cache is a view ``stacked[u]``; the attention writes
    its K/V row in place, and a new Mamba or RWKV state is copied into the
    view, so the stacked caches that come back are the ones that went in.
    prefill: the per-unit caches are stacked, K/V to ``(L, B, S, KV, D)``,
    Mamba and RWKV states to ``(L, B, ...)``. dense (training): ``aux_sum``
    adds up the MoE load-balance terms of the group's sublayers (0 without
    MoE); ``remat`` recomputes each unit in the backward (policy "nothing",
    as in the JAX package); ``params_stacked`` may come from
    :func:`split_units`."""
    if remat and mode != "dense":
        raise ValueError(f"remat recomputes dense (training) units only, not mode={mode!r}")
    if remat and remat_policy == "save_attn":
        raise NotImplementedError(
            'remat_policy="save_attn" is not ported yet (ROADMAP.md Queue 1 '
            'item 9); use "nothing"')
    collected = {f"sub{i}": [] for i in range(len(group.pattern))}
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)

    def add_aux(total, aux):
        return total if aux is None else total + moe_mod.aux_load_balance_loss(cfg, aux)

    for u in range(group.n_units):
        p_unit = _unit_params(params_stacked, u)
        if remat:
            def unit(h, p_unit=p_unit):
                total = torch.zeros((), dtype=torch.float32, device=h.device)
                for i, sl in enumerate(group.pattern):
                    h, _, aux = sublayer_apply(cfg, sl, p_unit[f"sub{i}"], h,
                                               positions, None, lengths, mode=mode,
                                               use_kernels=use_kernels)
                    total = add_aux(total, aux)
                return h, total
            # non-reentrant: the backward reruns the whole unit from x
            x, unit_aux = torch.utils.checkpoint.checkpoint(unit, x, use_reentrant=False)
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
            aux_sum = add_aux(aux_sum, aux)
            if mode == "decode":
                for dst, src in zip(c_in, c_out):
                    if src is not dst:
                        dst.copy_(src)
            elif mode == "prefill":
                collected[f"sub{i}"].append(c_out)
    if mode == "decode":
        return x, caches_stacked, aux_sum
    if mode == "prefill":
        return x, {name: type(cs[0])(*(torch.stack(f) for f in zip(*cs)))
                   for name, cs in collected.items()}, aux_sum
    return x, None, aux_sum
