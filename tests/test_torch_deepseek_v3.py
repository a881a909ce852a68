"""DeepSeek-V3 as published on the port's CPU path, at small size, against the
plain float32 reference ``torch_ref_deepseek_v3``: the engine's prefill and
every decode step through the latent cache; the sigmoid group-limited router
with its correction bias; YaRN's frequencies and attention scale; and expert
parallelism's share of a layer. Also that mixtral's softmax routing and
phi4's plain RoPE are unchanged bit for bit, and run the same operations."""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_ref_deepseek_v3 as ref
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import trace
from repro_torch.core.variants import VariantPool
from repro_torch.models import attention as attn
from repro_torch.models import init_params
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.serving.engine import Engine, EngineConfig

ARCH = "deepseek-v3-671b"
PROMPT, STEPS = 12, 5
# fp32 against fp32: the port and the reference sum in other orders (the
# absorbed decode, the grouped expert products), a few 1e-6 on logits of
# about unit size through four layers; bfloat16 scores or a bfloat16 router
# move them by 1e-3 or more (test_tolerance_catches_bf16)
TOL = 1e-4
BIAS_STD = 0.02          # the correction bias: of the order of the scores' spread


def _ep_config():
    """4 of 16 routed experts held (a share of an EP4 deployment), top-4 of 4
    groups, the best 2 kept."""
    m = dataclasses.replace(get_smoke_config(ARCH).moe, num_experts=4, num_routed=16,
                            top_k=4, n_group=4, topk_group=2)
    return get_smoke_config(ARCH).scaled(moe=m)


CASES = {"level0": (lambda: get_smoke_config(ARCH), 0),
         "level5": (lambda: get_smoke_config(ARCH), 5),
         "ep-share": (_ep_config, 0)}


def _params(cfg, seed):
    params = init_params(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    moe_p = params["layers"]["sub0"]["moe"]
    moe_p["router_bias"] = torch.randn(moe_p["router_bias"].shape, generator=gen) * BIAS_STD
    return params


def _served_and_reference(name, **ref_kw):
    make, level = CASES[name]
    cfg = VariantPool(make())[level].config.scaled(dtype="float32")
    params = _params(cfg, 5 + level)
    toks = torch.from_numpy(np.random.default_rng(6).integers(1, cfg.vocab_size, (2, PROMPT)))
    eng = Engine(cfg, params, EngineConfig(max_len=PROMPT + STEPS), device="cpu")
    logits, caches, lengths = eng.prefill(toks)
    got, seq = [logits], toks
    for _ in range(STEPS - 1):
        nxt = logits.argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, caches, lengths = eng.decode(caches, lengths, nxt)
        got.append(logits)
    want = ref.forward(dataclasses.asdict(cfg), params, seq, PROMPT, **ref_kw)[:, PROMPT - 1:]
    return cfg, torch.stack(got, 1), want


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_the_reference(name):
    cfg, got, want = _served_and_reference(name)
    assert cfg.moe.scoring == "sigmoid" and cfg.rope_scaling is not None
    assert got.shape == want.shape == (2, STEPS, cfg.vocab_size)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [{"score_dtype": torch.bfloat16},
                                {"router_dtype": torch.bfloat16}], ids=["scores", "router"])
def test_tolerance_catches_bf16(kw):
    """The reference with bfloat16 attention scores, or a bfloat16 router,
    lies outside ``TOL`` of the port in float32, by twice the tolerance or
    more at some logit."""
    _, got, want = _served_and_reference("level0", **kw)
    assert ((got - want).abs() / (TOL + TOL * want.abs())).max() > 2


# ----------------------------------------------------------------------
# The router
def _router_cfg(**kw):
    m = dataclasses.replace(get_smoke_config(ARCH).moe, **kw)
    return get_smoke_config(ARCH).scaled(moe=m, dtype="float32")


def _ref_route_on(cfg, logits, bias):
    """``ref.route`` with the router's product made the identity."""
    w = {"w_router": torch.eye(logits.shape[1]), "router_bias": bias}
    return ref.route(logits, w, dataclasses.asdict(cfg.moe))


@pytest.mark.parametrize("top_k,n_group,topk_group", [(8, 8, 4), (3, 8, 4), (2, 4, 2),
                                                      (4, 1, 1)])
def test_router_matches_the_reference(top_k, n_group, topk_group):
    cfg = _router_cfg(num_experts=64, top_k=top_k, n_group=n_group, topk_group=topk_group)
    gen = torch.Generator().manual_seed(top_k * 10 + n_group)
    logits = torch.randn(200, 64, generator=gen)
    bias = torch.randn(64, generator=gen) * 0.1
    gates, idx = moe.route_grouped(cfg, logits, bias)
    r_gates, r_idx = _ref_route_on(cfg, logits, bias)
    assert torch.equal(idx, r_idx)
    torch.testing.assert_close(gates, r_gates, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gates.sum(-1), torch.full((200,), 2.5), rtol=1e-6, atol=1e-6)


def test_the_bias_changes_the_choice_but_not_the_gates():
    """Expert 1 scores above expert 2, but expert 2's bias takes it in; its
    gate comes from its unbiased score."""
    cfg = _router_cfg(num_experts=8, top_k=2, n_group=1, topk_group=1)
    logits = torch.tensor([[3.0, 2.0, 1.9, -1, -1, -1, -1, -1]])
    no_bias = torch.zeros(8)
    _, idx = moe.route_grouped(cfg, logits, no_bias)
    assert idx.tolist() == [[0, 1]]
    bias = torch.zeros(8)
    bias[2] = 0.05
    gates, idx = moe.route_grouped(cfg, logits, bias)
    assert idx.tolist() == [[0, 2]]
    s = torch.sigmoid(logits[0, [0, 2]])
    torch.testing.assert_close(gates[0], s / s.sum() * 2.5)
    assert torch.equal(idx, _ref_route_on(cfg, logits, bias)[1])


def test_group_limiting_excludes_a_higher_scoring_expert():
    """4 groups of 2, the best 2 groups kept: expert 6 has the third best
    score, but its group's two best sum lowest but one, so the fourth best
    (expert 1, in a kept group) is taken instead."""
    cfg = _router_cfg(num_experts=8, top_k=3, n_group=4, topk_group=2)
    logits = torch.tensor([[4.0, 1.0, 3.0, 2.5, 0.5, 0.4, 1.5, -3.0]])
    # group sums of the two best sigmoid scores: g0 (0,1), g1 (2,3) lead
    _, idx = moe.route_grouped(cfg, logits, torch.zeros(8))
    assert idx.tolist() == [[0, 2, 3]]
    cfg_flat = _router_cfg(num_experts=8, top_k=3, n_group=1, topk_group=1)
    logits2 = torch.tensor([[4.0, 1.0, 3.0, 0.8, 0.5, 0.4, 2.0, -3.0]])
    _, flat = moe.route_grouped(cfg_flat, logits2, torch.zeros(8))
    assert flat.tolist() == [[0, 2, 6]]              # ungrouped: expert 6 third
    _, grouped = moe.route_grouped(cfg, logits2, torch.zeros(8))
    assert grouped.tolist() == [[0, 2, 1]]           # g3 = (6, 7) sums below g0 and g1
    assert torch.equal(grouped, _ref_route_on(cfg, logits2, torch.zeros(8))[1])


# ----------------------------------------------------------------------
# YaRN
def test_yarn_frequencies_and_mscale_match_the_formula():
    rs = get_config(ARCH).rope_scaling
    dim, theta = 64, 10000.0
    assert (rs.factor, rs.original_max_position_embeddings, rs.beta_fast, rs.beta_slow,
            rs.mscale, rs.mscale_all_dim) == (40.0, 4096, 32.0, 1.0, 1.0, 1.0)
    # correction dims: 64 ln(4096 / (2 pi r)) / (2 ln 10000) at r = 32 and 1
    low = math.floor(64 * math.log(4096 / (2 * math.pi * 32)) / (2 * math.log(theta)))
    high = math.ceil(64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(theta)))
    assert (low, high) == (10, 23) == layers.yarn_correction_range(dim, theta, rs)
    want = []
    for i in range(dim // 2):
        extra = theta ** (-2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    got = layers.yarn_freqs(dim, theta, rs, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=2e-6)
    assert got[0] == 1.0 and got[-1] == pytest.approx(theta ** (-62 / 64) / 40, rel=1e-6)
    # the same formula in another float32 order: a few ulps apart
    np.testing.assert_allclose(ref.inv_freq(dim, theta, dataclasses.asdict(rs)).numpy(),
                               got.numpy(), rtol=1e-6)
    m = 0.1 * math.log(40) + 1
    assert layers.yarn_get_mscale(40, 1.0) == pytest.approx(m) and round(m, 4) == 1.3689
    assert attn._mla_scale(get_config(ARCH)) == pytest.approx(m * m / math.sqrt(192))
    assert attn._mla_scale(get_config(ARCH).scaled(rope_scaling=None)) == 1 / math.sqrt(192)


def test_yarn_rotates_positions_past_the_original_context():
    """At position 0 nothing rotates; YaRN and plain RoPE agree in the dims
    before the ramp and differ past it."""
    rs = get_config(ARCH).rope_scaling
    x = torch.randn(1, 3, 2, 64, generator=torch.Generator().manual_seed(3))
    pos = torch.tensor([[0, 5000, 100000]])
    y, plain = layers.apply_rope(x, pos, 1e4, rs), layers.apply_rope(x, pos, 1e4)
    assert torch.equal(y[:, 0], x[:, 0])
    torch.testing.assert_close(y[..., :10], plain[..., :10])
    assert not torch.allclose(y[..., 24:32], plain[..., 24:32])


# ----------------------------------------------------------------------
# Expert parallelism's share
def _since(before: torch.Tensor) -> list:
    """The (routed, held, dropped) pairs counted on the CPU since ``before``
    (a copy of ``moe.pair_counts``)."""
    return (moe.pair_counts("cpu") - before).tolist()


def _share_params(cfg, seed):
    p = init_params(cfg, seed, dtype=torch.float32, device="cpu")["layers"]["sub0"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    p["router_bias"] = torch.randn(p["router_bias"].shape,
                                   generator=torch.Generator().manual_seed(seed)) * BIAS_STD
    return p


@pytest.mark.parametrize("tokens", [1, 40])
def test_expert_shares_add_up_to_the_whole_layer(tokens):
    """Expert parallelism's share test: four shares of 4 of 16 experts each, the
    shared expert counted once, add up to the layer that holds all 16, which
    is the reference's; the capacity (of the router's width) drops the same
    pairs in a share as in the whole (a bias of 0.2 loads some experts past
    their capacity). A layer holds experts 0-3: share r is that layer with
    the router's columns turned by r groups of 4, which moves expert 4r to
    column 0 and keeps every group whole."""
    m = dataclasses.replace(get_smoke_config(ARCH).moe, num_experts=16, top_k=4,
                            n_group=4, topk_group=2)
    whole_cfg = get_smoke_config(ARCH).scaled(moe=m, dtype="float32")
    p = _share_params(whole_cfg, 7)
    p["router_bias"] *= 10
    x = torch.randn(2, tokens, whole_cfg.d_model, generator=torch.Generator().manual_seed(8))
    before = moe.pair_counts("cpu").clone()
    whole = moe.moe_apply(whole_cfg, p, x)
    dropped = _since(before)[2]
    shared = (F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])) @ p["ws_down"]
    share_cfg = whole_cfg.scaled(moe=dataclasses.replace(m, num_experts=4, num_routed=16))
    total = shared.clone()
    for r in range(4):
        held = {k: (v[4 * r:4 * r + 4] if k.startswith("we_") else v) for k, v in p.items()}
        held["w_router"] = p["w_router"].roll(-4 * r, dims=1)
        held["router_bias"] = p["router_bias"].roll(-4 * r)
        total += moe.moe_apply(share_cfg, held, x) - shared
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
    want = ref.moe_layer(x, p, dataclasses.asdict(m), [slice(0, tokens)])
    torch.testing.assert_close(whole, want, rtol=1e-5, atol=1e-5)
    assert (dropped > 0) == (tokens > 1)


def test_a_share_routes_over_every_expert_and_counts_its_pairs():
    m = dataclasses.replace(get_smoke_config(ARCH).moe, num_experts=4, num_routed=16,
                            top_k=4, n_group=4, topk_group=2)
    cfg = get_smoke_config(ARCH).scaled(moe=m, dtype="float32")
    p = _share_params(cfg, 9)
    assert p["w_router"].shape == (cfg.d_model, 16) and p["we_gate"].shape[0] == 4
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(10))
    before, syncs = moe.pair_counts("cpu").clone(), dict(trace.counts)
    moe.moe_apply(cfg, p, x)
    got = _since(before)
    _, idx = moe.route_grouped(cfg, x.reshape(80, -1) @ p["w_router"], p["router_bias"])
    held = int((idx < 4).sum())
    per_expert = torch.bincount(idx[idx < 4], minlength=4)
    dropped = int((per_expert - moe.capacity(80, 16, 4)).clamp_min(0).sum())
    assert got == [320, held, dropped]
    assert trace.counts_since(syncs) == {}          # counted on the device, no sync


# ----------------------------------------------------------------------
# Mixtral's routing and phi4's RoPE as they were, bit for bit
def _old_route_topk(cfg, router_logits):
    m = cfg.moe
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = moe._topk(probs, m.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return gate_vals * m.router_scale, gate_idx


def _old_moe_apply(cfg, p, x):
    """``moe_apply`` before the published router and the EP share."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    e, k = m.num_experts, m.top_k
    router_logits = x2 @ p["w_router"].to(x.dtype)
    gates, idx = _old_route_topk(cfg, router_logits)
    c = moe.capacity(t, e, k)
    flat_e = idx.reshape(t * k)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_g = gates.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    first = torch.searchsorted(se, torch.arange(e, device=x.device), side="left")
    pos = torch.arange(t * k, device=x.device) - first[se]
    keep = pos < c
    slot = torch.where(keep, se * c + pos, torch.full_like(se, e * c - 1))
    buf = x.new_zeros((e * c, d))
    buf[slot[keep]] = x2[st[keep]]
    buf = buf.reshape(e, c, d)
    h = F.silu(torch.bmm(buf, p["we_gate"].to(x.dtype)))
    h = h * torch.bmm(buf, p["we_up"].to(x.dtype))
    y = torch.bmm(h, p["we_down"].to(x.dtype)).reshape(e * c, d)
    contrib = y[slot] * (sg * keep).to(x.dtype)[:, None]
    out = x.new_zeros((t, d)).index_add_(0, st, contrib)
    if m.num_shared_experts:
        hs = F.silu(x2 @ p["ws_gate"].to(x.dtype)) * (x2 @ p["ws_up"].to(x.dtype))
        out = out + hs @ p["ws_down"].to(x.dtype)
    return out.reshape(b, s, d)


def _old_apply_rope(x, positions, theta):
    head_dim = x.shape[-1]
    freqs = layers.rope_freqs(head_dim, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _aten_ops(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events() if e.name.startswith("aten::")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 48])
def test_mixtral_routing_is_unchanged_bit_for_bit(dtype, tokens):
    """A mixtral-shaped layer (8 experts, top-2, softmax; 48 tokens a row
    overflow an expert's capacity) gives the old layer's output bit for bit:
    the one dispatch, holding every expert, is the old whole layer."""
    cfg = get_smoke_config("mixtral-8x7b").scaled(
        moe=dataclasses.replace(get_smoke_config("mixtral-8x7b").moe, num_experts=8))
    p = {k: v[0].to(dtype) for k, v in
         init_params(cfg, 3, device="cpu")["layers"]["sub0"]["moe"].items()}
    x = torch.randn(2, tokens, cfg.d_model, generator=torch.Generator().manual_seed(4)).to(dtype)
    assert torch.equal(moe.moe_apply(cfg, p, x), _old_moe_apply(cfg, p, x))
    gates, idx = moe.route_topk(cfg, x.reshape(-1, cfg.d_model) @ p["w_router"])
    old_gates, old_idx = _old_route_topk(cfg, x.reshape(-1, cfg.d_model) @ p["w_router"])
    assert torch.equal(gates, old_gates) and torch.equal(idx, old_idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phi4_rope_is_unchanged_bit_for_bit(dtype):
    cfg = get_config("phi4-mini-3.8b")
    assert cfg.rope_scaling is None
    x = torch.randn(2, 33, 4, cfg.head_dim, generator=torch.Generator().manual_seed(5)).to(dtype)
    pos = torch.arange(1000, 1033)[None].expand(2, -1)
    new, new_ops = _aten_ops(lambda: layers.apply_rope(x, pos, cfg.rope_theta))
    old, old_ops = _aten_ops(lambda: _old_apply_rope(x, pos, cfg.rope_theta))
    assert torch.equal(new, old) and new_ops == old_ops


# ----------------------------------------------------------------------
# The configuration
def test_the_published_configuration():
    cfg = get_config(ARCH)
    m = cfg.moe
    assert (m.num_experts, m.router_width, m.top_k, m.num_shared_experts) == (256, 256, 8, 1)
    assert (m.scoring, m.n_group, m.topk_group, m.router_scale) == ("sigmoid", 8, 4, 2.5)
    assert cfg.norm_eps == 1e-6 and cfg.vocab_size == 129280
    specs = moe.moe_param_specs(cfg)
    assert specs["router_bias"].shape == (256,) and specs["w_router"].shape == (7168, 256)
    cut = cfg.scaled(moe=dataclasses.replace(m, num_experts=8, num_routed=256))
    assert moe.moe_param_specs(cut)["we_gate"].shape == (8, 7168, 2048)
    assert moe.moe_param_specs(cut)["w_router"].shape == (7168, 256)


def test_a_configuration_read_from_mappings_holds_the_dataclasses():
    cfg = get_config(ARCH)
    again = get_config("phi4-mini-3.8b").scaled(
        **{f.name: (dataclasses.asdict(getattr(cfg, f.name))
                    if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
           for f in dataclasses.fields(cfg)})
    assert again == cfg and hash(again) == hash(cfg)
    with pytest.raises(ValueError):
        get_config("phi4-mini-3.8b").scaled(rope_scaling={"type": "yarn", "factor": 4.0})
    with pytest.raises(ValueError):
        dataclasses.replace(cfg.moe, scoring="softmax")          # groups need sigmoid
