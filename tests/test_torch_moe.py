"""Port MoE on the CPU against the JAX package's ``repro.models.moe``:
``capacity``, top-k routing (ties to the lower index), sort-based dispatch
with tokens dropped past an expert's capacity, shared experts, and the
load-balance aux loss, on the same numpy weights and inputs (fp32).
Tolerance 5e-5, the reference's fp32 kernel tolerance: both sides compute the
same products in the same dtype. Also the dispatch without a host sync
against the one that had it (kept in this file as the oracle): outputs,
device-side pair counts and gradients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

from _torch_util import as_np, jax_form

TOL = 5e-5
MOE_ARCHS = ["jamba-1.5-large-398b", "mixtral-8x7b", "deepseek-v3-671b"]


@pytest.mark.parametrize("t,e,k", [(1, 4, 2), (8, 8, 2), (8, 8, 1), (64, 4, 2),
                                   (4096, 8, 2), (4096, 16, 2), (100, 256, 8),
                                   (7, 3, 2), (640, 8, 1)])
def test_capacity_matches_jax(t, e, k):
    c = moe.capacity(t, e, k)
    assert c == jmoe.capacity(t, e, k)
    assert c % 8 == 0 and c >= 8
    assert c >= t * k * moe.CAPACITY_FACTOR / e


def _logits(seed, t, e):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_topk_matches_jax(arch):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    logits = _logits(1, 50, cfg.moe.num_experts)
    gates, idx = moe.route_topk(cfg, torch.from_numpy(logits))
    j_gates, j_idx = jmoe.route_topk(jax_smoke_config(arch), jnp.asarray(logits))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(j_gates), atol=TOL, rtol=TOL)
    assert idx.shape == (50, cfg.moe.top_k)
    np.testing.assert_allclose(gates.sum(-1).numpy(), cfg.moe.router_scale, rtol=1e-6)


def test_route_topk_ties_go_to_the_lower_index():
    """Equal router logits give equal probabilities; ``jax.lax.top_k`` puts
    the lower expert first, and so must the port."""
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    logits = np.array([[0.0, 1.0, 1.0, 1.0],      # three-way tie for the top
                       [2.0, 0.5, 2.0, 0.5],      # tie at the top, tie below
                       [0.0, 0.0, 0.0, 0.0],      # all equal
                       [1.0, 3.0, 1.0, 1.0]],     # tie for second place
                      np.float32)
    _, idx = moe.route_topk(cfg, torch.from_numpy(logits))
    _, j_idx = jmoe.route_topk(jax_smoke_config("mixtral-8x7b"), jnp.asarray(logits))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert idx.tolist() == [[1, 2], [0, 2], [0, 1], [1, 0]]


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in moe.moe_param_specs(cfg).items():
        fan_in = spec.shape[0] if len(spec.shape) == 2 else spec.shape[1]
        out[name] = (rng.standard_normal(spec.shape) * spec.scale
                     / np.sqrt(fan_in)).astype(np.float32)
    return out


def _both_apply(arch, params, x):
    cfg = jax_form(get_smoke_config(arch)).scaled(dtype="float32")
    got = moe.moe_apply(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x))
    want = jmoe.moe_apply(jax_smoke_config(arch).scaled(dtype="float32"),
                          {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return got, want


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch):
    """Sort-based dispatch on random routing (jamba and mixtral smoke;
    deepseek's MoE layer brings a shared expert and ``router_scale``)."""
    cfg = jax_form(get_smoke_config(arch))
    params = _moe_params(cfg, 2)
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    got, want = _both_apply(arch, params, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL, rtol=TOL)
    if cfg.moe.num_shared_experts:
        assert {"ws_gate", "ws_up", "ws_down"} <= set(params)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mixtral-8x7b"])
def test_moe_apply_drops_past_capacity(arch):
    """Every token routed to experts 0 and 1: each gets T = 64 assignments
    for a capacity of 40, so in the stable order tokens 40..63 are dropped
    by both and come out exactly 0, as in the JAX package."""
    cfg = get_smoke_config(arch)
    e, d = cfg.moe.num_experts, cfg.d_model
    params = _moe_params(cfg, 4)
    params["w_router"] = np.zeros((d, e), np.float32)
    params["w_router"][0, 0], params["w_router"][0, 1] = 5.0, 4.0
    rng = np.random.default_rng(5)
    x = (0.1 * rng.standard_normal((2, 32, d))).astype(np.float32)
    x[..., 0] = 3.0
    t = x.shape[0] * x.shape[1]
    assert moe.capacity(t, e, cfg.moe.top_k) == 40
    got, want = _both_apply(arch, params, x)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL, rtol=TOL)
    flat = as_np(got).reshape(t, d)
    assert np.abs(flat[:40]).sum(axis=1).min() > 0
    assert np.all(flat[40:] == 0.0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_load_balance_loss_matches_jax(arch):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    logits = _logits(6, 3 * 16, cfg.moe.num_experts)
    got = moe.aux_load_balance_loss(cfg, torch.from_numpy(logits))
    want = jmoe.aux_load_balance_loss(jax_smoke_config(arch), jnp.asarray(logits))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_shard_activation_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert moe.shard_activation(x, ("experts", None, None)) is x


@pytest.mark.parametrize("b,s", [(8, 1), (8, 512)], ids=["T8-decode", "T4096-prefill"])
def test_moe_apply_at_deepseek_routing_matches_jax(b, s):
    """deepseek-v3's routing at its published counts (256 experts, top-8,
    one shared expert, ``router_scale`` 2.5) at a narrow width, at the cut
    deepseek's decode (T = 8, capacity 8) and prefill (T = 4096, capacity
    160) token counts."""
    import dataclasses
    from repro_torch.configs import get_config

    full = get_config("deepseek-v3-671b").moe
    assert (full.num_experts, full.top_k, full.num_shared_experts) == (256, 8, 1)
    narrow = dataclasses.replace(full, d_ff_expert=16)
    cfg = jax_form(get_smoke_config("deepseek-v3-671b").scaled(d_model=32, moe=narrow,
                                                               dtype="float32"))
    jcfg = jax_smoke_config("deepseek-v3-671b").scaled(
        d_model=32, moe=dataclasses.replace(jax_smoke_config("deepseek-v3-671b").moe,
                                            num_experts=256, top_k=8, d_ff_expert=16),
        dtype="float32")
    params = _moe_params(cfg, 7)
    x = np.random.default_rng(8).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    got = moe.moe_apply(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x))
    want = jmoe.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x))
    assert moe.capacity(b * s, 256, 8) == (8 if s == 1 else 160)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL, rtol=TOL)


# ----------------------------------------------------------------------
# The dispatch without a host sync, against the dispatch that had one
def _synced_dispatch(p, x2, gates, idx, e, k, width):
    """The dispatch as it was before it lost its host sync: the kept pairs
    counted on the host and gathered by a slice of that length. Returns the
    output and the (routed, held, dropped) pairs."""
    t, d = x2.shape
    c = moe.capacity(t, width, k)
    flat_e = idx.reshape(t * k).clamp(max=e)
    flat_t = torch.arange(t).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], gates.reshape(t * k)[order]
    first = torch.searchsorted(se, torch.arange(e + 1), side="left")
    pos = torch.arange(t * k) - first[se]
    keep = (se < e) & (pos < c)
    kept = torch.argsort((~keep).to(torch.uint8), stable=True)
    n_held, n_kept = torch.stack([first[e], keep.sum()]).tolist()
    kept = kept[:n_kept]
    st, sg, slot = st[kept], sg[kept], (se * c + pos)[kept]
    buf = x2.new_zeros((e * c, d))
    buf[slot] = x2[st]
    buf = buf.reshape(e, c, d)
    h = F.silu(torch.bmm(buf, p["we_gate"].to(x2.dtype)))
    h = h * torch.bmm(buf, p["we_up"].to(x2.dtype))
    y = torch.bmm(h, p["we_down"].to(x2.dtype)).reshape(e * c, d)
    out = x2.new_zeros((t, d)).index_add_(0, st, y[slot] * sg.to(x2.dtype)[:, None])
    return out, [t * k, n_held, n_held - n_kept]


D, F_EXP = 16, 24


def _experts(e, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"we_gate": torch.randn(e, D, F_EXP, generator=g).to(dtype) / 4,
            "we_up": torch.randn(e, D, F_EXP, generator=g).to(dtype) / 4,
            "we_down": torch.randn(e, F_EXP, D, generator=g).to(dtype) / 5}


def _softmax_routing(t, width, seed, skew=0.0, k=2):
    """Top-k softmax routing over ``width`` experts of random logits; ``skew``
    added to experts 0 and 1 sends most pairs to them (past capacity)."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(t, width, generator=g)
    logits[:, :2] += skew
    vals, idx = moe._topk(torch.softmax(logits, -1), k)
    return vals / vals.sum(-1, keepdim=True), idx


def _both(p, x2, gates, idx, e, k, width):
    before = moe.pair_counts("cpu").clone()
    got = moe._dispatch(p, x2, gates, idx, e, k, width)
    counted = (moe.pair_counts("cpu") - before).tolist()
    want, counts = _synced_dispatch(p, x2, gates, idx, e, k, width)
    assert counted == counts
    return got, want, counts


# (held experts, router width, skew): all held; all held and crowded onto two
# experts (drops at capacity); 8 of 16 held (absent experts)
TOP2 = {"held": (8, 8, 0.0), "drops": (8, 8, 6.0), "absent": (8, 16, 0.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 40, 256])
@pytest.mark.parametrize("kind", sorted(TOP2))
def test_dispatch_equals_the_synced_dispatch_at_top2_bit_for_bit(kind, t, dtype):
    e, width, skew = TOP2[kind]
    p = _experts(e, t, dtype)
    x2 = torch.randn(t, D, generator=torch.Generator().manual_seed(100 + t)).to(dtype)
    gates, idx = _softmax_routing(t, width, t, skew)
    got, want, (routed, held, dropped) = _both(p, x2, gates, idx, e, 2, width)
    assert got.dtype == dtype and torch.equal(got, want)
    assert routed == 2 * t and (held == routed) == (width == e)
    if kind == "drops" and t >= 40:
        assert dropped > 0
    if kind == "absent":
        assert held < routed or t < 3


@pytest.mark.parametrize("held", [8, 256], ids=["ep-share", "whole"])
@pytest.mark.parametrize("t", [1, 8, 40, 256])
def test_dispatch_matches_the_synced_dispatch_at_deepseek_top8(t, held):
    """deepseek's sigmoid group-limited top-8 over 256 experts, holding 8 of
    them (the cut deepseek's EP share: most pairs absent) or all 256."""
    import dataclasses
    from repro_torch.configs import get_config

    m = dataclasses.replace(get_config("deepseek-v3-671b").moe, num_experts=held,
                            num_routed=256 if held < 256 else 0)
    cfg = get_smoke_config("deepseek-v3-671b").scaled(d_model=D, moe=m, dtype="float32")
    g = torch.Generator().manual_seed(t)
    logits = torch.randn(t, 256, generator=g)
    gates, idx = moe.route_grouped(cfg, logits, torch.randn(256, generator=g) / 10)
    p = _experts(held, t)
    x2 = torch.randn(t, D, generator=g)
    got, want, (routed, n_held, dropped) = _both(p, x2, gates, idx, held, 8, 256)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert routed == 8 * t and (n_held == routed) == (held == 256)


@pytest.mark.parametrize("t", [1, 8, 64])
def test_dispatch_with_no_pair_held(t):
    """Every pair routed to an absent expert: the output is 0, nothing held."""
    e, width = 4, 16
    idx = torch.randint(e, width, (t, 2), generator=torch.Generator().manual_seed(t))
    gates = torch.full((t, 2), 0.5)
    x2 = torch.randn(t, D)
    got, want, counts = _both(_experts(e, 1), x2, gates, idx, e, 2, width)
    assert torch.equal(got, torch.zeros(t, D)) and torch.equal(want, got)
    assert counts == [2 * t, 0, 0]


@pytest.mark.parametrize("case", ["top2-held", "top2-drops", "top2-absent", "top8-absent"])
def test_dispatch_gradients_equal_the_synced_dispatch(case):
    """Gradients of the tokens, the gates and the three expert weights in
    fp32: the dropped and absent pairs' gates get none, as before."""
    t = 48
    if case.startswith("top2"):
        e, width, skew = TOP2[case.split("-")[1]]
        k = 2
    else:
        e, width, skew, k = 8, 32, 0.0, 8
    gates, idx = _softmax_routing(t, width, 7, skew, k=k)
    params = _experts(e, 8)
    x2 = torch.randn(t, D, generator=torch.Generator().manual_seed(9))
    grads = []
    for fn in (moe._dispatch, lambda *a: _synced_dispatch(*a)[0]):
        p = {n: v.clone().requires_grad_() for n, v in params.items()}
        xg, gg = x2.clone().requires_grad_(), gates.clone().requires_grad_()
        out = fn(p, xg, gg, idx, e, k, width)
        (out * torch.linspace(-1, 1, D)).square().sum().backward()
        grads.append([xg.grad, gg.grad] + [p[n].grad for n in sorted(p)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert grads[0][1].abs().sum() > 0
