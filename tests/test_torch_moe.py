"""Port MoE on the CPU against the JAX package's ``repro.models.moe``:
``capacity``, top-k routing (ties to the lower index), sort-based dispatch
with tokens dropped past an expert's capacity, shared experts, and the
load-balance aux loss, on the same numpy weights and inputs (fp32).
Tolerance 5e-5, the reference's fp32 kernel tolerance: both sides compute the
same products in the same dtype."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

from _torch_util import as_np

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
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    got = moe.moe_apply(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x))
    want = jmoe.moe_apply(jax_smoke_config(arch).scaled(dtype="float32"),
                          {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return got, want


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch):
    """Sort-based dispatch on random routing (jamba and mixtral smoke;
    deepseek's MoE layer brings a shared expert and ``router_scale``)."""
    cfg = get_smoke_config(arch)
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
    cfg = get_smoke_config("deepseek-v3-671b").scaled(d_model=32, moe=narrow,
                                                      dtype="float32")
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
