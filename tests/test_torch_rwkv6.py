"""RWKV-6 "Finch" as published on the port's CPU path, at smoke size, against
the plain float32 reference ``torch_ref_rwkv6``: the full forward on both
recurrence routes, the engine's prefill and every decode step through the
carried state, each published part shown to be load-bearing, the parameter
count against the parameter tree, the JAX package's form through
``jax_form``, and the ``wkv_tokens`` counter and ``rwkv.*`` profiler ranges."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ref_rwkv6 as ref
from _torch_util import jax_form, numpy_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.variants import VariantPool
from repro_torch.models import forward
from repro_torch.models import model as model_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Engine, EngineConfig

ARCH = "rwkv6-1.6b"
PROMPT, STEPS = 12, 5
# fp32 against fp32 through a recurrence: the repository's 5e-5, x4
TOL = 5e-5 * 4


def _case(level, seed):
    cfg = VariantPool(get_smoke_config(ARCH))[level].config.scaled(dtype="float32")
    params = params_from_jax(cfg, numpy_params(cfg, seed=seed), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        1, cfg.vocab_size, (2, PROMPT + STEPS)))
    return cfg, params, toks


def _want(cfg, params, toks):
    return ref.forward(dataclasses.asdict(cfg), params, toks)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["loop", "k4"])
@pytest.mark.parametrize("level", [0, 5])
def test_forward_matches_the_reference(level, use_kernels):
    cfg, params, toks = _case(level, 20 + level)
    assert cfg.ssm.token_shift_lora == 8 and cfg.norm_kind == "layer" and cfg.embed_norm
    with torch.inference_mode():
        got, _ = forward(cfg, params, toks, use_kernels=use_kernels)
    torch.testing.assert_close(got, _want(cfg, params, toks), rtol=TOL, atol=TOL)


def _served(cfg, params, toks):
    """The engine's prefill of the prompt, then one decode step a token of the
    rest: logits at positions PROMPT - 1 .. PROMPT + STEPS - 2."""
    eng = Engine(cfg, params, EngineConfig(max_len=PROMPT + STEPS), device="cpu")
    logits, caches, lengths = eng.prefill(toks[:, :PROMPT])
    got = [logits]
    for i in range(STEPS - 1):
        logits, caches, lengths = eng.decode(caches, lengths, toks[:, PROMPT + i])
        got.append(logits)
    return torch.stack(got, 1)


@pytest.mark.parametrize("level", [0, 5])
def test_prefill_and_decode_match_the_full_forward(level):
    cfg, params, toks = _case(level, 30 + level)
    want = _want(cfg, params, toks)[:, PROMPT - 1:PROMPT + STEPS - 1]
    torch.testing.assert_close(_served(cfg, params, toks), want, rtol=TOL, atol=TOL)


def _no_lora(cfg, params):
    for u in params["layers"]["sub0"]["rwkv"]["maa_w1"]:
        u.zero_()
    return cfg


def _one_layer_norm(cfg, params):
    return cfg.scaled(ssm=dataclasses.replace(cfg.ssm, head_norm_eps=0.0))


def _no_bias(cfg, params):
    sub = params["layers"]["sub0"]
    for t in (sub["norm_mixer_bias"], sub["norm_mlp_bias"], params["embed_norm_bias"],
              params["final_norm_bias"]):
        t.zero_()
    return cfg


@pytest.mark.parametrize("drop", [_no_lora, _one_layer_norm, _no_bias],
                         ids=["token-shift-lora", "group-norm", "block-norm-bias"])
def test_each_published_part_is_load_bearing(drop):
    """With one published part taken out of the program, its logits leave
    the reference's by far more than the tolerance."""
    cfg, params, toks = _case(0, 40)
    want = _want(cfg, params, toks)
    cfg = drop(cfg, params)
    with torch.inference_mode():
        got, _ = forward(cfg, params, toks, use_kernels=True)
    assert (got - want).abs().max() > 100 * TOL


@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_count_is_the_parameter_tree(size, level):
    """The published form's count is the sum over the tree (the channel mix
    once); the JAX package's form keeps its inherited figure."""
    base = (get_config if size == "full" else get_smoke_config)(ARCH)
    cfg = VariantPool(base)[level].config
    tree = model_lib.abstract_params(cfg)
    n = sum(t.numel() for g in _leaves(tree) for t in [g])
    assert cfg.param_count() == cfg.param_count(active_only=True) == n
    if size == "full" and level == 0:
        assert round(n / 1e9, 2) == 1.60
    assert jax_form(cfg).param_count() != n


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield v


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_jax_form_is_the_published_tree_less_its_new_leaves():
    cfg = get_config(ARCH)
    pub, old = _flat(model_lib.abstract_params(cfg)), _flat(model_lib.abstract_params(
        jax_form(cfg)))
    new = {"embed_norm", "embed_norm_bias", "final_norm_bias",
           "layers.sub0.norm_mixer_bias", "layers.sub0.norm_mlp_bias",
           "layers.sub0.rwkv.maa_x", "layers.sub0.rwkv.maa_w1", "layers.sub0.rwkv.maa_w2"}
    assert set(pub) - set(old) == new and set(old) <= set(pub)
    assert {k: pub[k] for k in old} == old
    assert pub["layers.sub0.rwkv.maa_w1"] == (24, 2048, 160)
    assert pub["layers.sub0.rwkv.maa_w2"] == (24, 5, 32, 2048)
    assert pub["layers.sub0.rwkv.decay_a"] == (24, 2048, 64)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["k4", "loop"])
def test_generate_counts_the_recurrence_routes(use_kernels):
    """``wkv_tokens``: the prefill's token-layers on K4 (or on the loop
    without kernels), each decode step's on the one-step update."""
    cfg, params, toks = _case(0, 50)
    eng = Engine(cfg, params, EngineConfig(max_len=PROMPT + STEPS, use_kernels=use_kernels),
                 device="cpu")
    eng.generate(toks[:, :PROMPT].numpy(), num_steps=STEPS)
    b, layers = toks.shape[0], cfg.num_layers
    prefill = b * PROMPT * layers
    want = ({"kernel": prefill, "step": b * STEPS * layers} if use_kernels
            else {"kernel": 0, "step": prefill + b * STEPS * layers})
    assert eng.last_stats["wkv_tokens"] == want
    assert eng.last_stats["syncs"] == {"engine.upload": 1, "engine.collect": 2}


def test_models_without_rwkv_count_no_wkv_tokens():
    cfg = get_smoke_config("phi4-mini-3.8b").scaled(dtype="float32")
    eng = Engine(cfg, model_lib.init_params(cfg, 0, device="cpu"),
                 EngineConfig(max_len=16), device="cpu")
    eng.generate(np.ones((1, 4), np.int64), num_steps=2)
    assert "wkv_tokens" not in eng.last_stats


def test_profiler_sees_the_rwkv_ranges_in_prefill_and_decode():
    cfg, params, toks = _case(0, 60)
    eng = Engine(cfg, params, EngineConfig(max_len=PROMPT + STEPS), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate(toks[:, :PROMPT].numpy(), num_steps=2)
    counts = {e.key: e.count for e in prof.key_averages()}
    # per layer: one of each in the prefill and in each of the 2 steps
    for name in ("rwkv.time_mix", "rwkv.wkv", "rwkv.channel_mix"):
        assert counts.get(name) == 3 * cfg.num_layers, (name, counts.get(name))
