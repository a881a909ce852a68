"""MLA (DeepSeek-V3's multi-head latent attention) on the CPU, port against
the JAX package on the same numpy-made inputs and weights: the dense path
(train / prefill), the weight-absorbed decode with the cache written at
``lengths`` (the last slot included), and ``pad_caches``; then the absorbed
decode against the dense path on the port alone, the deepseek smoke engine
against the JAX engine, and the depth cut that leaves a group of zero
units. Tolerances are the reference's own: 5e-5 in fp32, 2e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import pad_caches as jax_pad_caches
from repro_torch.configs import get_smoke_config
from repro_torch.core.variants import VariantPool
from repro_torch.models import attention as attn
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Engine, EngineConfig, pad_caches

from _torch_util import as_np, numpy_params, to_jax, to_torch, tree_to_jax

ARCH = "deepseek-v3-671b"
TOL = {False: 5e-5, True: 2e-2}


def _cfgs(bf16):
    dt = "bfloat16" if bf16 else "float32"
    return get_smoke_config(ARCH).scaled(dtype=dt), jax_smoke_config(ARCH).scaled(dtype=dt)


def _mla_params(cfg, seed):
    """One MLA layer's parameters as float32 numpy arrays (norm scales with
    noise, so that a swapped or dropped scale shows)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in attn.mla_param_specs(cfg).items():
        if spec.init == "ones":
            out[name] = (1.0 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(spec.shape)
                         / np.sqrt(spec.shape[0])).astype(np.float32)
    return out


def _both(tree, bf16):
    return ({k: to_torch(v, bf16) for k, v in tree.items()},
            {k: to_jax(v, bf16) for k, v in tree.items()})


def _close(got, want, bf16):
    tol = TOL[bf16]
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_mla_dense_matches_jax(bf16):
    cfg, jcfg = _cfgs(bf16)
    b, s = 2, 24
    p, jp = _both(_mla_params(cfg, 1), bf16)
    x = np.random.default_rng(2).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s)[None, :]
    want, wcache = jattn.mla_attention_dense(jcfg, jp, to_jax(x, bf16), jnp.asarray(pos))
    got, cache = attn.mla_attention_dense(cfg, p, to_torch(x, bf16), torch.from_numpy(pos))
    assert isinstance(cache, attn.MLACache)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == to_torch(x, bf16).dtype
    assert cache.latent.shape == (b, s, cfg.mla.kv_lora_rank)
    assert cache.k_rope.shape == (b, s, cfg.mla.qk_rope_head_dim)
    _close(got, want, bf16)
    _close(cache.latent, wcache.latent, bf16)
    _close(cache.k_rope, wcache.k_rope, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lengths", [[5, 19], [0, 3], [19, 12]],
                         ids=["mid", "first-slot", "last-slot"])
def test_mla_decode_matches_jax(bf16, lengths):
    """One absorbed decode step over a cache holding random rows: the
    output, and the latent and rope-key rows written at ``lengths`` (slot
    19 is the cache's last), in place."""
    cfg, jcfg = _cfgs(bf16)
    b, s_cache = 2, 20
    m = cfg.mla
    p, jp = _both(_mla_params(cfg, 3), bf16)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    lat = rng.standard_normal((b, s_cache, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, s_cache, m.qk_rope_head_dim)).astype(np.float32)
    lens = np.asarray(lengths)
    want, wcache = jattn.mla_attention_decode(
        jcfg, jp, to_jax(x, bf16), jattn.MLACache(to_jax(lat, bf16), to_jax(kr, bf16)),
        jnp.asarray(lens, jnp.int32))
    cache = attn.MLACache(to_torch(lat, bf16), to_torch(kr, bf16))
    latent_in = cache.latent
    got, out_cache = attn.mla_attention_decode(cfg, p, to_torch(x, bf16), cache,
                                               torch.from_numpy(lens))
    assert out_cache.latent is latent_in                  # written in place
    assert got.shape == (b, 1, cfg.d_model)
    _close(got, want, bf16)
    _close(out_cache.latent, wcache.latent, bf16)
    _close(out_cache.k_rope, wcache.k_rope, bf16)
    for row, n in enumerate(lens):                        # only slot n changed
        keep = np.arange(s_cache) != n
        np.testing.assert_array_equal(as_np(out_cache.latent)[row, keep],
                                      as_np(to_torch(lat, bf16))[row, keep])


def test_mla_absorbed_decode_equals_dense_last_position():
    """The weight absorption itself: prefill S-1 tokens, pad the cache, one
    decode step, against the dense path over S tokens at the last position
    (fp32; equal in exact arithmetic, not in rounding)."""
    cfg, _ = _cfgs(False)
    p = {k: to_torch(v) for k, v in _mla_params(cfg, 5).items()}
    b, s = 3, 17
    x = to_torch(np.random.default_rng(6).standard_normal((b, s, cfg.d_model)))
    full, _ = attn.mla_attention_dense(cfg, p, x, torch.arange(s)[None])
    _, raw = attn.mla_attention_dense(cfg, p, x[:, :-1], torch.arange(s - 1)[None])
    cache = attn.init_mla_cache(cfg, b, 24, torch.float32, device="cpu")
    cache.latent[:, :s - 1] = raw.latent
    cache.k_rope[:, :s - 1] = raw.k_rope
    step, _ = attn.mla_attention_decode(cfg, p, x[:, -1:], cache,
                                        torch.full((b,), s - 1))
    scale = float(full[:, -1].abs().max())
    np.testing.assert_allclose(as_np(step[:, 0]), as_np(full[:, -1]),
                               atol=5e-5 * max(1.0, scale), rtol=5e-5)


def _raw_mla_caches(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return {g.name: {"sub0": (rng.standard_normal((g.n_units, b, s, m.kv_lora_rank)),
                              rng.standard_normal((g.n_units, b, s, m.qk_rope_head_dim)))}
            for g in tfm.layer_plan(cfg)}


@pytest.mark.parametrize("s,max_len", [(7, 16), (16, 16)])
def test_pad_caches_mla_matches_jax(s, max_len):
    """Axis 2 of the stacked (L, B, S, r) latent and (L, B, S, rope) key is
    zero-padded to ``max_len``, as the JAX engine pads it."""
    cfg, jcfg = _cfgs(False)
    raw = _raw_mla_caches(cfg, 2, s, 7)
    got = pad_caches(cfg, {g: {k: attn.MLACache(*(to_torch(a) for a in v))
                               for k, v in u.items()} for g, u in raw.items()},
                     s, max_len)
    want = jax_pad_caches(jcfg, {g: {k: jattn.MLACache(*(to_jax(a) for a in v))
                                     for k, v in u.items()} for g, u in raw.items()},
                          s, max_len)
    for g in raw:
        c, w = got[g]["sub0"], want[g]["sub0"]
        assert isinstance(c, attn.MLACache)
        assert c.latent.shape[2] == c.k_rope.shape[2] == max_len
        np.testing.assert_array_equal(as_np(c.latent), as_np(w.latent))
        np.testing.assert_array_equal(as_np(c.k_rope), as_np(w.k_rope))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_deepseek_engine_logits_match_jax(use_kernels):
    """The port's engine against the JAX engine on the same weights: the
    prefill logits and each decode step's, which writes the latent caches in
    place. (Against the full forward the MoE layers would differ: a long
    sequence overflows an expert's capacity and drops tokens that a one-token
    step keeps, in both packages.)"""
    cfg, jcfg = _cfgs(False)
    tree = numpy_params(cfg, seed=9)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 11))
    jeng = JaxEngine(jcfg, tree_to_jax(tree), JaxEngineConfig(max_len=16))
    eng = Engine(cfg, params_from_jax(cfg, tree, device="cpu"),
                 EngineConfig(max_len=16, use_kernels=use_kernels), device="cpu")
    want, jcaches, jlengths = jeng.prefill(jnp.asarray(toks, jnp.int32))
    logits, caches, lengths = eng.prefill(toks)
    c = caches["dense_layers"]["sub0"]
    assert isinstance(c, attn.MLACache)
    assert c.latent.shape == (cfg.num_dense_layers, 2, 16, cfg.mla.kv_lora_rank)
    latent = caches["layers"]["sub0"].latent
    for _ in range(4):
        np.testing.assert_allclose(as_np(logits), as_np(want), atol=5e-4, rtol=5e-4)
        nxt = np.asarray(want).argmax(-1)
        want, jcaches, jlengths = jeng.decode(jcaches, jlengths, jnp.asarray(nxt, jnp.int32))
        logits, caches, lengths = eng.decode(caches, lengths, torch.from_numpy(nxt))
        assert caches["layers"]["sub0"].latent is latent
    np.testing.assert_allclose(as_np(logits), as_np(want), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(as_np(caches["layers"]["sub0"].latent),
                               as_np(jcaches["layers"]["sub0"].latent), atol=5e-5, rtol=5e-5)
    assert lengths.tolist() == [15, 15]


def test_depth_cut_to_the_dense_prelude_serves():
    """The variant ladder's deepest levels cut deepseek to its dense
    layers, which leaves the MoE group with zero units (at full width: 4 ->
    3 layers, all dense). Prefill gives that group zero-length caches;
    decode from an empty cache and from the prefill equal the forward."""
    cfg, _ = _cfgs(False)
    cut = cfg.scaled(num_layers=cfg.num_dense_layers)
    assert [g.n_units for g in tfm.layer_plan(cut)] == [cfg.num_dense_layers, 0]
    full = get_smoke_config(ARCH).scaled(num_layers=4, num_dense_layers=3)
    levels = VariantPool(full)
    assert [g.n_units for g in tfm.layer_plan(levels[5].config)] == [3, 0]
    params = init_params(cut, 11, device="cpu")
    assert params["layers"]["sub0"]["attn"]["wo"].shape[0] == 0
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, cut.vocab_size, (2, 9)))
    eng = Engine(cut, params, EngineConfig(max_len=12), device="cpu")
    logits, caches, lengths = eng.prefill(toks)
    assert caches["layers"]["sub0"].latent.shape == (0, 2, 12, cut.mla.kv_lora_rank)
    nxt = logits.argmax(-1)
    step, _, _ = eng.decode(caches, lengths, nxt)
    with torch.inference_mode():
        ref, _ = forward(cut, params, torch.cat([toks, nxt[:, None]], dim=1))
        empty = init_cache(cut, 2, 12, dtype=torch.float32, device="cpu")
        first, _, _ = decode_step(cut, params, empty, torch.zeros(2, dtype=torch.long),
                                  toks[:, 0])
        ref0, _ = forward(cut, params, toks[:, :1])
    np.testing.assert_allclose(as_np(step), as_np(ref[:, -1]), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(as_np(first), as_np(ref0[:, 0]), atol=5e-4, rtol=5e-4)
