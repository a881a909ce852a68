"""Port models on the CPU: ``forward`` logits against ``repro.models.forward``
on the same weights (made with numpy from a seed, converted for both sides),
fp32 smoke configs, both ``use_kernels`` settings of the port; and the
JAX -> torch parameter converter. Tolerance 5e-4, the reference's own for
end-to-end logits."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.attention import gqa_scores_softmax as jax_gqa_scores_softmax
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke_config as _port_smoke_config
from repro_torch.models import forward, init_params
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import gqa_scores_softmax
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import ParamSpec

from _torch_util import (as_np, jax_form, numpy_params, to_jax, to_torch, tree_to_jax,
                         tree_to_numpy)


def get_smoke_config(arch):
    """The port's smoke configuration in the form the JAX package runs it
    (``jax_form``: deepseek-v3's router and RoPE as the JAX package's)."""
    return jax_form(_port_smoke_config(arch))


ARCHS = ["phi4-mini-3.8b", "qwen3-32b", "gemma2-2b", "llava-next-mistral-7b",
         "musicgen-medium", "rwkv6-1.6b", "jamba-1.5-large-398b", "mixtral-8x7b",
         "deepseek-v3-671b"]


def _inputs(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s))
    embeds = None
    if cfg.frontend_stub:
        embeds = rng.standard_normal(
            (b, cfg.stub_embed_len, cfg.d_model)).astype(np.float32)
    return toks, embeds


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, use_kernels):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=11)
    params = params_from_jax(cfg, tree, device="cpu")
    toks, embeds = _inputs(cfg, 12)
    want, want_aux = jax_forward(jcfg, tree_to_jax(tree), np.asarray(toks),
                                 None if embeds is None else np.asarray(embeds))
    with torch.inference_mode():
        got, aux = forward(cfg, params, torch.from_numpy(toks),
                           None if embeds is None else torch.from_numpy(embeds),
                           use_kernels=use_kernels)
    assert got.shape == (toks.shape[0], toks.shape[1], cfg.vocab_size)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) > 0.0) == (cfg.moe is not None)   # the MoE load-balance term
    np.testing.assert_allclose(float(aux), float(want_aux), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=5e-4, rtol=5e-4)


def test_forward_matches_jax_kernel_path():
    """Port with kernels against the JAX forward with its Pallas kernels in
    interpret mode (as ``tests/test_kernels.py`` runs them on the CPU)."""
    arch = "qwen3-32b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=13)
    toks, _ = _inputs(cfg, 14)
    want, _ = jax_forward(jax_smoke_config(arch).scaled(dtype="float32"),
                          tree_to_jax(tree), np.asarray(toks), use_kernels=True)
    with torch.inference_mode():
        got, _ = forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                         torch.from_numpy(toks), use_kernels=True)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=5e-4, rtol=5e-4)


def test_rwkv6_forward_matches_jax_kernel_path():
    """rwkv6 with the WKV kernel's plain version against the JAX forward with
    its Pallas kernel in interpret mode."""
    arch = "rwkv6-1.6b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=16)
    toks, _ = _inputs(cfg, 17)
    want, _ = jax_forward(jax_smoke_config(arch).scaled(dtype="float32"),
                          tree_to_jax(tree), np.asarray(toks), use_kernels=True)
    with torch.inference_mode():
        got, _ = forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                         torch.from_numpy(toks), use_kernels=True)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=5e-4, rtol=5e-4)


def test_jamba_forward_matches_jax_kernel_path():
    """jamba with the selective scan's and flash attention's plain versions
    against the JAX forward with its Pallas kernels in interpret mode."""
    arch = "jamba-1.5-large-398b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=19)
    toks, _ = _inputs(cfg, 20)
    want, want_aux = jax_forward(jax_smoke_config(arch).scaled(dtype="float32"),
                                 tree_to_jax(tree), np.asarray(toks), use_kernels=True)
    with torch.inference_mode():
        got, aux = forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                           torch.from_numpy(toks), use_kernels=True)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("sq,sk,window", [(64, 64, None), (48, 48, 16), (1, 80, None)],
                         ids=["prefill-causal", "prefill-window", "decode"])
def test_gqa_scores_softmax_bf16_matches_jax(sq, sk, window):
    """bf16 operands, fp32 scores: the einsum path rounds no score to bf16,
    as ``preferred_element_type=float32`` does in the JAX package. Rounding
    the scores to bf16 before the upcast misses 1e-3 by 0.008 to 0.016 at
    these shapes."""
    b, h, kv, d = 2, 8, 2, 64
    rng = np.random.default_rng(18)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    if sq == sk:
        qi, kj = np.arange(sq)[:, None], np.arange(sk)[None, :]
        mask = kj <= qi
        if window is not None:
            mask &= kj > qi - window
        mask = mask[None]
    else:   # one query against a cache with 57 valid slots per row
        mask = np.broadcast_to(np.arange(sk)[None, None, :] < 57, (b, sq, sk))
    scale = 1.0 / np.sqrt(d)
    want = jax_gqa_scores_softmax(*(to_jax(x, True) for x in (q, k, v)),
                                  np.asarray(mask), 0.0, scale)
    got = gqa_scores_softmax(*(to_torch(x, True) for x in (q, k, v)),
                             torch.from_numpy(np.ascontiguousarray(mask)), 0.0, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_finite(arch):
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    params = init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")
    toks, embeds = _inputs(cfg, 15, s=16)
    with torch.inference_mode():
        logits, _ = forward(cfg, params, torch.from_numpy(toks),
                            None if embeds is None else torch.from_numpy(embeds),
                            use_kernels=True)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trip(arch):
    """The JAX package's own ``init_params`` tree converts leaf for leaf:
    same keys, same shapes, same values."""
    cfg = get_smoke_config(arch)
    tree = tree_to_numpy(jax_init_params(jax_smoke_config(arch),
                                         jax.random.PRNGKey(3)))
    params = params_from_jax(cfg, tree, device="cpu", dtype=torch.float32)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert tuple(a.shape) == tuple(b.shape), path
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32),
                                          err_msg=path)
    walk(params, tree, "")
    # and the port's own init has the very same tree
    own = init_params(cfg, 0, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    assert shapes(own) == shapes(tree)


def test_converter_errors():
    cfg = get_smoke_config("phi4-mini-3.8b")
    tree = numpy_params(cfg, seed=1)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(cfg, missing, device="cpu")
    extra = dict(tree, surplus=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="surplus"):
        params_from_jax(cfg, extra, device="cpu")
    nested = dict(tree, layers=dict(tree["layers"]))
    nested["layers"]["sub0"] = {k: v for k, v in tree["layers"]["sub0"].items()
                                if k != "mlp"}
    with pytest.raises(KeyError, match="mlp"):
        params_from_jax(cfg, nested, device="cpu")
    bad = dict(tree, final_norm=np.zeros(cfg.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(cfg, bad, device="cpu")
    out = params_from_jax(cfg, tree, device="cpu", dtype="bfloat16")
    assert out["embed"]["embedding"].dtype == torch.bfloat16


def test_init_params_seeded_and_shaped():
    cfg = get_smoke_config("gemma2-2b")
    a = init_params(cfg, 5, device="cpu")
    b = init_params(cfg, 5, device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    wq = a["layers"]["sub1"]["attn"]["wq"]
    assert wq.shape == (cfg.num_layers // 2, cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert torch.equal(wq, b["layers"]["sub1"]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"]["sub1"]["attn"]["wq"])
    # gemma's zero-centred norm starts at zero; std follows fan-in
    assert torch.count_nonzero(a["final_norm"]) == 0
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1
    specs = tfm.model_param_specs(cfg)
    assert isinstance(specs["final_norm"], ParamSpec)
