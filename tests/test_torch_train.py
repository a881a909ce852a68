"""The port's training path on the CPU, against the JAX package on the same
numpy-made inputs and converted weights: the flash backward (K5's plain
version, the autograd oracle, the differentiable ``ops.flash_attention``),
the loss and its gradients, the optimizer, the train step, the data stream,
checkpoints (both ways) and the launcher. Tolerances are the reference's
own: 5e-5 in fp32 for the kernels, 2e-2 in bf16; 5e-4 for model-level
numbers that pass through whole layers."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention_bwd import flash_attention_bwd as jax_flash_bwd
from repro.models.model import loss_fn as jax_loss_fn
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_smoke_config as _port_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import flash_attention_bwd as fab_k
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_launch
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

from _torch_util import as_np, jax_form, numpy_params, to_jax, to_torch, tree_to_jax


def get_smoke_config(arch):
    """The port's smoke configuration in the form the JAX package runs it
    (``jax_form``: deepseek-v3's router and RoPE as the JAX package's)."""
    return jax_form(_port_smoke_config(arch))


TOL = {False: 5e-5, True: 2e-2}
MODEL_TOL = 5e-4
# deepseek-v3's gradients against the JAX package, relative to each leaf's
# largest value above 1: fp32 rounding through MLA, the MoE gates and the
# MTP head puts the leaves that sum over every token (embedding, norm
# scales, w_dkv) 1.0e-6 to 4.5e-6 apart over eight seeds of this test's
# shapes, so 1e-6 holds for some seeds only
DEEPSEEK_GRAD_TOL = 1e-5


def _close(got, want, tol, scale_atol=False):
    want = as_np(want)
    atol = tol * max(1.0, float(np.abs(want).max())) if scale_atol else tol
    np.testing.assert_allclose(as_np(got), want, atol=atol, rtol=tol)


def _bwd_inputs(seed, b, h, kv, sq, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, kv, s, d), (b, kv, s, d), (b, h, sq, d))]


def _lse_delta(q, k, v, dout, **kw):
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return lse, (dout.float() * out.float()).sum(-1)


# ----------------------------------------------------------------------
# K5: plain version, oracle, differentiable ops
@pytest.mark.parametrize("b,h,kv,sq,s,d,window,softcap,q_offset,block", [
    (1, 4, 4, 64, 64, 16, None, 0.0, 0, 16),      # G = 1, causal, 4 x 4 tiles
    (2, 4, 2, 40, 40, 16, 8, 5.0, 0, 8),          # G = 2, window + soft cap
    (1, 8, 2, 32, 64, 16, None, 0.0, 32, 16),     # G = 4, q_offset
], ids=["g1", "g2-window-softcap", "g4-q_offset"])
def test_flash_bwd_plain_matches_pallas(b, h, kv, sq, s, d, window, softcap,
                                        q_offset, block):
    """K5's plain version against the JAX package's Pallas backward kernels
    in interpret mode, on the same q, k, v, dout, lse and delta."""
    q, k, v, dout = _bwd_inputs(1, b, h, kv, sq, s, d)
    kw = dict(window=window, softcap=softcap, q_offset=q_offset)
    tq, tk, tv, tdo = (to_torch(x) for x in (q, k, v, dout))
    lse, delta = _lse_delta(tq, tk, tv, tdo, **kw)
    got = fab_k.flash_attention_bwd(tq, tk, tv, tdo, lse, delta, **kw)
    want = jax_flash_bwd(*(to_jax(x) for x in (q, k, v, dout)),
                         to_jax(as_np(lse)), to_jax(as_np(delta)),
                         block_q=block, block_k=block, interpret=True, **kw)
    for g_, w_, x in zip(got, want, (q, k, v)):
        assert g_.shape == x.shape and g_.dtype == torch.float32
        _close(g_, w_, TOL[False])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_bwd_plain_ragged_matches_oracle(g):
    """A sequence that is no multiple of any tile (77), with a window and a
    soft cap, against torch autograd through the fp32 oracle."""
    b, kv, s, d = 2, 2, 77, 16
    q, k, v, dout = (to_torch(x) for x in _bwd_inputs(2, b, kv * g, kv, s, s, d))
    kw = dict(window=20, softcap=10.0)
    lse, delta = _lse_delta(q, k, v, dout, **kw)
    got = fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_, TOL[False])


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (16, 30.0)])
def test_flash_bwd_ref_matches_jax_grad(window, softcap):
    """The port's autograd oracle against ``jax.grad`` of the JAX oracle."""
    q, k, v, dout = _bwd_inputs(3, 2, 8, 2, 48, 48, 16)
    got = ref.flash_attention_bwd_ref(*(to_torch(x) for x in (q, k, v, dout)),
                                      window=window, softcap=softcap)
    jq, jk, jv = (to_jax(x) for x in (q, k, v))
    f = lambda a, b_, c: jnp.sum(jref.flash_attention_ref(  # noqa: E731
        a, b_, c, window=window, softcap=softcap) * to_jax(dout))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for g_, w_ in zip(got, want):
        _close(g_, w_, TOL[False])


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ops_flash_grads_match_jax_pallas(bf16):
    """The port's differentiable ``ops.flash_attention`` (on the CPU: the
    plain versions of K1 and K5 through the autograd Function) against
    ``jax.grad`` of ``repro.kernels.ops.flash_attention``, which runs the
    Pallas forward and backward kernels in interpret mode through its
    ``custom_vjp``. Model layout (B, S, H, D); the forced-oracle route is
    held to the same numbers."""
    b, s, h, kv, d = 2, 40, 4, 2, 16
    rng = np.random.default_rng(4)
    q, k, v, w = (rng.standard_normal((b, s, n, d)).astype(np.float32)
                  for n in (h, kv, kv, h))
    kw = dict(window=8, attn_softcap=5.0)
    jq, jk, jv, jw = (to_jax(x, bf16) for x in (q, k, v, w))
    f = lambda a, b_, c: jnp.sum(  # noqa: E731
        jops.flash_attention(a, b_, c, **kw).astype(jnp.float32) * jw.astype(jnp.float32))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for force in (False, True):
        tq, tk, tv = (to_torch(x, bf16).requires_grad_(True) for x in (q, k, v))
        ops.force_ref(force)
        try:
            out = ops.flash_attention(tq, tk, tv, **kw)
        finally:
            ops.force_ref(False)
        assert out.shape == (b, s, h, d) and out.dtype == tq.dtype
        (out.float() * to_torch(w, bf16).float()).sum().backward()
        for t, w_ in zip((tq, tk, tv), want):
            assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
            _close(t.grad, w_, TOL[bf16], scale_atol=bf16)


def test_decode_and_wkv_raise_under_autograd():
    q = torch.randn(1, 1, 4, 16, requires_grad=True)
    k = v = torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, k, v, torch.ones(1, 8, dtype=torch.bool))
    r = torch.randn(2, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6_wkv(r, r.detach(), r.detach(), torch.rand(2, 4, 8), torch.zeros(2, 8))


@pytest.mark.parametrize("which", ["u", "dt", "bm"])
def test_ssm_scan_raises_under_autograd(which):
    """The JAX package defines no backward kernel for the selective scan:
    ``ops.ssm_scan`` refuses an input that needs a gradient, and runs once
    gradients are off."""
    u, dt = torch.randn(2, 6, 16), torch.rand(2, 6, 16)
    bm, cm = torch.randn(2, 6, 4), torch.randn(2, 6, 4)
    ins = {"u": u, "dt": dt, "bm": bm}
    ins[which] = ins[which].clone().requires_grad_(True)
    args = (ins["u"], ins["dt"], ins["bm"], cm, -torch.rand(16, 4), torch.ones(16))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssm_scan(*args)
    with torch.no_grad():
        y, h = ops.ssm_scan(*args)
    assert y.shape == (2, 6, 16) and h.shape == (2, 16, 4)


# ----------------------------------------------------------------------
# loss and gradients
def _jax_batch(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    return {"tokens": toks, "loss_mask": mask}


def _port_grads(cfg, params, batch, use_kernels, remat):
    tcfg = ts.TrainConfig(remat=remat, use_kernels=use_kernels)
    loss, metrics, grads = ts.loss_and_grads(cfg, tcfg, params, batch)
    return loss, metrics, grads


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k_, v_ in tree.items():
            out.update(_flat(v_, f"{prefix}{k_}/"))
        return out
    return {prefix[:-1]: as_np(tree)}


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-2b"])
def test_loss_and_grads_match_jax(arch, use_kernels):
    """``loss_fn`` and its gradients leaf by leaf, port against
    ``jax.value_and_grad`` of the JAX ``loss_fn`` on the same converted
    weights (gemma2 brings the window, both soft caps and the post norms).
    With kernels, the JAX side runs its Pallas kernels in interpret mode."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=21)
    batch = _jax_batch(cfg, 22)
    (jl, jm), jg = jax.value_and_grad(
        functools.partial(jax_loss_fn, jcfg, use_kernels=use_kernels), has_aux=True)(
            tree_to_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(cfg, tree, device="cpu")
    loss, metrics, grads = _port_grads(cfg, params, to_device(batch, "cpu"),
                                       use_kernels, remat=True)
    _close(loss, jl, MODEL_TOL)
    _close(metrics["ce"], jm["ce"], MODEL_TOL)
    got, want = _flat(grads), _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], MODEL_TOL, scale_atol=True)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mixtral-8x7b"])
def test_moe_loss_fn_matches_jax(arch, use_kernels):
    """``loss_fn`` of the MoE archs, total, ``ce`` and the load-balance
    ``aux`` term (weighted by ``aux_weight``), against the JAX ``loss_fn``
    on the same converted weights; with kernels, the JAX side runs its
    Pallas kernels in interpret mode."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=27)
    batch = _jax_batch(cfg, 28)
    jl, jm = jax_loss_fn(jcfg, tree_to_jax(tree),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         use_kernels=use_kernels, aux_weight=0.05)
    with torch.inference_mode():
        loss, metrics = model_lib.loss_fn(cfg, params_from_jax(cfg, tree, device="cpu"),
                                          to_device(batch, "cpu"),
                                          use_kernels=use_kernels, aux_weight=0.05)
    assert float(metrics["aux"]) > 0.0
    _close(metrics["ce"], jm["ce"], MODEL_TOL)
    _close(metrics["aux"], jm["aux"], MODEL_TOL)
    _close(loss, jl, MODEL_TOL)
    _close(loss, metrics["ce"] + 0.05 * metrics["aux"], 1e-6)


def test_split_units_gradient_lands_in_the_stacked_buffer():
    """The per-unit leaves give the same gradients as differentiating the
    stacked parameters directly, written into one stacked buffer."""
    cfg = get_smoke_config("phi4-mini-3.8b").scaled(dtype="float32")
    params = params_from_jax(cfg, numpy_params(cfg, seed=23), device="cpu")
    batch = to_device(_jax_batch(cfg, 24), "cpu")
    leaves = {k: v for k, v in params.items()}
    direct = jax.tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                    leaves)
    loss, _ = model_lib.loss_fn(cfg, direct, batch)
    loss.backward()
    _, _, grads = _port_grads(cfg, params, batch, False, remat=False)
    want = _flat(jax.tree_util.tree_map(lambda t: t.grad, direct))
    got = _flat(grads)
    for key in want:
        _close(got[key], want[key], 1e-6, scale_atol=True)
    split = tfm.split_units(params["layers"], grads["layers"])
    w_up = split["sub0"]["mlp"]["w_up"]
    assert len(w_up) == cfg.num_layers
    assert w_up[1].grad.data_ptr() == grads["layers"]["sub0"]["mlp"]["w_up"][1].data_ptr()


def test_remat_outside_dense_mode_raises():
    """Remat recomputes training units only, under a policy the JAX package
    names."""
    cfg = get_smoke_config("phi4-mini-3.8b").scaled(dtype="float32")
    params = params_from_jax(cfg, numpy_params(cfg, seed=25), device="cpu")
    g = tfm.layer_plan(cfg)[0]
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError, match="remat"):
            tfm.group_apply(cfg, g, params[g.name], None, None, None, None, mode=mode,
                            use_kernels=False, remat=True)
    batch = to_device(_jax_batch(cfg, 26), "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model_lib.loss_fn(cfg, params, batch, remat=True, remat_policy="save_everything")


def _jax_value_and_grads(jcfg, tree, batch, **kw):
    (jl, jm), jg = jax.value_and_grad(
        functools.partial(jax_loss_fn, jcfg, **kw), has_aux=True)(
            tree_to_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return jl, jm, _flat(jax.tree_util.tree_map(np.asarray, jg))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_mtp_loss_and_grads_match_jax(use_kernels):
    """deepseek-v3's ``loss_fn``: ``ce``, the MoE ``aux``, the MTP term
    (token t+2 from the final hidden state and the embedding of t+1 through
    one dense MLA block) and the total, to 5e-5; every gradient leaf, the
    ``mtp`` subtree's included, to ``DEEPSEEK_GRAD_TOL`` relative to the
    leaf's largest value above 1. The MLA layers launch no kernel, so both
    settings take the same path."""
    arch = "deepseek-v3-671b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=21)
    batch = _jax_batch(cfg, 22)
    jl, jm, want = _jax_value_and_grads(jax_smoke_config(arch).scaled(dtype="float32"),
                                        tree, batch, use_kernels=use_kernels, remat=True)
    params = params_from_jax(cfg, tree, device="cpu")
    loss, metrics, grads = _port_grads(cfg, params, to_device(batch, "cpu"),
                                       use_kernels, remat=True)
    assert set(metrics) == {"ce", "aux", "mtp"} and float(metrics["mtp"]) > 0.0
    for k in ("ce", "aux", "mtp"):
        _close(metrics[k], jm[k], TOL[False])
    _close(loss, jl, TOL[False])
    _close(loss, metrics["ce"] + 0.01 * metrics["aux"] + 0.1 * metrics["mtp"], 1e-6)
    got = _flat(grads)
    assert got.keys() == want.keys() and "mtp/block/attn/w_uk" in got
    for key in want:
        _close(got[key], want[key], DEEPSEEK_GRAD_TOL, scale_atol=True)


# (arch, use_kernels, gradient tolerance against the JAX package): the GQA
# archs to 1e-6 scaled, deepseek to DEEPSEEK_GRAD_TOL; the two recurrences
# sum their loops in another order and drift by up to 2e-5 under either
# policy, so they keep the model-level 5e-4 of the tests above
SAVE_ATTN_CASES = [("phi4-mini-3.8b", True, 1e-6), ("gemma2-2b", True, 1e-6),
                   ("deepseek-v3-671b", False, DEEPSEEK_GRAD_TOL),
                   ("jamba-1.5-large-398b", False, MODEL_TOL),
                   ("rwkv6-1.6b", False, MODEL_TOL)]


@pytest.mark.parametrize("arch,use_kernels,tol", SAVE_ATTN_CASES)
def test_save_attn_grads_match_jax_and_nothing(arch, use_kernels, tol):
    """``remat_policy="save_attn"`` keeps each mixer's output as well as the
    unit's input: its loss and gradients against the JAX package's
    ``save_attn`` on the same weights, and equal bit for bit to the port's
    own ``"nothing"`` (the same arithmetic, recomputed from other saved
    tensors). gemma2 brings two sublayers a unit and post norms, deepseek
    MLA, MoE and the MTP head, jamba Mamba layers, rwkv6 a sublayer that
    names no mixer output."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=31)
    batch = _jax_batch(cfg, 32)
    jl, jm, want = _jax_value_and_grads(jax_smoke_config(arch).scaled(dtype="float32"),
                                        tree, batch, use_kernels=use_kernels, remat=True,
                                        remat_policy="save_attn")
    params = params_from_jax(cfg, tree, device="cpu")
    out = {}
    for policy in ("nothing", "save_attn"):
        tcfg = ts.TrainConfig(remat=True, use_kernels=use_kernels, remat_policy=policy)
        out[policy] = ts.loss_and_grads(cfg, tcfg, params, to_device(batch, "cpu"))
    loss, metrics, grads = out["save_attn"]
    _close(loss, jl, TOL[False])
    _close(metrics["ce"], jm["ce"], TOL[False])
    got = _flat(grads)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], tol, scale_atol=True)
    assert torch.equal(loss, out["nothing"][0])
    for key, g in _flat(out["nothing"][2]).items():
        np.testing.assert_array_equal(got[key], g, err_msg=key)


def _jax_flash_calls(jaxpr, calls):
    """Pallas calls of the flash kernels in ``jaxpr`` and every jaxpr inside
    it, by kind: the forward returns (out, lse), lse one rank lower; the
    backward's dq kernel returns dq alone, its dk/dv kernel (dk, dv)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            avals = eqn.params["out_avals"]
            if len(avals) == 2 and len(avals[1].shape) == len(avals[0].shape) - 1:
                calls["fwd"] += 1
            else:
                calls["bwd"] += 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _jax_flash_calls(inner, calls)
    return calls


@pytest.mark.parametrize("policy", ["nothing", "save_attn"])
def test_remat_reruns_the_flash_forward_as_jax_does(policy, monkeypatch):
    """What each remat policy recomputes, counted in both packages: the
    flash forward runs twice a layer and step (once more in the backward,
    whose attention needs q, k, v, out and lse, which no policy keeps), the
    backward once, under ``"save_attn"`` as under ``"nothing"``. JAX: the
    Pallas calls in the jaxpr of the gradient, whose scan body is one layer.
    Port: the calls into K1's and K5's wrappers (their plain versions on the
    CPU)."""
    arch = "phi4-mini-3.8b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=33)
    batch = _jax_batch(cfg, 34)
    f = functools.partial(jax_loss_fn, jax_smoke_config(arch).scaled(dtype="float32"),
                          use_kernels=True, remat=True, remat_policy=policy)
    jaxpr = jax.make_jaxpr(jax.grad(lambda p, b: f(p, b)[0]))(
        tree_to_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    want = _jax_flash_calls(jaxpr.jaxpr, {"fwd": 0, "bwd": 0})
    assert want == {"fwd": 2, "bwd": 2}          # one layer: K1 twice, dq + dk/dv

    calls = {"fwd": 0, "bwd": 0}

    def counting(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa_k, "flash_attention", counting("fwd", fa_k.flash_attention))
    monkeypatch.setattr(fab_k, "flash_attention_bwd",
                        counting("bwd", fab_k.flash_attention_bwd))
    params = params_from_jax(cfg, tree, device="cpu")
    tcfg = ts.TrainConfig(remat=True, use_kernels=True, remat_policy=policy)
    ts.loss_and_grads(cfg, tcfg, params, to_device(batch, "cpu"))
    assert calls == {"fwd": want["fwd"] * cfg.num_layers, "bwd": cfg.num_layers}


# ----------------------------------------------------------------------
# optimizer
def test_lr_schedule_matches_jax():
    cfg = opt.OptimizerConfig(warmup_steps=5, total_steps=30)
    jcfg = jopt.OptimizerConfig(warmup_steps=5, total_steps=30)
    for step in (0, 1, 4, 5, 6, 17, 29, 30, 45):
        _close(opt.lr_at(cfg, torch.tensor(step, dtype=torch.int32)),
               jopt.lr_at(jcfg, jnp.int32(step)), 1e-7)


@pytest.mark.parametrize("steps", [1, 3])
def test_apply_updates_matches_jax(steps):
    """AdamW on the phi4 smoke tree: params and bf16 moments against the JAX
    update, step by step, with clipping active (random grads of norm > 1),
    and the inherited weight-decay rule: stacked norm scales (2-D) are
    decayed, ``final_norm`` (1-D) is not."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    tree = numpy_params(cfg, seed=27)
    rng = np.random.default_rng(28)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=10)
    jcfg = jopt.OptimizerConfig(warmup_steps=2, total_steps=10)
    params = params_from_jax(cfg, tree, device="cpu")
    state = opt.init_opt_state(ocfg, params)
    jparams = tree_to_jax(tree)
    jstate = jopt.init_opt_state(jcfg, jparams)
    for _ in range(steps):
        gtree = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        grads = params_from_jax(cfg, gtree, device="cpu")
        _close(opt.global_norm(grads), jopt.global_norm(tree_to_jax(gtree)), 1e-6)
        params, state, m = opt.apply_updates(ocfg, params, grads, state)
        jparams, jstate, jm = jopt.apply_updates(jcfg, jparams, tree_to_jax(gtree), jstate)
        _close(m["grad_norm"], jm["grad_norm"], 1e-6)
        _close(m["lr"], jm["lr"], 1e-7)
    assert int(state.step) == int(jstate.step) == steps
    for got, want in ((params, jparams), (state.mu, jstate.mu), (state.nu, jstate.nu)):
        g_, w_ = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, want))
        for key in w_:
            _close(g_[key], w_[key], 1e-5, scale_atol=True)
    assert state.mu["embed"]["embedding"].dtype == torch.bfloat16

    # decay alone (zero gradients): 2-D stacked norms shrink, final_norm not
    zero = params_from_jax(cfg, jax.tree_util.tree_map(np.zeros_like, tree), device="cpu")
    before = {k: params["layers"]["sub0"][k].clone() for k in ("norm_mixer",)}
    fin = params["final_norm"].clone()
    state = opt.OptState(state.step, jax.tree_util.tree_map(torch.zeros_like, state.mu),
                         jax.tree_util.tree_map(torch.zeros_like, state.nu))
    params, state, m = opt.apply_updates(ocfg, params, zero, state)
    keep = 1 - float(m["lr"]) * ocfg.weight_decay
    _close(params["layers"]["sub0"]["norm_mixer"], before["norm_mixer"] * keep, 1e-6)
    torch.testing.assert_close(params["final_norm"], fin, rtol=0, atol=0)


# ----------------------------------------------------------------------
# train step
@pytest.mark.parametrize("microbatches,remat", [(1, True), (1, False), (2, True), (2, False)])
def test_train_step_matches_jax(microbatches, remat):
    """Three steps from one converted state: losses, grad norms and the
    parameters afterwards, against the JAX step (fp32 smoke config). A
    one-step warm-up puts the peak rate of 3e-4 on every step, so that each
    leaf moves by some 1e-4 a step, well beyond the tolerance; the test
    checks that it did."""
    arch = "phi4-mini-3.8b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    jt = jts.TrainConfig(opt=jopt.OptimizerConfig(warmup_steps=1, total_steps=10),
                         remat=remat, microbatches=microbatches)
    tt = ts.TrainConfig(opt=opt.OptimizerConfig(warmup_steps=1, total_steps=10),
                        remat=remat, microbatches=microbatches)
    jstate = jts.init_train_state(jcfg, jt, jax.random.PRNGKey(microbatches))
    state = train_state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")
    start = {k: v.copy() for k, v in _flat(state.params).items()}   # updated in place
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 32, 4, seed=3))
    step = jax.jit(functools.partial(jts.train_step, jcfg, jt))
    for i in range(3):
        b = data.batch(i)
        jstate, jm = step(jstate, {"tokens": jnp.asarray(b["tokens"])})
        state, m = ts.train_step(cfg, tt, state, to_device(b, "cpu"))
        _close(m["loss"], jm["loss"], 1e-5)
        _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    got = _flat(state.params)
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    for key in want:
        _close(got[key], want[key], 1e-5, scale_atol=True)
        moved = np.abs(got[key] - start[key]).max()
        assert moved > 10 * 1e-5 * max(1.0, np.abs(want[key]).max()), (key, moved)


# ----------------------------------------------------------------------
# data, checkpoints, launcher
@pytest.mark.parametrize("markov", [True, False])
def test_synthetic_tokens_equal_jax(markov):
    kw = dict(vocab_size=300, seq_len=17, global_batch=3, seed=5, markov_order=markov)
    ours, theirs = SyntheticTokens(DataConfig(**kw)), JSyntheticTokens(JDataConfig(**kw))
    for step in (0, 1, 7):
        np.testing.assert_array_equal(ours.batch(step)["tokens"],
                                      theirs.batch(step)["tokens"])
    t = to_device(ours.batch(0), "cpu")["tokens"]
    assert t.dtype == torch.int64 and t.shape == (3, 17)


def _smoke_state(seed=0):
    cfg = get_smoke_config("qwen3-32b")
    tcfg = ts.TrainConfig()
    return cfg, tcfg, ts.init_train_state(cfg, tcfg, seed, device="cpu")


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cfg, tcfg, state = _smoke_state()
    ckpt.save(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), 7, ts.abstract_train_state(cfg, tcfg),
                            device="cpu")
    a, b = ckpt._flatten(state), ckpt._flatten(restored)
    assert a.keys() == b.keys() and "opt/step" in a
    assert "params/layers/sub0/mlp/w_up" in a and "opt/mu/embed/embedding" in a
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert restored.opt.mu["final_norm"].dtype == torch.bfloat16
    gc_dir = tmp_path / "gc"
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(gc_dir), step, state, keep=2)
    files = sorted(f.name for f in gc_dir.iterdir() if f.suffix == ".npz")
    assert files == ["step_00000004.npz", "step_00000005.npz"]
    assert not [f for f in gc_dir.iterdir() if f.suffix == ".tmp"]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX checkpoint restores in the port and a port checkpoint in JAX,
    leaf for leaf (bf16 moments included)."""
    arch = "qwen3-32b"
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    tcfg, jt = ts.TrainConfig(), jts.TrainConfig()
    jstate = jts.init_train_state(jcfg, jt, jax.random.PRNGKey(1))
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(4),
        mu=jax.tree_util.tree_map(lambda p: (p * 0.5).astype(jnp.bfloat16), jstate.params)))
    jckpt.save(str(tmp_path / "jax"), 4, jstate)
    ours = ckpt.restore(str(tmp_path / "jax"), 4, ts.abstract_train_state(cfg, tcfg),
                        device="cpu")
    want = train_state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate),
                                device="cpu")
    a, b = ckpt._flatten(ours), ckpt._flatten(want)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])

    ckpt.save(str(tmp_path / "port"), 4, ours)
    back = jckpt.restore(str(tmp_path / "port"), 4, jts.abstract_train_state(jcfg, jt))
    for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(jstate)[0],
                            jax.tree_util.tree_leaves(back)):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_restart_resumes_identically(tmp_path):
    """Crash after step 6 of 12, restart from the checkpoint: the same final
    loss as an uninterrupted run (seekable data, restored optimizer)."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    kw = dict(device="cpu", steps=12, global_batch=4, seq_len=32, ckpt_every=6,
              verbose=False, remat=False)
    full = train_launch.run_training(cfg, ckpt_dir=None, **kw)
    d = str(tmp_path / "ck")
    train_launch.run_training(cfg, ckpt_dir=d, **dict(kw, steps=6))
    assert ckpt.latest_step(d) == 6
    resumed = train_launch.run_training(cfg, ckpt_dir=d, **kw)
    assert len(resumed) == 6
    np.testing.assert_allclose(full[-1], resumed[-1], rtol=1e-6)


def test_launcher_smoke_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains,
    and the on_step hook sees the state before and after every step."""
    losses = train_launch.main(["--smoke", "--device", "cpu", "--steps", "3",
                                "--seq-len", "16", "--global-batch", "2"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
    seen = []
    train_launch.run_training(
        get_smoke_config("gemma2-2b"), device="cpu", steps=2, global_batch=2,
        seq_len=16, verbose=False, on_step=lambda i, s, m: seen.append((i, m is None)))
    assert seen == [(0, True), (0, False), (1, False)]
