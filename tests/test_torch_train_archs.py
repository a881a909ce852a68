"""Training beyond phi4 on the CPU, at smoke size: the two models that
``chip_smoke.py``'s train phase trains after phi4 on the card.

* mixtral-8x7b's loss and gradients (router, experts, attention,
  embeddings, the load-balance term) against ``jax.value_and_grad`` of the
  JAX ``loss_fn``, leaf by leaf, with the kernels on (the JAX side's Pallas
  kernels in interpret mode) and off, remat on;
* gemma2-2b's whole ``train_step`` with two microbatches against the JAX
  ``train_step``, at a sequence longer than the smoke window of 16, so the
  local layers' window masks pairs;
* the train phase's helpers, loaded from ``chip_smoke.py``: experts pinned
  by (layer, pass) under remat, the launch counts a step, the first step's
  holds, the kernels-on/off gradient holds, the memory reckoning and the
  K5 route table.

Inputs and weights are made with numpy from a seed and handed to both
frameworks; tolerances are the reference's own (5e-4 for numbers that pass
through whole layers, with the absolute part scaled by the leaf's largest
value; 1e-5 for the train step, as ``test_torch_train.py`` holds phi4's)."""
import argparse
import collections
import dataclasses
import functools
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.model import loss_fn as jax_loss_fn
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

from _torch_util import as_np, numpy_params, tree_to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = 5e-4
CPU = torch.device("cpu")


def _close(got, want, tol, scale_atol=False):
    want = as_np(want)
    atol = tol * max(1.0, float(np.abs(want).max())) if scale_atol else tol
    np.testing.assert_allclose(as_np(got), want, atol=atol, rtol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: as_np(tree)}


def _batch(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    return {"tokens": toks, "loss_mask": mask}


# ----------------------------------------------------------------------
# mixtral: loss and gradients against the JAX package
@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_mixtral_loss_and_grads_match_jax(use_kernels):
    """``loss_and_grads`` (remat on, ``aux_weight`` 0.01 as both packages'
    ``loss_fn`` defaults) against ``jax.value_and_grad`` of the JAX
    ``loss_fn`` on the same converted weights: the total, ``ce``, ``aux``,
    and every gradient leaf (the router and the three expert weights of
    both layers, attention, norms, embeddings)."""
    arch = "mixtral-8x7b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    tree = numpy_params(cfg, seed=41)
    batch = _batch(cfg, 42)
    (jl, jm), jg = jax.value_and_grad(
        functools.partial(jax_loss_fn, jcfg, use_kernels=use_kernels, remat=True),
        has_aux=True)(tree_to_jax(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(cfg, tree, device="cpu")
    loss, metrics, grads = ts.loss_and_grads(
        cfg, ts.TrainConfig(remat=True, use_kernels=use_kernels), params,
        to_device(batch, "cpu"))
    assert float(metrics["aux"]) > 0.0
    _close(loss, jl, MODEL_TOL)
    _close(metrics["ce"], jm["ce"], MODEL_TOL)
    _close(metrics["aux"], jm["aux"], MODEL_TOL)
    got, want = _flat(grads), _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert got.keys() == want.keys()
    moe = [k for k in want if "/moe/" in k]
    assert {k.rsplit("/", 1)[1] for k in moe} == {"w_router", "we_gate", "we_up", "we_down"}
    for key in want:
        assert np.abs(want[key]).max() > 0, key
        _close(got[key], want[key], MODEL_TOL, scale_atol=True)


# ----------------------------------------------------------------------
# gemma2-2b: the whole train step with microbatches, past the window
def _gemma2_steps(use_kernels, eps):
    """Three gemma2-2b steps (two microbatches, remat, sequences of 40 past
    the smoke window of 16) of both packages from one converted state, the
    optimizers at ``eps``: the start, each step's metrics side by side, and
    the two final states."""
    arch = "gemma2-2b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    seq = 40
    assert cfg.sliding_window == 16 < seq
    jt = jts.TrainConfig(opt=jopt.OptimizerConfig(warmup_steps=1, total_steps=10, eps=eps),
                         remat=True, microbatches=2, use_kernels=use_kernels)
    tt = ts.TrainConfig(opt=opt.OptimizerConfig(warmup_steps=1, total_steps=10, eps=eps),
                        remat=True, microbatches=2, use_kernels=use_kernels)
    jstate = jts.init_train_state(jcfg, jt, jax.random.PRNGKey(7))
    state = train_state_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")
    start = {k: v.copy() for k, v in _flat(state.params).items()}
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, 4, seed=5))
    step = jax.jit(functools.partial(jts.train_step, jcfg, jt))
    metrics = []
    for i in range(3):
        b = data.batch(i)
        jstate, jm = step(jstate, {"tokens": jnp.asarray(b["tokens"])})
        state, m = ts.train_step(cfg, tt, state, to_device(b, "cpu"))
        metrics.append((m, jm))
    return start, metrics, state, jstate


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_gemma2_train_step_with_microbatches_matches_jax(use_kernels):
    """Three steps of gemma2-2b (soft caps, post norms, local and global
    layers) with two microbatches and remat, from one converted state, at
    sequences of 40 past the smoke window of 16: losses, grad norms and the
    parameters afterwards against the JAX step. As phi4's test, a one-step
    warm-up puts the peak rate on every step, and each leaf must have
    moved beyond the tolerance. Both optimizers take eps 1e-6: here some
    gradient elements are within fp32 rounding of 0 (2e-9 against a median
    of 1.2e-3), where the two packages' sums differ in their last bits, and
    AdamW's update ``lr g / (|g| + eps)`` at the default eps of 1e-8 turns
    that rounding into a move of up to lr / 2 (3.7e-5 after one step); the
    default eps is held on loss and grad norm by the test below."""
    start, metrics, state, jstate = _gemma2_steps(use_kernels, eps=1e-6)
    for m, jm in metrics:
        _close(m["loss"], jm["loss"], 1e-5)
        _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    got = _flat(state.params)
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], 1e-5, scale_atol=True)
        moved = np.abs(got[key] - start[key]).max()
        assert moved > 10 * 1e-5 * max(1.0, np.abs(want[key]).max()), (key, moved)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_gemma2_train_step_at_default_eps_matches_jax(use_kernels):
    """The same three steps at the optimizer's default eps, the one the card
    trains at: every step's loss and grad norm against the JAX step to
    1e-5. Rounding near zero gradients moves a few elements by up to lr / 2
    there (see above), which shifts neither figure at this tolerance; the
    parameters are held leaf by leaf by the test above."""
    assert opt.OptimizerConfig().eps == jopt.OptimizerConfig().eps == 1e-8
    _, metrics, _, _ = _gemma2_steps(use_kernels, eps=opt.OptimizerConfig().eps)
    for m, jm in metrics:
        _close(m["loss"], jm["loss"], 1e-5)
        _close(m["grad_norm"], jm["grad_norm"], 1e-5)


# ----------------------------------------------------------------------
# chip_smoke.py's train phase, on the CPU
@functools.lru_cache(maxsize=None)
def chip_smoke():
    return runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="chip_smoke")


ARGS = argparse.Namespace(seed=0)


@pytest.fixture
def counted(monkeypatch):
    """K1's and K5's entries wrapped to count their calls as the card's
    wrappers count their launches (on the CPU the plain versions run and
    count nothing), on the route the wrapper's ``route`` picks."""
    cs = chip_smoke()
    for mod, name in ((cs["fa_k"], "flash_attention"), (cs["fab_k"], "flash_attention_bwd")):
        fn = getattr(mod, name)

        def counting(q, *a, _fn=fn, _mod=mod, **kw):
            _mod.launches += 1
            _mod.launches_by_route[_mod.route(q.dtype, q.shape[-1])] += 1
            return _fn(q, *a, **kw)
        monkeypatch.setattr(mod, name, counting)
    return cs


def test_train_runs_and_their_cuts():
    """gemma2-2b as published, 2 x 5120 tokens in 2 microbatches (past its
    4096 window); mixtral at every published width with all 8 experts, cut
    to 2 layers: 3.16 B parameters."""
    cs = chip_smoke()
    runs = {r[0]: r[1:] for r in cs["TRAIN_RUNS"]}
    assert runs == {"gemma2-2b": (2, 5120, 2, 2, 1), "mixtral-8x7b": (8, 512, 1, 1, 8)}
    g = cs["train_config"]("gemma2-2b")
    assert g == get_config("gemma2-2b") and g.sliding_window == 4096 < runs["gemma2-2b"][1]
    m, full = cs["train_config"]("mixtral-8x7b"), get_config("mixtral-8x7b")
    assert m.num_layers == 2 and dataclasses.replace(m, num_layers=full.num_layers) == full
    assert abs(cs["param_bytes"](m, 1) / 1e9 - 3.16) < 0.01
    assert abs(cs["param_bytes"](g, 1) / 1e9 - 2.61) < 0.01
    assert cs["reduced_line"]("mixtral-8x7b", m) == "reduced: num_layers 32 -> 2"
    assert cs["reduced_line"]("mixtral-8x7b") == "reduced: num_layers 32 -> 16"


@pytest.mark.parametrize("arch,low,high", [("gemma2-2b", 70e9, 80e9),
                                           ("mixtral-8x7b", 50e9, 60e9)])
def test_reckon_train_of_the_runs(arch, low, high):
    """Each run's footprint, reckoned before it allocates anything
    (``launch.dryrun.reckon_footprint``, with its 1.1 margin): both fit a
    card with some 84 GB free."""
    cs = chip_smoke()
    batch, seq, micro = {r[0]: r[1:4] for r in cs["TRAIN_RUNS"]}[arch]
    total = cs["reckon_train"](CPU, cs["train_config"](arch), batch, seq, micro)
    assert low <= total <= high, total


@pytest.mark.parametrize("d,want", [(64, "wgmma"), (128, "wgmma"), (256, "wgmma")])
def test_k5_route_assertion_follows_the_head_dim(d, want, monkeypatch):
    """``wgmma`` for gemma2-2b's D 256 and for D 64 and 128; the assertion
    fails when one launch took another route."""
    cs = chip_smoke()
    cfg = get_config("gemma2-2b" if d == 256 else "mixtral-8x7b")
    cfg = cfg if cfg.head_dim == d else cfg.scaled(head_dim=d)
    assert cs["k5_route"](cfg) == want
    routes, saved = cs["K5_ROUTES"], dict(cs["K5_ROUTES"])
    other = "wgmma" if want == "mma" else "mma"
    try:
        monkeypatch.setattr(cs["fab_k"], "launches_by_route", {"fma": 0, "mma": 0, "wgmma": 0,
                                                               want: 52})
        cs["assert_k5_route"]("t", 52, cfg)
        assert routes["t"][want] == 52
        monkeypatch.setattr(cs["fab_k"], "launches_by_route", {"fma": 0, "mma": 0, "wgmma": 0,
                                                               want: 51, other: 1})
        with pytest.raises(AssertionError):
            cs["assert_k5_route"]("t", 52, cfg)
    finally:
        routes.clear()
        routes.update(saved)


@pytest.mark.parametrize("key,want", [
    ("void (anonymous namespace)::bwd_dq_mma_kernel<256, 32>(BwdArgs)", "K5 mma"),
    ("void (anonymous namespace)::bwd_dkv_mma_kernel<256, 32, 2>(BwdArgs)", "K5 mma"),
    ("void bwd_dkv_sm90_kernel<128>(BwdArgs, CUtensorMap_st)", "K5 wgmma"),
    ("void (anonymous namespace)::bwd_dq_kernel<__nv_bfloat16, 256, 32>(BwdArgs)", "K5 fma"),
    ("void (anonymous namespace)::flash_fwd_mma_kernel<256, 32>(FlashArgs)", "K1 mma"),
    ("void flash_fwd_sm90_kernel<128>(FlashArgs)", "K1 wgmma"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", "matmul (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other (ATen elementwise, "
                                                              "copies, reductions)")])
def test_profile_rows_by_kind(key, want):
    assert chip_smoke()["_kernel_kind"](key) == want


@pytest.mark.parametrize("arch,micro", [("gemma2-2b", 2), ("mixtral-8x7b", 1)])
def test_train_run_counts_launches_a_step_and_holds_the_first(arch, micro, counted):
    """``train_run`` on the CPU at smoke size: every step's K1 and K5 calls
    equal the step's own count (K1 twice and K5 once a layer and
    microbatch, under remat), every K1 and K5 call of the first step held
    against the plain version on its own inputs, every call recorded by
    signature."""
    cs = counted
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    calls = collections.Counter()
    out = cs["train_run"](CPU, ARGS, cfg, 2, 24, micro, steps=2, calls=calls, hold_first=True)
    per_step = {"flash_attention": 2 * cfg.num_layers * micro,
                "flash_attention_bwd": cfg.num_layers * micro}
    assert out["counts"] == {**dict.fromkeys(cs["KERNELS"], 0),
                             **{k: 2 * n for k, n in per_step.items()}}
    assert {k: len(v) for k, v in out["held"].items()} == per_step
    assert max(max(v) for v in out["held"].values()) <= 1e-4
    by_entry = collections.Counter()
    for (name, _, _), n in calls.items():
        by_entry[name] += n
    assert dict(by_entry) == {k: 2 * n for k, n in per_step.items()}


def test_train_run_fails_on_a_wrong_launch_count(counted, monkeypatch):
    """A step that launches K5 once more than its count fails the run."""
    cs = counted
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    fab_k = cs["fab_k"]
    fn = fab_k.flash_attention_bwd

    def twice(*a, **kw):
        fab_k.launches += 1
        return fn(*a, **kw)
    monkeypatch.setattr(fab_k, "flash_attention_bwd", twice)
    with pytest.raises(AssertionError, match="launches"):
        cs["train_run"](CPU, ARGS, cfg, 2, 16, 1, steps=2)


def test_holding_calls_fails_a_k5_call_off_by_a_tenth(counted, monkeypatch):
    """The first step's holds catch a K5 entry that is off by 0.1."""
    cs = counted
    cfg = get_smoke_config("gemma2-2b").scaled(dtype="float32")
    fab_k = cs["fab_k"]
    fn = fab_k.flash_attention_bwd
    monkeypatch.setattr(fab_k, "flash_attention_bwd",
                        lambda *a, **kw: tuple(g + 0.1 for g in fn(*a, **kw)))
    with pytest.raises(AssertionError, match="held flash_bwd"):
        cs["train_run"](CPU, ARGS, cfg, 2, 24, 2, steps=2, hold_first=True)


def _scattered_router(monkeypatch, seed):
    """Each top-k call picks random experts (the same count of rows): the
    two paths' choices then differ for most tokens, as a flip would."""
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator().manual_seed(seed)

    def scattered(probs, k):
        idx = torch.stack([torch.randperm(probs.shape[-1], generator=gen)[:k]
                           for _ in range(probs.shape[0])])
        return probs.gather(-1, idx), idx
    monkeypatch.setattr(moe_mod, "_topk", scattered)


def test_pinned_experts_by_layer_and_pass_under_remat(monkeypatch):
    """With a router that picks other experts on every call, the kernels-on
    gradients are far from the kernels-off ones; pinned to the
    kernels-off run's choices by (layer, pass, n), they agree to 1e-5. Under
    remat each of the two MoE layers routes and takes its load-balance term
    twice (forward and rerun), so eight choices are pinned."""
    cs = chip_smoke()
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    _scattered_router(monkeypatch, 3)
    params = params_from_jax(cfg, numpy_params(cfg, seed=43), device="cpu")
    batch = {"tokens": torch.from_numpy(_batch(cfg, 44)["tokens"]).long()}
    grads, chosen = {}, {}
    for name, on, pin in (("off", False, None), ("free", True, None), ("pinned", True, "off")):
        chosen[name] = {}
        with cs["pinned_experts"](chosen[name], pin=None if pin is None else chosen[pin]):
            _, _, g = ts.loss_and_grads(cfg, ts.TrainConfig(remat=True, use_kernels=on),
                                        params, batch)
        grads[name] = _flat(g)
    keys = {(layer, p, n) for layer in range(2) for p in range(2) for n in range(2)}
    assert set(chosen["off"]) == set(chosen["pinned"]) == keys
    assert cs["flipped_share"](chosen["free"], chosen["off"]) > 0.5
    worst = {name: max(np.abs(grads[name][k] - grads["off"][k]).max()
                       / max(np.abs(grads["off"][k]).max(), 1e-30) for k in grads["off"])
             for name in ("free", "pinned")}
    assert worst["pinned"] <= 1e-5 < 1e-2 < worst["free"], worst


def test_pinned_experts_put_back_and_demand_every_choice():
    """A pin that lacks a choice fails at that call; the module's functions
    are put back either way."""
    from repro_torch.models import moe as moe_mod
    cs = chip_smoke()
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    params = params_from_jax(cfg, numpy_params(cfg, seed=45), device="cpu")
    batch = {"tokens": torch.from_numpy(_batch(cfg, 46)["tokens"]).long()}
    apply, topk = moe_mod.moe_apply, moe_mod._topk
    with pytest.raises(AssertionError, match="no pinned choice"):
        with cs["pinned_experts"]({}, pin={}):
            ts.loss_and_grads(cfg, ts.TrainConfig(remat=True), params, batch)
    assert (moe_mod.moe_apply, moe_mod._topk) == (apply, topk)


@pytest.mark.parametrize("arch,layers,seq", [("gemma2-2b", 2, 40), ("mixtral-8x7b", 1, 24)])
def test_train_holds_on_the_cpu(arch, layers, seq):
    """The kernels-on/off holds of the train phase end to end at smoke size
    (fp32 configs, where the two paths differ by their order of sums):
    the first step at the trained depth and the fp32 copies of ``layers``
    layers (gemma2-2b: one local and one global layer past the window)."""
    cs = chip_smoke()
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    tokens = torch.from_numpy(_batch(cfg, 47, s=seq)["tokens"]).long()
    first = cs["hold_bf16_first_step"](CPU, ARGS, cfg, tokens, 2 if layers == 2 else 1)
    assert first["loss"] <= 1e-5 and first["gnorm"] <= 1e-5 and first["attn"] <= 1e-4
    key, worst, flipped = cs["hold_fp32"](CPU, ARGS, cfg, layers, tokens[:1])
    assert worst <= cs["GRAD_TOL_FP32"] and key
    assert (flipped is None) == (cfg.moe is None)
    assert (first["flipped"] is None) == (cfg.moe is None)


def test_flash_bwd_cases_cover_the_mma_route_at_d256():
    """The kernels phase's K5 cases at bf16 D 256: soft cap 50, window 64
    with ragged S, G 1 / 2 / 8, window with q_offset, rows that see no
    column, non-causal, contiguous, a batch of one with an odd dout stride;
    each on the route gemma2-2b's head dim now takes, ``wgmma`` (the name
    is the one the D 256 ``mma`` route gave it)."""
    cs = chip_smoke()
    cases = [c for c in cs["flash_bwd_cases"]() if c[1] == torch.bfloat16 and c[7] == 256]
    fab_k = cs["fab_k"]
    assert all(fab_k.route(c[1], c[7]) == "wgmma" for c in cases)
    assert any(c[0].endswith("odd dout stride") and c[2] == 1 for c in cases)
    assert {c[3] // c[4] for c in cases} >= {1, 2, 8}
    assert any(c[8] is not None and c[10] > 0 for c in cases)            # window + q_offset
    assert any(c[9] == 50.0 for c in cases) and any(c[8] == 64 and c[5] == 200 for c in cases)
    assert any(not c[11] for c in cases) and any(c[0].endswith("contiguous") for c in cases)
    blind = [c for c in cases if "blind" in c[0]]
    assert blind and all(cs["fa_k"].blind_rows(c[5], c[6], c[8], c[10]).any() for c in blind)
