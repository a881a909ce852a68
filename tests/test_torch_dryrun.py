"""The port's dry-run stack against the JAX package's, on the CPU: the
abstract parameter and cache trees and their logical axes, the per-cell
input specs, the analytic roofline functions (to 1e-12), and the dry run's
own method (the depth extrapolation and the prefill quadratic fit against
direct FLOP counts, the reckoned bytes, the fit decided before anything is
allocated). No kernel is launched: on the CPU the wrappers run their plain
versions."""
import collections
import functools
import os
import runpy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch import inputs as jinputs
from repro.models import transformer as jtfm
from repro.roofline import analysis as jroof
from repro_torch.configs import (ARCH_NAMES, SHAPES, cells, get_config, get_shape,
                                 get_smoke_config)
from _torch_util import jax_form
from repro_torch.launch import dryrun as dr
from repro_torch.launch import inputs as pinputs
from repro_torch.models import model as model_lib
from repro_torch.roofline import analysis as roof

CELLS = [(a, s) for a, s, skip in cells() if not skip]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GET = {"smoke": (jax_get_smoke_config, get_smoke_config),
       "full": (jax_get_config, get_config)}


def leaves(tree):
    """A port tree's leaves in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def shapes_dtypes(port_tree):
    return [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
            for t in leaves(port_tree)]


def jax_shapes_dtypes(jax_tree):
    return [(tuple(s.shape), np.dtype(s.dtype).name, "meta")
            for s in jax.tree_util.tree_leaves(jax_tree)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_logical_axes_match_jax(arch):
    want = jax.tree_util.tree_leaves(jtfm.param_logical_axes(jax_get_config(arch)),
                                     is_leaf=lambda x: isinstance(x, tuple))
    assert leaves(model_lib.param_logical_axes(jax_form(get_config(arch)))) == want


@pytest.mark.parametrize("size", list(GET))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_match_eval_shape(arch, size):
    jget, pget = GET[size]
    jcfg = jget(arch)
    want = jax_shapes_dtypes(jax.eval_shape(
        functools.partial(jtfm.init_params, jcfg), jax.random.PRNGKey(0)))
    assert want == jax_shapes_dtypes(jtfm.abstract_params(jcfg))
    assert shapes_dtypes(model_lib.abstract_params(jax_form(pget(arch)))) == want


@pytest.mark.parametrize("size", list(GET))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_cache_matches_eval_shape(arch, size):
    """At decode_32k's batch and length."""
    jget, pget = GET[size]
    shape = SHAPES["decode_32k"]
    want = jax_shapes_dtypes(jax.eval_shape(
        lambda: jtfm.init_cache(jget(arch), shape.global_batch, shape.seq_len)))
    got = model_lib.abstract_cache(pget(arch), shape.global_batch, shape.seq_len)
    assert shapes_dtypes(got) == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    want = jinputs.input_specs(jax_get_config(arch), get_shape(shape))
    got = pinputs.input_specs(get_config(arch), get_shape(shape))
    assert sorted(got) == sorted(want)
    for k in want:
        assert shapes_dtypes(got[k]) == jax_shapes_dtypes(want[k]), k
    assert pinputs.token_seq_len(get_config(arch), get_shape(shape)) == \
        jinputs.token_seq_len(jax_get_config(arch), get_shape(shape))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_roofline_functions_match_jax(arch, shape):
    jcfg, cfg, sh = jax_get_config(arch), jax_form(get_config(arch)), get_shape(shape)
    for n_dev in (256, 512):
        args = (sh.seq_len, sh.global_batch, n_dev, sh.kind)
        want = jroof.model_flops(jcfg, sh, n_dev)
        assert roof.model_flops(cfg, sh, n_dev) == pytest.approx(want, rel=1e-12)
        for name in ("ssm_scan_correction", "flash_attention_correction"):
            w = getattr(jroof, name)(jcfg, *args)
            g = getattr(roof, name)(cfg, *args)
            for key in ("flops", "bytes"):
                assert g[key] == pytest.approx(w[key], rel=1e-12, abs=0.0), (name, key)


def test_roofline_terms_against_the_jax_formulas():
    for flops, nbytes, coll, mf in ((1e15, 1e11, 0.0, 8e14), (1e12, 4e11, 0.0, 9e11),
                                    (1e12, 1e9, 5e11, 1e12), (0.0, 0.0, 0.0, 0.0)):
        r = roof.analyze_counts(flops, nbytes, coll, model_flops_per_device=mf)
        assert r.compute_s == flops / 989e12 and r.memory_s == nbytes / 3.35e12
        assert r.collective_s == coll / roof.LINK_BW
        j = jroof.Roofline(flops=flops, hbm_bytes=nbytes, collective_bytes=coll,
                           compute_s=r.compute_s, memory_s=r.memory_s,
                           collective_s=r.collective_s,
                           collectives=jroof.CollectiveStats({}, {}), model_flops=mf)
        assert (r.dominant, r.bound_s, r.useful_flops_ratio) == \
            (j.dominant, j.bound_s, j.useful_flops_ratio)
        want = (mf / 989e12) / r.bound_s if r.bound_s else 0.0
        assert r.roofline_fraction == want


def test_one_card_corrections_are_the_unsharded_terms():
    """``data_axis = model_axis = 1``: the whole batch, heads and channels on
    one device, so the terms equal the reference's at 16x16 times the
    batch and model splits (sequence-sharded attention: times 16)."""
    cfg = get_config("phi4-mini-3.8b")
    for kind in ("prefill", "train"):
        one = roof.flash_attention_correction(cfg, 8192, 2, 1, kind, data_axis=1,
                                              model_axis=1)
        ref = roof.flash_attention_correction(cfg, 8192, 32, 256, kind)
        assert one["flops"] == pytest.approx(16 * ref["flops"], rel=1e-12)
    cfg = get_config("rwkv6-1.6b")
    one = roof.ssm_scan_correction(cfg, 8192, 2, 1, "prefill", data_axis=1, model_axis=1)
    ref = roof.ssm_scan_correction(cfg, 8192, 32, 256, "prefill")
    assert one["flops"] == pytest.approx(16 * ref["flops"], rel=1e-12)


# ----------------------------------------------------------------------
# the dry run's method, at smoke width on the CPU
def _count(cfg, kind, units, b=2, s=16, **kw):
    return dr.measure(dr.reduced_config(cfg, units), kind, b, s, use_kernels=False,
                      device="cpu", timed=False, **kw)["flops"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "gemma2-2b"])
def test_depth_extrapolation_equals_a_direct_count(arch, kind):
    """The FLOPs counted at 2 and 4 units, extrapolated to 6, equal the count
    at 6 units exactly (every unit does the same work)."""
    cfg = get_smoke_config(arch)
    m2, m4, m6 = (_count(cfg, kind, u) for u in (2, 4, 6))
    assert m2 < m4 < m6
    ext = dr._extrapolate({"flops": m2, "bytes": 0.0}, {"flops": m4, "bytes": 0.0},
                          2, 4, 6)["flops"]
    assert ext == m6


def test_prefill_quadratic_fit_equals_a_direct_count():
    """FLOPs counted at three prompt lengths, fitted by the quadratic, give
    the count at a fourth length (attention scores are the S^2 term)."""
    cfg = get_smoke_config("qwen3-32b")
    ss = (16, 32, 64)
    vals = [_count(cfg, "prefill", 2, s=s) for s in ss]
    for target in (48, 96):
        direct = _count(cfg, "prefill", 2, s=target)
        assert dr._quad_fit(ss, vals, target) == pytest.approx(direct, rel=1e-9)


def test_run_cell_extrapolates_as_a_direct_run():
    """``run_cell`` end to end on the CPU: a 6-unit smoke model's decode
    cell, extrapolated from 2 and 4 units, against the direct run."""
    cfg = get_smoke_config("qwen3-32b").scaled(num_layers=6)
    kw = dict(device="cpu", capacity=64e9, verbose=False, cfg_override=cfg)
    ext = dr.run_cell("qwen3-32b", "decode_32k", **kw)
    direct = dr.run_cell("qwen3-32b", "decode_32k", method="direct", **kw)
    assert ext["method"] == "extrapolate(2,4)->6" and direct["method"] == "direct"
    assert [r["num_layers"] for r in ext["runs"]] == [2, 4]
    assert ext["fits"] and ext["finite"] and ext["batch"] == 8
    assert ext["flops"] == direct["flops"] > 0
    assert ext["extrapolated_bytes"] == pytest.approx(direct["extrapolated_bytes"],
                                                      rel=1e-12)
    assert ext["extrapolated_bytes"] == pytest.approx(ext["hbm_bytes"], rel=1e-12)
    assert ext["collective_bytes"] == 0.0 and ext["dominant"] in ("compute", "memory")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_reckoned_bytes_extrapolate_exactly(arch, shape):
    """The reckoned bytes are linear in units and length, so the
    extrapolation from the depths and lengths the plan runs gives the
    full-depth value."""
    cfg, sh = get_config(arch), get_shape(shape)
    b = dr.card_batch(sh)
    full = dr.reckon_bytes(cfg, sh.kind, b, sh.seq_len)["total"]
    units = dr.scalable_units(cfg)
    ss = dr.prefill_s_points(cfg) if sh.kind == "prefill" else (sh.seq_len,)
    per_s = [dr._extrapolate(*({"flops": 0.0, "bytes": dr.reckon_bytes(
        dr.reduced_config(cfg, k), sh.kind, b, s)["total"]} for k in (2, 4)), 2, 4,
        units)["bytes"] for s in ss]
    got = dr._quad_fit(ss, per_s, sh.seq_len) if len(ss) > 1 else per_s[0]
    assert got == pytest.approx(full, rel=1e-9)


def test_reckoned_bytes_terms():
    cfg, sh = get_config("qwen3-32b"), get_shape("decode_32k")
    rb = dr.reckon_bytes(cfg, "decode", 8, sh.seq_len)
    assert rb["weights"] == 2 * dr._n_params(cfg)
    # every layer's K and V over 32768 slots of 8 sequences, bf16
    assert rb["caches"] == 64 * 2 * 8 * 32768 * cfg.kv_dim * 2
    assert rb["total"] == rb["weights"] + rb["caches"] + rb["activations"]
    # the parameter tree, qk-norm scales included (which param_count omits)
    assert dr._n_params(cfg) == cfg.param_count() + 64 * 2 * cfg.head_dim


def test_cell_plans_are_decided_without_allocation():
    """Every cell plans from reckoned bytes alone (on an 85 GB card): the
    jamba cells and deepseek's train and prefill fit no pair of depths (one
    16-expert jamba super-block is 90 GB in bf16); phi4's train cell needs
    microbatches (its fp32 logits); the rest take a units pair."""
    plans = {(a, s): dr.plan_cell(get_config(a), get_shape(s), use_kernels=True,
                                  capacity=85e9) for a, s in CELLS}
    no_fit = {c for c, p in plans.items() if not p["fits"]}
    assert {("jamba-1.5-large-398b", s) for s in SHAPES} <= no_fit
    assert {("deepseek-v3-671b", "train_4k"), ("deepseek-v3-671b", "prefill_32k")} <= no_fit
    assert ("deepseek-v3-671b", "decode_32k") not in no_fit
    assert plans[("jamba-1.5-large-398b", "decode_32k")]["reckoned_peak_bytes"] > 90e9
    assert plans[("phi4-mini-3.8b", "train_4k")]["microbatches"] > 1
    for (a, s), p in plans.items():
        assert p["reckoned_peak_bytes"] > 0
        if p["fits"]:
            assert p["reckoned_peak_bytes"] <= dr.HEADROOM * 85e9
            assert p["pair"] in ((2, 4), (2, 3), (1, 2), (0, 1))
    for a in ("phi4-mini-3.8b", "qwen3-32b", "gemma2-2b", "rwkv6-1.6b"):
        for s in ("prefill_32k", "decode_32k"):
            assert plans[(a, s)]["pair"] == (2, 4), (a, s)


def test_a_cell_that_does_not_fit_gives_one_record():
    rec = dr.run_cell("jamba-1.5-large-398b", "decode_32k", use_kernels=True, device="cpu",
                      capacity=85e9, verbose=False)
    assert rec["fits"] is False and "runs" not in rec
    assert rec["reckoned_peak_bytes"] > 90e9 and rec["hbm_bytes"] > 0
    assert rec["model_flops"] > 0 and rec["batch"] == 8


def test_recurrent_train_cells_run_without_kernels():
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        on, why = dr.cell_kernels(get_config(arch), "train", True)
        assert not on and "no backward" in why
        assert dr.cell_kernels(get_config(arch), "prefill", True) == (True, "on")
    assert dr.cell_kernels(get_config("phi4-mini-3.8b"), "train", True) == (True, "on")


def test_card_batch_is_one_data_shard():
    assert {s: dr.card_batch(sh) for s, sh in SHAPES.items()} == {
        "train_4k": 16, "prefill_32k": 2, "decode_32k": 8, "long_500k": 1}
    assert dr.step_mode(SHAPES["long_500k"]) == "serve_long"
    assert len(CELLS) == 33


def test_decode_attention_flops():
    """K2's FLOPs: 4 B H S_cache D a layer, the window on gemma2's local
    layers."""
    cfg = get_config("gemma2-2b")
    want = 13 * 4.0 * 8 * 8 * (32768 + 4096) * 256
    assert dr.decode_attention_flops(cfg, 32768, 8) == want
    assert dr.decode_attention_flops(get_config("rwkv6-1.6b"), 32768, 8) == 0.0


def test_kernel_flops_match_the_einsum_count_on_the_cpu():
    """What the kernels' analytic FLOPs stand for, counted on the CPU where
    the einsum attention runs: at decode, the count grows with the cache by
    K2's term; at prefill, the count's S^2 coefficient is twice K1's (the
    einsum path multiplies the whole S x S square and masks it)."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    cfg2 = dr.reduced_config(cfg, 2)
    b = 4
    grow = _count(cfg, "decode", 2, b=b, s=96) - _count(cfg, "decode", 2, b=b, s=32)
    want = dr.decode_attention_flops(cfg2, 96, b) - dr.decode_attention_flops(cfg2, 32, b)
    assert grow == want > 0
    ss = (16, 32, 64)
    coef = np.polyfit(ss, [_count(cfg, "prefill", 2, b=2, s=s) for s in ss], 2)[0]
    flash = dr.kernel_flops(cfg2, "prefill", 2, 64)["flash"] / 64 ** 2
    assert coef == pytest.approx(2 * flash, rel=1e-9)


# chip_smoke.py's dryrun phase replays every kernel call signature of its
# cells against the plain versions; its machinery, on the CPU
@functools.lru_cache(maxsize=None)
def chip_smoke():
    return runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="chip_smoke")


@pytest.mark.parametrize("arch,kind", [("gemma2-2b", "prefill"), ("phi4-mini-3.8b", "train"),
                                       ("qwen3-32b", "decode"), ("rwkv6-1.6b", "prefill")])
def test_dryrun_phase_records_and_replays_every_kernel_call(arch, kind):
    """The recorder sees each kernel call a cell's step makes (as many as
    the launches the phase expects of it on the card), puts the entries
    back, and each distinct signature replays on inputs of its layout."""
    cs = chip_smoke()
    cfg = dr.reduced_config(get_smoke_config(arch), 2)
    calls = collections.Counter()
    before = {(m, n): getattr(m, n) for m, n in cs["DRYRUN_ENTRIES"]}
    with cs["recording_calls"](calls):
        dr.measure(cfg, kind, 2, 32, use_kernels=True, device="cpu", timed=False)
    assert {(m, n): getattr(m, n) for m, n in cs["DRYRUN_ENTRIES"]} == before
    per_kernel = collections.Counter()
    for (name, _, _), n in calls.items():
        per_kernel[name.replace("_model", "")] += n
    want = {k: n for k, n in cs["expected_launches"](cfg, kind, 1, 1).items() if n}
    assert dict(per_kernel) == want
    rows = cs["dryrun_replay"](torch.device("cpu"), None, calls)
    assert len(rows) == len(calls) and all(r["max_abs_err"] == 0.0 for r in rows)


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (5, 30.0)])
def test_plain_attention_in_slices_equals_the_whole_call(window, softcap):
    """K1's and K5's plain versions run over batch rows and groups of kv
    heads, as the replay runs them at long S, give the whole call's result."""
    cs = chip_smoke()
    gen = torch.Generator().manual_seed(0)
    b, h, kv, s, d = 2, 6, 3, 24, 8
    q, dout = (torch.randn(b, h, s, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, kv, s, d, generator=gen) for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    fa, fab = cs["fa_k"], cs["fab_k"]
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fab.delta_of(dout, out)
    whole = fab.flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    budget = 2 * s * s * 4          # one kv head's scores a slice
    sliced = cs["_plain_in_slices"](fa.flash_attention_plain, (q, k, v), "qkk",
                                    budget=budget, return_lse=True, **kw)
    for x, y in zip(sliced, (out, lse)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    sliced = cs["_plain_in_slices"](fab.flash_attention_bwd_plain,
                                    (q, k, v, dout, lse, delta), "qkkqqq", budget=budget, **kw)
    for x, y in zip(sliced, whole):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_replay_inputs_keep_the_recorded_layout():
    """A replayed tensor has the recorded shape, strides, dtype and address
    alignment: a transposed view of a column slice at an odd offset."""
    cs = chip_smoke()
    base = torch.zeros(2, 40, 3, 20, dtype=torch.bfloat16)
    view = base[:, :, :, 3:19].transpose(1, 2)
    sig = cs["_signature"](view)
    got = cs["_laid_out"](sig, torch.ones(view.shape, dtype=torch.bfloat16))
    assert cs["_signature"](got) == sig and bool((got == 1).all())


@pytest.mark.parametrize("counts,iters,whole", [
    ((7, 14), 7, True),             # two kernels, one and two a call
    ((), 7, False),                 # an empty profile
    ((1,), 7, False),               # one kernel seen once in 7 calls
    ((7, 6), 7, False),             # one record of the second kernel lost
])
def test_device_ms_takes_only_a_profile_that_holds_every_launch(counts, iters, whole):
    """``device_ms`` keeps a profile only when each kernel was seen a whole
    number of times a call; a profile that lost records reads far low."""
    rows = [(100.0 * n, n, f"kernel{i}") for i, n in enumerate(counts)]
    assert chip_smoke()["complete_capture"](rows, iters) is whole
