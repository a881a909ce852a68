"""The six archs that ``chip_smoke.py``'s archs phase serves (gemma2-2b,
gemma2-27b, qwen3-32b, mixtral-8x7b, llava-next-mistral-7b,
musicgen-medium), on the CPU at smoke size:

* greedy ``Engine.generate`` of the port against the JAX engine on the same
  fp32 weights, kernels on (their plain versions) and off, at levels 0 and 5
  of the variant ladder over smoke configs widened so that the ladder cuts
  them (``_round_ff`` keeps a stock smoke ``d_ff`` of 128 at every level);
* the phase's helpers, loaded from ``chip_smoke.py``: the K1 route each
  model's launches must take, the cut mixtral, the cache reckoning, the
  stub-frontend run's kernel counts, the kernels on/off checks and the
  sliding-window ring past its wrap."""
import argparse
import collections
import dataclasses
import functools
import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.variants import VariantPool as JaxVariantPool
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.variants import VariantPool
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.train.optimizer import _leaves

from _torch_util import jax_asdict, numpy_params, tree_to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIX = ("gemma2-2b", "gemma2-27b", "qwen3-32b", "mixtral-8x7b",
       "llava-next-mistral-7b", "musicgen-medium")
PROMPT, STEPS = 10, 6


def _widened(smoke, arch):
    """A smoke config the ladder changes: 4 layers (8 for gemma2's
    local/global pairs, so that level 5 keeps 3 of 4 units), d_ff 1024 (a
    MoE: expert width 512)."""
    over = {"dtype": "float32", "d_ff": 1024,
            "num_layers": 8 if arch.startswith("gemma2") else 4}
    if smoke.moe is not None:
        over["moe"] = dataclasses.replace(smoke.moe, d_ff_expert=512)
    return smoke.scaled(**over)


def _level_configs(arch, level):
    """The port's and the JAX package's config of ``level``."""
    return (VariantPool(_widened(get_smoke_config(arch), arch))[level].config,
            JaxVariantPool(_widened(jax_smoke_config(arch), arch))[level].config)


def _inputs(cfg, seed=31, b=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, PROMPT))
    embeds = None
    if cfg.frontend_stub:
        embeds = rng.standard_normal((b, cfg.stub_embed_len, cfg.d_model)).astype(np.float32)
    return toks, embeds


@functools.lru_cache(maxsize=None)
def _jax_generate(arch, level):
    cfg, jcfg = _level_configs(arch, level)
    toks, embeds = _inputs(cfg)
    tree = numpy_params(cfg, seed=32 + level)
    max_len = cfg.stub_embed_len + PROMPT + STEPS + 2
    eng = JaxEngine(jcfg, tree_to_jax(tree), JaxEngineConfig(max_len=max_len))
    return eng.generate(jnp.asarray(toks, jnp.int32), num_steps=STEPS,
                        embeds=None if embeds is None else jnp.asarray(embeds))


@pytest.mark.parametrize("arch", SIX)
def test_ladder_cuts_the_widened_smoke_config_as_the_jax_package_does(arch):
    """Every level's config equals the JAX package's, and level 5 differs
    from level 0 in d_ff, depth or top-k."""
    for level in range(6):
        cfg, jcfg = _level_configs(arch, level)
        assert jax_asdict(cfg) == dataclasses.asdict(jcfg), level
    lo, hi = _level_configs(arch, 0)[0], _level_configs(arch, 5)[0]

    def knobs(c):
        return (c.d_ff if c.moe is None else c.moe.d_ff_expert, c.num_layers,
                None if c.moe is None else c.moe.top_k)
    assert knobs(lo) != knobs(hi), (knobs(lo), knobs(hi))


LADDER_CASES = [("qwen3-32b", 0), ("qwen3-32b", 5),
                ("llava-next-mistral-7b", 0), ("llava-next-mistral-7b", 5),
                ("gemma2-27b", 0), ("gemma2-27b", 5),
                ("gemma2-2b", 5), ("mixtral-8x7b", 5), ("musicgen-medium", 5)]


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch,level", LADDER_CASES)
def test_generate_across_the_ladder_matches_jax_engine(arch, level, use_kernels):
    cfg, _ = _level_configs(arch, level)
    toks, embeds = _inputs(cfg)
    tree = numpy_params(cfg, seed=32 + level)
    max_len = cfg.stub_embed_len + PROMPT + STEPS + 2
    eng = Engine(cfg, params_from_jax(cfg, tree, device="cpu"),
                 EngineConfig(max_len=max_len, use_kernels=use_kernels), device="cpu")
    got = eng.generate(toks, num_steps=STEPS, embeds=embeds)
    assert got.shape == (2, STEPS) and eng.last_stats["finite"]
    np.testing.assert_array_equal(got, _jax_generate(arch, level))


# ----------------------------------------------------------------------
# chip_smoke.py's archs phase, on the CPU
@functools.lru_cache(maxsize=None)
def chip_smoke():
    return runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="chip_smoke")


def _args(**kw):
    return argparse.Namespace(**{"seed": 0, "decode_steps": 3, "requests": 2, **kw})


@pytest.mark.parametrize("arch", SIX)
def test_k1_route_assertion_follows_the_head_dim(arch, monkeypatch):
    """``wgmma`` for all six, gemma2-2b's D 256 included; the assertion
    passes when every launch took that route and fails when one did not."""
    cs = chip_smoke()
    cfg = cs["arch_config"](arch)
    want = "wgmma"
    assert cs["k1_route"](cfg) == want
    fa, routes = cs["fa_k"], cs["K1_ROUTES"]
    saved = dict(routes)
    try:
        monkeypatch.setattr(fa, "launches_by_route", {"fma": 0, "mma": 0, "wgmma": 0,
                                                      want: 52})
        cs["assert_k1_route"](arch, 52, cfg)
        assert routes[arch] == {"fma": 0, "mma": 0, "wgmma": 0, want: 52}
        other = "wgmma" if want == "mma" else "mma"
        monkeypatch.setattr(fa, "launches_by_route", {"fma": 0, "mma": 0, "wgmma": 0,
                                                      want: 51, other: 1})
        with pytest.raises(AssertionError):
            cs["assert_k1_route"](arch, 52, cfg)
    finally:
        routes.clear()
        routes.update(saved)


def test_mixtral_cut_keeps_every_width_and_expert():
    cs = chip_smoke()
    full, cut = get_config("mixtral-8x7b"), cs["mixtral_cut_config"]()
    assert cut.num_layers == 16 < full.num_layers == 32
    assert dataclasses.replace(cut, num_layers=full.num_layers) == full
    assert (cut.moe.num_experts, cut.moe.top_k) == (8, 2)
    levels = VariantPool(cut).variants
    gb = [cs["param_bytes"](v.config) / 1e9 for v in levels]
    assert 40 <= gb[0] <= 50 and 40 <= gb[1] < gb[0], gb
    assert cs["param_bytes"](full) / 1e9 > 80
    assert cs["reduced_line"]("mixtral-8x7b") == "reduced: num_layers 32 -> 16"
    # the two cuts that were there before keep their lines
    assert cs["reduced_line"]() == "reduced: num_layers 72 -> 8, num_experts 16 -> 8"
    assert cs["reduced_line"]("deepseek-v3-671b") == "reduced: num_layers 61 -> 4"


def test_serve_max_len_covers_the_stub_positions():
    cs = chip_smoke()
    got = {a: cs["serve_max_len"](get_config(a), 512, 16) for a in SIX}
    assert got == {**dict.fromkeys(SIX, 1024), "llava-next-mistral-7b": 4096}


@pytest.mark.parametrize("arch,low,high", [("gemma2-27b", 64e9, 67e9), ("qwen3-32b", 75e9, 78e9),
                                           ("gemma2-2b", 25e9, 27e9)])
def test_reckon_fit_of_the_traces(arch, low, high):
    """What a trace keeps resident, reckoned before it builds anything: one
    engine of gemma2-27b or qwen3-32b (``reckon_footprint`` of level 0,
    with its 1.1 margin), all six levels of gemma2-2b (level 0's footprint
    and the other five levels' parameters)."""
    cs = chip_smoke()
    max_engines = None if arch == "gemma2-2b" else 1
    total = cs["reckon_fit"](torch.device("cpu"), get_config(arch), 1024, max_engines)
    assert low <= total <= high, total


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-medium"])
def test_stub_trace_counts_kernel_calls_at_layers_times_runs(arch):
    """``stub_trace`` on the CPU: six levels through the engine
    with embeddings, K1 once a layer a prefill and K2 once a layer a step."""
    cs = chip_smoke()
    cfg = get_smoke_config(arch)
    args = _args()
    counts = cs["stub_trace"](torch.device("cpu"), args, cfg, batch=2, prompt_len=8)
    layers = sum(v.config.num_layers for v in VariantPool(cfg).variants)
    assert counts == {"flash_attention": layers, "decode_attention": layers * args.decode_steps,
                      "ssm_scan": 0, "rwkv6_wkv": 0, "flash_attention_bwd": 0}


def test_leading_fp32_copies_the_leading_units_and_empties_the_tree():
    cs = chip_smoke()
    cfg = get_smoke_config("gemma2-27b")
    params = init_params(cfg, 4, dtype=torch.bfloat16, device="cpu")
    want = {k: v[:1].float().clone() for k, v in params["layers"]["sub1"]["attn"].items()}
    emb = params["embed"]["embedding"].float()
    per_unit = 4 * sum(t.numel() for t in _leaves(params["layers"])) // 2
    rest = 4 * sum(t.numel() for k, v in params.items() if k != "layers"
                   for t in _leaves(v))
    cfg32, p32, n, units = cs["leading_fp32"](cfg, params, budget=rest + per_unit + 1)
    assert (n, units, cfg32.num_layers, cfg32.dtype) == (1, 2, 2, "float32")
    assert params == {}
    for k, v in want.items():
        assert torch.equal(p32["layers"]["sub1"]["attn"][k], v)
    assert torch.equal(p32["embed"]["embedding"], emb)
    assert all(t.dtype == torch.float32 for t in _leaves(p32))


@pytest.mark.parametrize("arch,budget,units", [("gemma2-2b", None, 2),
                                               ("gemma2-27b", 1.0, 1),
                                               ("llava-next-mistral-7b", None, 2),
                                               ("mixtral-8x7b", None, None)])
def test_kernels_on_off_checks_on_the_cpu(arch, budget, units):
    """The on/off checks run end to end at smoke size: a dense model's fp32
    copies of its leading units (``budget`` in units of one unit's fp32
    bytes beyond the unstacked leaves: 1.0 copies one of two), a MoE
    model's first attention layer."""
    cs = chip_smoke()
    cfg = get_smoke_config(arch)
    kw = {}
    if budget is not None:
        lvl0 = VariantPool(cfg)[0].config
        p = init_params(lvl0, 0, device="cpu")
        per_unit = 4 * sum(t.numel() for t in _leaves(p["layers"])) // (
            lvl0.num_layers // 2)
        rest = 4 * sum(t.numel() for k, v in p.items() if k != "layers"
                       for t in _leaves(v))
        kw["budget"] = rest + budget * per_unit + 1
    out = cs["arch_checks"](torch.device("cpu"), _args(), cfg,
                            max_len=cs["serve_max_len"](cfg, 8, 3), batch=2, prompt_len=8,
                            **kw)
    assert out["fp32_diff"] <= cs["LOGITS_TOL_FP32"] * max(1.0, out["fp32_scale"])
    assert np.isfinite(out["bf16_diff"])
    if units is None:
        assert 0.0 <= out["flipped"] <= 1.0 and "fp32_units" not in out
    else:
        assert out["fp32_units"] == units and out["fp32_batch"] == 2


def test_ring_check_past_the_wrap_on_the_cpu():
    """gemma2-2b's ring at smoke size: a prompt past the window (40 against
    16: rolled by 8), decode steps writing the ring; kernels on against off
    and the last step against a prefill, in fp32."""
    cs = chip_smoke()
    cfg = get_smoke_config("gemma2-2b")
    res = cs["ring_check"](torch.device("cpu"), _args(decode_steps=6), cfg, batch=2,
                           prompt_len=40, max_len=64)
    tol = cs["LOGITS_TOL_FP32"]
    for dtype in ("bfloat16", "float32"):
        assert len(res[dtype]["diffs"]) == 7
    f32 = res["float32"]
    assert max(f32["diffs"]) <= tol * max(1.0, f32["scale"])
    assert f32["decode_vs_prefill"] <= tol * max(1.0, f32["scale"])
    # bf16: every K1 and K2 call of the kernels-on path held on its own inputs
    layers = cfg.num_layers
    assert {k: n for k, (n, _) in res["bfloat16"]["held"].items()} == {
        "flash_attention": layers, "decode_attention": layers * 6}
    assert "held" not in f32


def _ring_engine(cfg):
    return Engine(cfg, init_params(cfg, 5, device="cpu"), EngineConfig(max_len=64), device="cpu")


@pytest.mark.parametrize("faulty", [None, "flash_attention", "decode_attention"])
def test_holding_calls_holds_each_k1_and_k2_call(faulty, monkeypatch):
    """``holding_calls`` on the ring's run: every K1 and K2 call is held
    against its plain version on the same inputs, and a kernel entry that
    is off by 0.1 fails the run at its first call."""
    cs = chip_smoke()
    cfg = get_smoke_config("gemma2-2b").scaled(dtype="float32")
    eng = _ring_engine(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    if faulty is not None:
        mod = cs["fa_k"] if faulty == "flash_attention" else cs["dec_k"]
        good = getattr(mod, faulty)

        def off_by_a_tenth(*a, **kw):
            got = good(*a, **kw)
            return (got[0] + 0.1, got[1]) if isinstance(got, tuple) else got + 0.1
        monkeypatch.setattr(mod, faulty, off_by_a_tenth)
    held = {}
    run = functools.partial(cs["_ring_run"], torch.device("cpu"), cfg, eng.params, toks, 3, 64,
                            True, None, held)
    if faulty is not None:
        with pytest.raises(AssertionError, match="held"):
            run()
        assert len(held.get(faulty, ())) == 0
        return
    logits = run()
    assert len(logits) == 4
    assert {k: len(v) for k, v in held.items()} == {"flash_attention": cfg.num_layers,
                                                    "decode_attention": cfg.num_layers * 3}
    assert max(max(v) for v in held.values()) <= 1e-4


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-medium"])
def test_archs_replay_holds_every_recorded_call(arch):
    """The stub-frontend run hands its recorded calls to the phase, and
    every distinct signature replays against its plain version: as many
    calls as the kernels' counts, K1 and K2 both."""
    cs = chip_smoke()
    calls = collections.Counter()
    counts = cs["stub_trace"](torch.device("cpu"), _args(), get_smoke_config(arch), batch=2,
                              prompt_len=8, calls=calls)
    rows = cs["dryrun_replay"](torch.device("cpu"), None, calls, label="archs")
    assert len(rows) == len(calls) > 0
    assert {r["kernel"] for r in rows} == {"flash_attention", "decode_attention"}
    by_kernel = dict.fromkeys(counts, 0)
    for r in rows:
        by_kernel[r["kernel"]] += r["calls"]
        assert r["max_abs_err"] <= 2e-2 and r["ms"] is None
    assert by_kernel == counts


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_moe_pinned_experts_remove_the_flips(arch, monkeypatch):
    """With a router that picks different experts on every call, the two
    paths' expert pairs differ for most tokens and their logits far apart;
    pinned to the einsum path's experts at every MoE layer, the kernels-on
    logits come back to the einsum path's."""
    from repro_torch.models import moe as moe_mod

    cs = chip_smoke()
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    eng = _ring_engine(cfg)
    gen = torch.Generator().manual_seed(1)

    def scattered(c, router_logits):
        idx = torch.stack([torch.randperm(c.moe.num_experts, generator=gen)[:c.moe.top_k]
                           for _ in range(router_logits.shape[0])])
        gates = torch.softmax(router_logits.float(), dim=-1).gather(-1, idx)
        return gates / gates.sum(dim=-1, keepdim=True) * c.moe.router_scale, idx
    monkeypatch.setattr(moe_mod, "route_topk", scattered)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2))
    diff, scale, flipped, pinned = cs["moe_prefill_on_off"](torch.device("cpu"), eng, toks)
    assert moe_mod.route_topk is scattered
    assert flipped > 0.5
    assert pinned <= 1e-4 * max(1.0, scale) < diff, (pinned, diff)
