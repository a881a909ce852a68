"""The engine's fixed-buffer decode step (``serving/decode_graph.py``) on the
CPU, where it runs without capture: tokens and fp32 logits bit for bit
against the eager loop at scaled phi4-mini, qwen3, gemma2-2b (a sliding
window past its ring's wrap) and mixtral (GQA + MoE, its pairs counted by
phase as the eager loop counts them), batch sizes 1, 3 and 8 on one shared cache
whose stale slots lie past the later batches' lengths, the rule that sends
MLA, Mamba, RWKV, the CPU and sampled generation to the eager loop, the
``graph_steps`` / ``graph_captures`` stats (captures that another engine
causes included), and that the store goes with the last engine. The replay itself is held on the card in ``test_torch_cuda.py``."""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.variants import VariantPool
from repro_torch.models import init_params
from repro_torch.serving import decode_graph
from repro_torch.serving.engine import Engine, EngineConfig

CPU = torch.device("cpu")
STEPS = 5
# (batch size, prompt length) in turns: the cache grows at 3 and at 8, and
# the later, shorter prompts leave the earlier batches' K/V in their slots
BATCHES = [(3, 12), (8, 9), (1, 5), (3, 7)]
# the graph route's models: dense, and a GQA + MoE one (mixtral)
ROUTE = {"phi4-mini-3.8b": {}, "qwen3-32b": {}, "gemma2-2b": {"sliding_window": 8},
         "mixtral-8x7b": {}}


def _engines(arch, max_len, use_kernels=False, seed=1, **scaled):
    """An eager engine and one on the fixed-buffer step, on the same weights."""
    cfg = get_smoke_config(arch).scaled(dtype="float32", **scaled)
    params = init_params(cfg, seed, device="cpu")
    ecfg = EngineConfig(max_len=max_len, use_kernels=use_kernels)
    eager, fixed = (Engine(cfg, params, ecfg, device="cpu") for _ in range(2))
    assert eager.graphs is None and fixed.graphs is None      # the CPU: eager
    fixed.graphs = decode_graph.DecodeGraphs(cfg, params, max_len=max_len,
                                             use_kernels=use_kernels, device=CPU)
    return cfg, eager, fixed


def _prompts(cfg, n, plen, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, size=(n, plen))


@torch.inference_mode()
def _eager_logits(eng, toks, steps):
    logits, caches, lengths = eng.prefill(toks)
    out = [logits]
    for _ in range(steps):
        logits, caches, lengths = eng.decode(caches, lengths, torch.argmax(logits, -1))
        out.append(logits)
    return out


@torch.inference_mode()
def _fixed_logits(eng, toks, steps):
    st = eng.graphs.step_for(len(toks))
    logits, caches, lengths = eng.prefill(toks, out=st.caches)
    for g, unit in st.caches.items():            # the prefill wrote into the fixed views
        for sub, c in unit.items():
            assert all(x is y for x, y in zip(caches[g][sub], c))
    eng.graphs.start(st, logits, lengths)
    out = [logits]
    for _ in range(steps):
        eng.graphs.replay(st)
        out.append(st.logits)
    assert st.lengths.tolist() == [toks.shape[1] + steps] * len(toks)
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch", sorted(ROUTE))
def test_fixed_step_equals_the_eager_loop_bit_for_bit(arch, use_kernels):
    cfg, eager, fixed = _engines(arch, 20, use_kernels, **ROUTE[arch])
    for k, (n, plen) in enumerate(BATCHES):
        toks = _prompts(cfg, n, plen, k)
        want, got = _eager_logits(eager, toks, STEPS), _fixed_logits(fixed, toks, STEPS)
        for i, (w, g) in enumerate(zip(want, got)):
            assert torch.equal(w, g), (arch, n, plen, i, (w - g).abs().max())
        # generate: the same tokens, the fixed route's steps counted
        assert np.array_equal(eager.generate(toks, STEPS), fixed.generate(toks, STEPS))
        assert fixed.last_stats["graph_steps"] == STEPS
        assert eager.last_stats["graph_steps"] == 0
        assert fixed.last_stats["finite"] is True
        if cfg.moe is not None:     # the replays count their pairs, as the eager loop
            pairs = fixed.last_stats["moe_pairs"]
            assert pairs == eager.last_stats["moe_pairs"]
            assert pairs["decode"]["routed"] == n * cfg.moe.top_k * cfg.num_layers * STEPS


def test_batch_sizes_share_one_cache_sized_for_the_largest():
    cfg, _, fixed = _engines("gemma2-2b", 21, sliding_window=8)
    for n in (1, 3, 8):
        fixed.generate(_prompts(cfg, n, 6, n), 2)
    store = fixed.graphs.store
    geos = [geo for geo, _ in fixed.graphs.layout]
    assert [geo[2] for geo in geos] == [8, 21]           # local ring, global slots
    for geo in geos:
        c = store.caches[geo]
        assert c.k.shape == (cfg.num_layers // 2, 8, geo[2], cfg.num_kv_heads, cfg.head_dim)
    for sub in ("sub0", "sub1"):
        ptrs = {st.caches["layers"][sub].k.untyped_storage().data_ptr()
                for st in fixed.graphs.steps.values()}
        assert len(ptrs) == 1


def test_graph_stats_count_steps_and_captures():
    cfg, _, fixed = _engines("phi4-mini-3.8b", 22)

    def run(n, steps=3):
        fixed.generate(_prompts(cfg, n, 6, n), steps)
        st = fixed.last_stats
        return st["graph_steps"], st["graph_captures"]

    assert run(3) == (3, 1)          # first use of 3: one step built (a cache of 4 rows)
    assert run(3) == (3, 0)
    assert run(8) == (3, 2)          # the cache grows to 8: 3's step re-bound, 8's built
    assert run(1) == (3, 1)
    assert run(8, steps=1) == (1, 0)
    # sampled generation keeps the eager loop
    fixed.generate(_prompts(cfg, 3, 6, 0), 3, sample_gen=torch.Generator().manual_seed(0))
    assert (fixed.last_stats["graph_steps"], fixed.last_stats["graph_captures"]) == (0, 0)


def test_a_capture_that_another_engine_causes_is_counted_in_its_call():
    """A cache that grows re-builds the steps of every engine bound to it,
    during the call that grew it: that call's ``graph_captures`` counts them
    with its own (the device's captures during the call)."""
    cfg, _, a = _engines("phi4-mini-3.8b", 22)
    b = Engine(cfg, a.params, EngineConfig(max_len=22, use_kernels=False), device="cpu")
    b.graphs = decode_graph.DecodeGraphs(cfg, a.params, max_len=22, use_kernels=False,
                                         device=CPU)
    assert b.graphs.store is a.graphs.store
    a.generate(_prompts(cfg, 3, 6, 0), 2)
    assert (a.last_stats["graph_steps"], a.last_stats["graph_captures"]) == (2, 1)
    b.generate(_prompts(cfg, 8, 6, 1), 2)      # 4 rows -> 8: a's step of 3 re-built
    assert (b.last_stats["graph_steps"], b.last_stats["graph_captures"]) == (2, 2)
    assert a.graphs.store.captures == 3
    a.generate(_prompts(cfg, 3, 6, 2), 2)
    assert (a.last_stats["graph_steps"], a.last_stats["graph_captures"]) == (2, 0)


def test_sampled_generation_runs_the_eager_loop():
    cfg, eager, fixed = _engines("qwen3-32b", 18)
    toks = _prompts(cfg, 3, 8, 5)
    got = fixed.generate(toks, 4, sample_gen=torch.Generator().manual_seed(11))
    want = eager.generate(toks, 4, sample_gen=torch.Generator().manual_seed(11))
    assert np.array_equal(got, want)
    assert fixed.graphs.steps == {}


def test_engines_of_two_depths_share_the_store():
    """Levels 0 and 4 of a 4-layer phi4 (3 layers at level 4) decode on one
    cache of 4 layers; each matches its own eager engine, in turns."""
    base = get_smoke_config("phi4-mini-3.8b").scaled(num_layers=4)
    pool = VariantPool(base)
    pairs = []
    for level in (0, 4):
        cfg = pool[level].config.scaled(dtype="float32")
        params = init_params(cfg, 2 + level, device="cpu")
        eager = Engine(cfg, params, EngineConfig(max_len=19), device="cpu")
        fixed = Engine(cfg, params, EngineConfig(max_len=19), device="cpu")
        fixed.graphs = decode_graph.DecodeGraphs(cfg, params, max_len=19, use_kernels=False,
                                                 device=CPU)
        pairs.append((cfg, eager, fixed))
    assert [p[0].num_layers for p in pairs] == [4, 3]
    assert pairs[0][2].graphs.store is pairs[1][2].graphs.store
    for k, (n, plen) in enumerate([(2, 9), (5, 11), (2, 6), (5, 4)]):
        for cfg, eager, fixed in pairs:
            toks = _prompts(cfg, n, plen, 10 + k)
            assert np.array_equal(eager.generate(toks, 4), fixed.generate(toks, 4))
    (geo, layers), = pairs[1][2].graphs.layout
    assert layers == 3 and pairs[1][2].graphs.store.caches[geo].k.shape[:2] == (4, 8)


def test_the_store_goes_with_the_last_engine():
    """No reference cycle holds the caches: dropping the engines frees the
    store at once, without a garbage collection (the harness drops its
    engines and empties the card's cache before its check)."""
    gc.disable()
    try:
        _, eager, fixed = _engines("phi4-mini-3.8b", 17)
        toks = _prompts(fixed.cfg, 2, 5, 0)
        fixed.generate(toks, 2)
        ref = weakref.ref(fixed.graphs.store)
        other = Engine(fixed.cfg, fixed.params, EngineConfig(max_len=17), device="cpu")
        other.graphs = decode_graph.DecodeGraphs(other.cfg, other.params, max_len=17,
                                                 use_kernels=False, device=CPU)
        assert other.graphs.store is ref()
        del fixed
        assert ref() is not None                 # the other engine still holds it
        del other
        assert ref() is None and decode_graph._STORES.get(CPU) is None
    finally:
        gc.enable()


ROUTED = ["phi4-mini-3.8b", "qwen3-32b", "gemma2-2b", "llava-next-mistral-7b",
          "musicgen-medium", "mixtral-8x7b"]
EAGER = ["deepseek-v3-671b", "jamba-1.5-large-398b", "rwkv6-1.6b"]


@pytest.mark.parametrize("arch", ROUTED + EAGER)
def test_graph_route_engages_for_gqa_with_dense_or_moe_mlps_on_the_card_only(arch):
    cfg = get_smoke_config(arch)
    assert decode_graph.graph_route(cfg, torch.device("cuda")) == (arch in ROUTED)
    assert not decode_graph.graph_route(cfg, CPU)
    full = VariantPool(cfg)[5].config
    assert decode_graph.graph_route(full, torch.device("cuda")) == (arch in ROUTED)
    eng = Engine(cfg, init_params(cfg, 0, device="cpu"), EngineConfig(max_len=8),
                 device="cpu")
    assert eng.graphs is None
