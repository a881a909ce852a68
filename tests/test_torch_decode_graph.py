"""The engine's one decode loop (``serving/decode_graph.py``) on the CPU, where
no step is captured: ``Engine.generate``'s tokens and each step's fp32 logits
bit for bit against per-step ``prefill`` + ``decode`` on fresh cache trees for
every mixer (scaled phi4-mini, qwen3, gemma2-2b with a sliding window past its
ring's wrap, mixtral's GQA + MoE with its pairs counted by phase, deepseek's
MLA + MoE, jamba's Mamba + GQA + MoE, rwkv6), batch sizes 1, 3 and 8 on one
shared store whose stale slots lie past the later batches' lengths; sampled
generation against a per-step ``multinomial``; the store's layout against
``init_cache`` and ``abstract_cache``; the rule that captures only GQA and MLA
models' greedy steps, on the card; the ``graph_steps`` / ``graph_captures``
stats with a stand-in for the CUDA graph (captures that another engine causes
included); and that the store goes with the last engine. The replay itself is
held on the card in ``test_torch_cuda.py``."""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.variants import VariantPool
from repro_torch.models import init_params
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import resolve_dtype
from repro_torch.serving import decode_graph
from repro_torch.serving.engine import Engine, EngineConfig

CPU = torch.device("cpu")
STEPS = 5
# (batch size, prompt length) in turns: the store grows at 3 and at 8, and
# the later, shorter prompts leave the earlier batches' caches in their slots
BATCHES = [(3, 12), (8, 9), (1, 5), (3, 7)]
# every mixer: dense GQA, GQA + MoE (mixtral), MLA + MoE, Mamba + GQA + MoE, RWKV
ARCHS = {"phi4-mini-3.8b": {}, "qwen3-32b": {}, "gemma2-2b": {"sliding_window": 8},
         "mixtral-8x7b": {}, "deepseek-v3-671b": {}, "jamba-1.5-large-398b": {},
         "rwkv6-1.6b": {}}


def _engine(arch, max_len, use_kernels=False, seed=1, **scaled):
    cfg = get_smoke_config(arch).scaled(dtype="float32", **scaled)
    params = init_params(cfg, seed, device="cpu")
    return cfg, Engine(cfg, params, EngineConfig(max_len=max_len, use_kernels=use_kernels),
                       device="cpu")


def _prompts(cfg, n, plen, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, size=(n, plen))


@torch.inference_mode()
def _per_step_logits(eng, toks, steps):
    """The prefill's and each greedy step's logits through the per-step API,
    on a fresh cache tree."""
    logits, caches, lengths = eng.prefill(toks)
    out = [logits]
    for _ in range(steps):
        logits, caches, lengths = eng.decode(caches, lengths, torch.argmax(logits, -1))
        out.append(logits)
    return out


@torch.inference_mode()
def _fixed_logits(eng, toks, steps):
    """The same through the engine's step of ``len(toks)`` rows, as
    ``generate`` runs it."""
    st = eng.runner.step_for(len(toks))
    logits, caches, lengths = eng.prefill(toks, out=st.caches)
    for g, unit in st.caches.items():            # the prefill wrote into the fixed views
        for sub, c in unit.items():
            assert all(x is y for x, y in zip(caches[g][sub], c))
    eng.runner.start(st, logits, lengths)
    out = [logits]
    for _ in range(steps):
        out.append(eng.runner.replay(st))
    assert st.lengths.tolist() == [toks.shape[1] + steps] * len(toks)
    return out


def _moe_layers(cfg) -> int:
    return sum(g.n_units for g in tfm.layer_plan(cfg) for sl in g.pattern if sl.mlp == "moe")


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fixed_step_equals_the_eager_loop_bit_for_bit(arch, use_kernels):
    cfg, eng = _engine(arch, 20, use_kernels, **ARCHS[arch])
    for k, (n, plen) in enumerate(BATCHES):
        toks = _prompts(cfg, n, plen, k)
        pairs0 = moe_lib.pair_counts(CPU).clone()
        want = _per_step_logits(eng, toks, STEPS)
        pairs1 = moe_lib.pair_counts(CPU).clone()
        got = _fixed_logits(eng, toks, STEPS)
        for i, (w, g) in enumerate(zip(want, got)):
            assert torch.equal(w, g), (arch, n, plen, i, (w - g).abs().max())
        # generate: the per-step API's greedy tokens, no step captured
        out = eng.generate(toks, STEPS)
        assert np.array_equal(out, torch.stack([w.argmax(-1) for w in want[:STEPS]], 1))
        assert (eng.last_stats["graph_steps"], eng.last_stats["graph_captures"]) == (0, 0)
        assert eng.last_stats["finite"] is True
        if cfg.moe is not None:     # the steps count their pairs, as the per-step API
            pairs = eng.last_stats["moe_pairs"]
            assert [pairs["prefill"][k] + pairs["decode"][k]
                    for k in ("routed", "held", "dropped")] == (pairs1 - pairs0).tolist()
            assert pairs["decode"]["routed"] == n * cfg.moe.top_k * _moe_layers(cfg) * STEPS


def test_batch_sizes_share_one_cache_sized_for_the_largest():
    cfg, eng = _engine("gemma2-2b", 21, sliding_window=8)
    for n in (1, 3, 8):
        eng.generate(_prompts(cfg, n, 6, n), 2)
    store, unit = eng.runner.store, eng.runner.layout["layers"]
    for sub, slots in (("sub0", 8), ("sub1", 21)):       # local ring, global slots
        for key, layers in unit[sub]:
            assert key[:2] == ("layers", sub) and layers == cfg.num_layers // 2
            assert store.caches[key].shape == (layers, 8, slots, cfg.num_kv_heads,
                                               cfg.head_dim)
        ptrs = {st.caches["layers"][sub].k.untyped_storage().data_ptr()
                for st in eng.runner.steps.values()}
        assert len(ptrs) == 1


@pytest.mark.parametrize("arch", sorted(ARCHS) + ["llava-next-mistral-7b", "musicgen-medium"])
def test_store_layout_agrees_with_init_cache_and_abstract_cache(arch):
    """Every tensor of the tree: ``init_cache``'s, ``abstract_cache``'s and
    the store's view of it have one type, shape and dtype, which the
    layout's key gives after (layers, batch)."""
    cfg = get_smoke_config(arch)
    n, max_len, dtype = 3, 12, resolve_dtype(cfg.dtype)
    eng = Engine(cfg, init_params(cfg, 0, device="cpu"), EngineConfig(max_len=max_len),
                 device="cpu")
    trees = (tfm.init_cache(cfg, n, max_len, dtype, device="cpu"),
             tfm.abstract_cache(cfg, n, max_len, dtype), eng.runner.step_for(n).caches)
    layout = decode_graph.cache_layout(cfg, max_len)
    assert all(t.keys() == layout.keys() for t in trees)
    for g, unit in layout.items():
        assert all(t[g].keys() == unit.keys() for t in trees)
        for sub, entries in unit.items():
            for f, (key, layers) in zip(entries._fields, entries):
                assert key[:3] == (g, sub, f)
                for t in trees:
                    assert type(t[g][sub]) is type(entries)
                    x = getattr(t[g][sub], f)
                    assert (x.shape, x.dtype) == ((layers, n) + key[3], key[4])


class _StandIn:
    """Stands in for a CUDA graph on the CPU: recording keeps the step, and
    each replay runs it."""

    def __init__(self, fn):
        self.replay = fn


@pytest.fixture
def captured(monkeypatch):
    """Every engine built inside on the graph route, each graph a stand-in.
    A stand-in's step refers back to its runner, a cycle that a CUDA graph
    does not make: the collection after the test frees the store with it."""
    monkeypatch.setattr(decode_graph, "graph_route", lambda cfg, device: True)
    monkeypatch.setattr(decode_graph, "_record", lambda store, fn: _StandIn(fn))
    yield
    gc.collect()


def test_graph_stats_count_steps_and_captures(captured):
    cfg, eng = _engine("phi4-mini-3.8b", 22)

    def run(n, steps=3):
        toks = _prompts(cfg, n, 6, n)
        out = eng.generate(toks, steps)
        want = _per_step_logits(eng, toks, steps)
        assert np.array_equal(out, torch.stack([w.argmax(-1) for w in want[:steps]], 1))
        st = eng.last_stats
        return st["graph_steps"], st["graph_captures"]

    assert run(3) == (3, 1)          # first use of 3: one step captured (a cache of 4 rows)
    assert run(3) == (3, 0)
    assert run(8) == (3, 2)          # the cache grows to 8: 3's step re-bound, 8's captured
    assert run(1) == (3, 1)
    assert run(8, steps=1) == (1, 0)
    # sampled generation runs its steps eagerly
    eng.generate(_prompts(cfg, 3, 6, 0), 3, sample_gen=torch.Generator().manual_seed(0))
    assert (eng.last_stats["graph_steps"], eng.last_stats["graph_captures"]) == (0, 0)


def test_a_capture_that_another_engine_causes_is_counted_in_its_call(captured):
    """A cache that grows re-captures the steps of every engine bound to it,
    during the call that grew it: that call's ``graph_captures`` counts them
    with its own (the device's captures during the call)."""
    cfg, a = _engine("phi4-mini-3.8b", 22)
    b = Engine(cfg, a.params, EngineConfig(max_len=22, use_kernels=False), device="cpu")
    assert b.runner.store is a.runner.store
    a.generate(_prompts(cfg, 3, 6, 0), 2)
    assert (a.last_stats["graph_steps"], a.last_stats["graph_captures"]) == (2, 1)
    b.generate(_prompts(cfg, 8, 6, 1), 2)      # 4 rows -> 8: a's step of 3 re-captured
    assert (b.last_stats["graph_steps"], b.last_stats["graph_captures"]) == (2, 2)
    assert a.runner.store.captures == 3
    a.generate(_prompts(cfg, 3, 6, 2), 2)
    assert (a.last_stats["graph_steps"], a.last_stats["graph_captures"]) == (2, 0)


def test_sampled_generation_runs_the_eager_loop(captured):
    """Sampled tokens are the per-step API's: the prefill's argmax, then one
    ``multinomial`` a step from the caller's generator; on the graph route
    nothing is captured or replayed for them."""
    cfg, eng = _engine("qwen3-32b", 18)
    toks = _prompts(cfg, 3, 8, 5)
    got = eng.generate(toks, 4, sample_gen=torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(11)
    want = []
    with torch.inference_mode():
        logits, caches, lengths = eng.prefill(toks)
        tok = torch.argmax(logits, dim=-1)
        for _ in range(4):
            want.append(tok)
            logits, caches, lengths = eng.decode(caches, lengths, tok)
            tok = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=gen)[:, 0]
    assert np.array_equal(got, torch.stack(want, 1))
    assert (eng.last_stats["graph_steps"], eng.last_stats["graph_captures"]) == (0, 0)
    assert all(st.graph is None for st in eng.runner.steps.values())


def test_engines_of_two_depths_share_the_store():
    """Levels 0 and 4 of a 4-layer phi4 (3 layers at level 4) decode on one
    cache of 4 layers; each matches its own per-step decoding, in turns."""
    base = get_smoke_config("phi4-mini-3.8b").scaled(num_layers=4)
    pool = VariantPool(base)
    engines = []
    for level in (0, 4):
        cfg = pool[level].config.scaled(dtype="float32")
        engines.append(Engine(cfg, init_params(cfg, 2 + level, device="cpu"),
                              EngineConfig(max_len=19), device="cpu"))
    assert [e.cfg.num_layers for e in engines] == [4, 3]
    assert engines[0].runner.store is engines[1].runner.store
    for k, (n, plen) in enumerate([(2, 9), (5, 11), (2, 6), (5, 4)]):
        for eng in engines:
            toks = _prompts(eng.cfg, n, plen, 10 + k)
            want = _per_step_logits(eng, toks, 4)
            assert np.array_equal(eng.generate(toks, 4),
                                  torch.stack([w.argmax(-1) for w in want[:4]], 1))
    eng = engines[1]
    for key, layers in eng.runner.layout["layers"]["sub0"]:
        assert layers == 3 and eng.runner.store.caches[key].shape[:2] == (4, 8)


def test_the_store_goes_with_the_last_engine():
    """No reference cycle holds the caches: dropping the engines frees the
    store at once, without a garbage collection (the harness drops its
    engines and empties the card's cache before its check)."""
    gc.disable()
    try:
        cfg, eng = _engine("phi4-mini-3.8b", 17)
        eng.generate(_prompts(cfg, 2, 5, 0), 2)
        ref = weakref.ref(eng.runner.store)
        other = Engine(cfg, eng.params, EngineConfig(max_len=17), device="cpu")
        assert other.runner.store is ref()
        del eng
        assert ref() is not None                 # the other engine still holds it
        del other
        assert ref() is None and decode_graph._STORES.get(CPU) is None
    finally:
        gc.enable()


ROUTED = ["phi4-mini-3.8b", "qwen3-32b", "gemma2-2b", "llava-next-mistral-7b",
          "musicgen-medium", "mixtral-8x7b", "deepseek-v3-671b"]
EAGER = ["jamba-1.5-large-398b", "rwkv6-1.6b"]


@pytest.mark.parametrize("arch", ROUTED + EAGER)
def test_graph_route_engages_for_gqa_or_mla_with_dense_or_moe_mlps_on_the_card_only(arch):
    cfg = get_smoke_config(arch)
    assert decode_graph.graph_route(cfg, torch.device("cuda")) == (arch in ROUTED)
    assert not decode_graph.graph_route(cfg, CPU)
    full = VariantPool(cfg)[5].config
    assert decode_graph.graph_route(full, torch.device("cuda")) == (arch in ROUTED)
    eng = Engine(cfg, init_params(cfg, 0, device="cpu"), EngineConfig(max_len=8),
                 device="cpu")
    assert not eng.runner.captured


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dense_layers", [1, 0], ids=["dense-prelude", "moe-only"])
def test_graph_route_takes_mla_with_a_dense_prelude_on_the_card_only(dense_layers, device):
    """deepseek with its dense prelude (``mla`` + ``dense`` sublayers before
    the ``mla`` + ``moe`` ones) and without it (the benchmark's stage of MoE
    layers) replays on the card; the CPU runs both eagerly."""
    cfg = get_smoke_config("deepseek-v3-671b").scaled(num_dense_layers=dense_layers)
    plan = {(sl.mixer, sl.mlp) for g in tfm.layer_plan(cfg) for sl in g.pattern}
    assert plan == ({("mla", "dense"), ("mla", "moe")} if dense_layers else {("mla", "moe")})
    assert decode_graph.graph_route(cfg, torch.device(device)) == (device == "cuda")
