"""Port serving engine on the CPU: prefill/decode consistency against the
full forward pass, the ring-buffer slot invariant, and greedy ``generate``
emitting the same tokens as the JAX engine on the same fp32 weights, with a
sliding window (past the wrap of the ring) and without, and for the
recurrent (rwkv6), hybrid Mamba + MoE (jamba), MoE (mixtral) and MLA + MoE
(deepseek-v3) models."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.attention import KVCache as JaxKVCache
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import _pad_kv as jax_pad_kv
from repro_torch.configs import get_smoke_config as _port_smoke_config
from repro_torch.models import forward, init_params
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache, layer_window, place_kv
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import BatchScheduler, Engine, EngineConfig

from _torch_util import as_np, jax_form, numpy_params, tree_to_jax


def get_smoke_config(arch):
    """The port's smoke configuration in the form the JAX package runs it
    (``jax_form``: deepseek-v3's router and RoPE as the JAX package's)."""
    return jax_form(_port_smoke_config(arch))


ARCHS = ["phi4-mini-3.8b", "qwen3-32b", "gemma2-2b", "llava-next-mistral-7b",
         "musicgen-medium", "rwkv6-1.6b", "jamba-1.5-large-398b", "mixtral-8x7b"]


def _setup(arch, seed, b, s, **scaled):
    cfg = get_smoke_config(arch).scaled(dtype="float32", **scaled)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s))
    embeds = None
    if cfg.frontend_stub:
        embeds = rng.standard_normal(
            (b, cfg.stub_embed_len, cfg.d_model)).astype(np.float32)
    return cfg, toks, embeds


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, use_kernels):
    cfg, toks, embeds = _setup(arch, 21, 2, 12)
    params = init_params(cfg, 1, device="cpu")
    total = 12 + (cfg.stub_embed_len if cfg.frontend_stub else 0)
    eng = Engine(cfg, params, EngineConfig(max_len=total + 8,
                                           use_kernels=use_kernels), device="cpu")
    t_toks = torch.from_numpy(toks)
    t_emb = None if embeds is None else torch.from_numpy(embeds)
    with torch.inference_mode():
        logits_full, _ = forward(cfg, params, t_toks, t_emb)
    l_pref, caches, lengths = eng.prefill(t_toks, t_emb)
    np.testing.assert_allclose(as_np(l_pref), as_np(logits_full[:, -1]),
                               atol=2e-4, rtol=2e-4)
    cur = t_toks
    for _ in range(2):
        nxt = torch.argmax(l_pref, dim=-1)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
        with torch.inference_mode():
            full, _ = forward(cfg, params, cur, t_emb)
        before = caches
        l_pref, caches, lengths = eng.decode(caches, lengths, nxt)
        assert caches is before          # the caches are written in place
        np.testing.assert_allclose(as_np(l_pref), as_np(full[:, -1]),
                                   atol=5e-4, rtol=5e-4)
    assert lengths.tolist() == [total + 2] * 2


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_sliding_window_ring_buffer(use_kernels):
    """Prompt longer than the window: decode must still match the full
    forward (ring-buffer roll invariant: slot p%w holds position p)."""
    cfg, toks, _ = _setup("gemma2-2b", 22, 1, 13, sliding_window=8)
    params = init_params(cfg, 2, device="cpu")
    eng = Engine(cfg, params, EngineConfig(max_len=24, use_kernels=use_kernels),
                 device="cpu")
    cur = torch.from_numpy(toks)
    l_pref, caches, lengths = eng.prefill(cur)
    assert caches["layers"]["sub0"].k.shape[2] == 8       # local layer: window
    assert caches["layers"]["sub1"].k.shape[2] == 24      # global layer: max_len
    for _ in range(10):                                   # 13 -> 23: wraps again
        with torch.inference_mode():
            full, _ = forward(cfg, params, cur)
        np.testing.assert_allclose(as_np(l_pref), as_np(full[:, -1]),
                                   atol=5e-4, rtol=5e-4)
        nxt = torch.argmax(l_pref, dim=-1)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
        l_pref, caches, lengths = eng.decode(caches, lengths, nxt)


def _place(x, max_len, seq_len, window):
    """A prompt's stacked K and V placed into fresh zeroed decode caches, as
    the engine's prefill places them."""
    s_cache = max_len if window is None else min(window, max_len)
    t = torch.from_numpy(x)
    return KVCache(*(place_kv(t, t.new_zeros(t.shape[:2] + (s_cache,) + t.shape[3:]),
                              seq_len, window) for _ in "kv"))


@pytest.mark.parametrize("S,w", [(13, 8), (16, 8), (8, 8), (9, 4), (5, 8)])
def test_pad_caches_ring_slot_invariant(S, w):
    """After ``place_kv`` a sliding-window cache holds position p in slot
    p % window for each of the last ``window`` prefill positions, and the
    buffer equals the one the JAX engine's ``_pad_kv`` pads to."""
    L, B, KV, D = 2, 1, 1, 4
    x = np.broadcast_to(np.arange(S, dtype=np.float32)[None, None, :, None, None],
                        (L, B, S, KV, D)).copy()
    out = _place(x, max_len=32, seq_len=S, window=w)
    ref = jax_pad_kv(JaxKVCache(k=jnp.asarray(x), v=jnp.asarray(x)),
                     max_len=32, seq_len=S, window=w)
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(ref.v))
    if S >= w:
        assert out.k.shape[2] == w
        for p in range(S - w, S):
            np.testing.assert_array_equal(out.k.numpy()[:, :, p % w],
                                          np.full((L, B, KV, D), p, np.float32))
    else:
        for p in range(S):
            np.testing.assert_array_equal(out.k.numpy()[:, :, p],
                                          np.full((L, B, KV, D), p, np.float32))
    # unwindowed: zero-padded to max_len, identity layout
    lin = _place(x, max_len=32, seq_len=S, window=None)
    assert lin.k.shape[2] == 32
    np.testing.assert_array_equal(lin.k.numpy()[:, :, :S], x)
    assert float(lin.k[:, :, S:].abs().sum()) == 0.0


@pytest.mark.parametrize("arch,scaled,mixers", [
    ("phi4-mini-3.8b", {}, {"gqa"}), ("gemma2-2b", {"sliding_window": 8}, {"gqa"}),
    ("mixtral-8x7b", {}, {"gqa"}), ("jamba-1.5-large-398b", {}, {"gqa", "mamba"}),
    ("deepseek-v3-671b", {}, {"mla"}), ("rwkv6-1.6b", {}, {"rwkv"})])
def test_prefill_writes_gqa_kv_into_decode_caches(arch, scaled, mixers):
    """The engine's prefill writes every layer's cache into the decode cache
    tree it is handed, and each tensor it hands back is the one handed in:
    GQA K/V in ``max_len`` slots (the window's ring where it has one), MLA
    latents and rope keys in their first S slots, Mamba and RWKV states
    whole, each equal to the model's raw prompt-length cache placed into
    the tree; slots past the prompt keep what they held."""
    cfg = get_smoke_config(arch).scaled(dtype="float32", **scaled)
    params = init_params(cfg, 0, device="cpu")
    max_len, s, held = 20, 13, 7.0
    eng = Engine(cfg, params, EngineConfig(max_len=max_len), device="cpu")
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, size=(2, s))
    tree = tfm.init_cache(cfg, 2, max_len, torch.float32, device="cpu")
    for unit in tree.values():
        for c in unit.values():
            for t in c:
                t.fill_(held)
    _, caches, _ = eng.prefill(toks, out=tree)
    with torch.inference_mode():
        _, raw = model_lib.prefill(cfg, params, torch.from_numpy(toks), use_kernels=True)
    kinds = set()
    for g in tfm.layer_plan(cfg):
        for i, sl in enumerate(g.pattern):
            got, want = caches[g.name][f"sub{i}"], raw[g.name][f"sub{i}"]
            assert type(got) is type(want)
            assert all(a is b for a, b in zip(got, tree[g.name][f"sub{i}"]))
            kinds.add(sl.mixer)
            if sl.mixer == "gqa":
                window = layer_window(cfg, sl.is_global)
                slots = max_len if window is None else min(window, max_len)
                assert got.k.shape == want.k.shape[:2] + (slots,) + want.k.shape[3:]
                want = [place_kv(t, torch.full_like(got.k, held), s, window) for t in want]
            elif sl.mixer == "mla":
                want = [torch.cat([t, torch.full(t.shape[:2] + (max_len - s,) + t.shape[3:],
                                                 held)], dim=2) for t in want]
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kinds == mixers


GENERATE_CASES = [
    ("phi4-mini-3.8b", {}, 8, 10),                       # unwindowed
    ("gemma2-2b", {"sliding_window": 8}, 6, 14),         # wraps while decoding
    ("gemma2-2b", {"sliding_window": 8}, 13, 12),        # prompt past the window
    ("musicgen-medium", {}, 6, 6),                       # stub frontend, sinusoidal
    ("rwkv6-1.6b", {}, 12, 8),                           # recurrent state, no cache
    ("jamba-1.5-large-398b", {}, 12, 8),                 # Mamba states + KV, MoE
    ("mixtral-8x7b", {}, 10, 10),                        # MoE, window 16 wraps
    ("deepseek-v3-671b", {}, 11, 8),                     # MLA latent caches, MoE
]


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
@pytest.mark.parametrize("arch,scaled,s,steps", GENERATE_CASES)
def test_generate_matches_jax_engine(arch, scaled, s, steps, use_kernels):
    cfg, toks, embeds = _setup(arch, 23, 2, s, **scaled)
    jcfg = jax_smoke_config(arch).scaled(dtype="float32", **scaled)
    tree = numpy_params(cfg, seed=24)
    total = s + (cfg.stub_embed_len if cfg.frontend_stub else 0)
    max_len = total + steps + 2
    jeng = JaxEngine(jcfg, tree_to_jax(tree), JaxEngineConfig(max_len=max_len))
    want = jeng.generate(jnp.asarray(toks, jnp.int32), num_steps=steps,
                         embeds=None if embeds is None else jnp.asarray(embeds))
    eng = Engine(cfg, params_from_jax(cfg, tree, device="cpu"),
                 EngineConfig(max_len=max_len, use_kernels=use_kernels),
                 device="cpu")
    got = eng.generate(toks, num_steps=steps, embeds=embeds)
    assert got.shape == (2, steps) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert eng.last_stats["finite"] and eng.last_stats["prefill_ms"] > 0


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_rwkv6_decode_writes_state_in_place(use_kernels):
    """The RWKV state is fixed-size: the prefill writes it into the decode
    cache tree whole, and a decode step copies the new state into the very
    tensors it was given."""
    from repro_torch.models.ssm import RWKVState
    cfg, toks, _ = _setup("rwkv6-1.6b", 27, 2, 9)
    eng = Engine(cfg, init_params(cfg, 5, device="cpu"),
                 EngineConfig(max_len=16, use_kernels=use_kernels), device="cpu")
    logits, caches, lengths = eng.prefill(toks)
    st = caches["layers"]["sub0"]
    nh, hd = cfg.d_model // cfg.ssm.wkv_head_dim, cfg.ssm.wkv_head_dim
    assert isinstance(st, RWKVState)
    assert st.wkv.shape == (cfg.num_layers, 2, nh, hd, hd)
    assert st.wkv.dtype == torch.float32
    assert st.shift_t.shape == st.shift_c.shape == (cfg.num_layers, 2, cfg.d_model)
    before = [t.clone() for t in st]
    leaves = list(st)
    out, caches2, _ = eng.decode(caches, lengths, torch.argmax(logits, dim=-1))
    assert caches2 is caches
    for t, old, b in zip(caches2["layers"]["sub0"], leaves, before):
        assert t is old
        assert not torch.equal(t, b)        # the step did write the state


@pytest.mark.parametrize("use_kernels", [False, True], ids=["einsum", "kernels"])
def test_jamba_decode_writes_mamba_state_in_place(use_kernels):
    """A Mamba state is fixed-size: the prefill writes it into the decode
    cache tree whole, and a decode step copies the new state into the very
    tensors it was given; the attention layer's cache has ``max_len``
    slots."""
    from repro_torch.models.ssm import MambaState
    cfg, toks, _ = _setup("jamba-1.5-large-398b", 29, 2, 9)
    eng = Engine(cfg, init_params(cfg, 7, device="cpu"),
                 EngineConfig(max_len=16, use_kernels=use_kernels), device="cpu")
    logits, caches, lengths = eng.prefill(toks)
    units, d_in = cfg.num_layers // 8, cfg.ssm.expand * cfg.d_model
    st = caches["layers"]["sub0"]
    assert isinstance(st, MambaState)
    assert st.h.shape == (units, 2, d_in, cfg.ssm.d_state) and st.h.dtype == torch.float32
    assert st.conv.shape == (units, 2, cfg.ssm.d_conv - 1, d_in)
    assert caches["layers"]["sub3"].k.shape == (units, 2, 16, cfg.num_kv_heads,
                                                cfg.head_dim)
    before = [t.clone() for t in st]
    leaves = list(st)
    out, caches2, _ = eng.decode(caches, lengths, torch.argmax(logits, dim=-1))
    assert caches2 is caches
    for t, old, b in zip(caches2["layers"]["sub0"], leaves, before):
        assert t is old
        assert not torch.equal(t, b)        # the step did write the state


def test_jamba_decode_from_an_empty_state():
    """``init_cache`` gives jamba zero Mamba states and K/V buffers; one
    decode step from them equals the forward pass on that token."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.ssm import MambaState
    cfg, toks, _ = _setup("jamba-1.5-large-398b", 30, 2, 1)
    params = init_params(cfg, 8, device="cpu")
    caches = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    assert isinstance(caches["layers"]["sub1"], MambaState)
    assert all(float(t.abs().sum()) == 0.0 for t in caches["layers"]["sub1"])
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        logits, caches, lengths = decode_step(
            cfg, params, caches, torch.zeros(2, dtype=torch.long), t[:, 0],
            use_kernels=True)
        full, _ = forward(cfg, params, t)
    assert lengths.tolist() == [1, 1]
    np.testing.assert_allclose(as_np(logits), as_np(full[:, 0]), atol=5e-4, rtol=5e-4)


def test_generate_deterministic_and_sampled():
    cfg, toks, _ = _setup("qwen3-32b", 25, 2, 8)
    eng = Engine(cfg, init_params(cfg, 3, device="cpu"), EngineConfig(max_len=32),
                 device="cpu")
    g1 = eng.generate(toks, num_steps=5)
    g2 = eng.generate(toks, num_steps=5)
    assert g1.shape == (2, 5)
    np.testing.assert_array_equal(g1, g2)
    s1 = eng.generate(toks, 5, sample_gen=torch.Generator().manual_seed(1))
    s2 = eng.generate(toks, 5, sample_gen=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(s1, s2)
    assert s1.min() >= 0 and s1.max() < cfg.vocab_size


def test_decode_from_an_empty_cache():
    """``init_cache`` gives the stacked decode buffers (window-sized for local
    layers); one decode step into it equals the forward pass on that token."""
    from repro_torch.models import decode_step, init_cache
    cfg, toks, _ = _setup("gemma2-2b", 26, 2, 1, sliding_window=8)
    params = init_params(cfg, 4, device="cpu")
    caches = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    n = cfg.num_layers // 2
    assert caches["layers"]["sub0"].k.shape == (n, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    assert caches["layers"]["sub1"].v.shape == (n, 2, 16, cfg.num_kv_heads, cfg.head_dim)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        logits, caches, lengths = decode_step(
            cfg, params, caches, torch.zeros(2, dtype=torch.long), t[:, 0],
            use_kernels=True)
        full, _ = forward(cfg, params, t)
    assert lengths.tolist() == [1, 1]
    np.testing.assert_allclose(as_np(logits), as_np(full[:, 0]), atol=5e-4, rtol=5e-4)


def test_rwkv6_decode_from_an_empty_state():
    """``init_cache`` gives rwkv6 a zero ``RWKVState`` stacked over the
    layers; one decode step from it equals the forward pass on that token."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.ssm import RWKVState
    cfg, toks, _ = _setup("rwkv6-1.6b", 28, 2, 1)
    params = init_params(cfg, 6, device="cpu")
    caches = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    st = caches["layers"]["sub0"]
    nh, hd = cfg.d_model // cfg.ssm.wkv_head_dim, cfg.ssm.wkv_head_dim
    assert isinstance(st, RWKVState)
    assert st.wkv.shape == (cfg.num_layers, 2, nh, hd, hd)
    assert st.shift_c.shape == (cfg.num_layers, 2, cfg.d_model)
    assert all(float(t.abs().sum()) == 0.0 for t in st)
    t = torch.from_numpy(toks)
    with torch.inference_mode():
        logits, caches, lengths = decode_step(
            cfg, params, caches, torch.zeros(2, dtype=torch.long), t[:, 0],
            use_kernels=True)
        full, _ = forward(cfg, params, t)
    assert lengths.tolist() == [1, 1]
    np.testing.assert_allclose(as_np(logits), as_np(full[:, 0]), atol=5e-4, rtol=5e-4)


def test_engine_defaults():
    assert EngineConfig().use_kernels is True
    cfg = get_smoke_config("phi4-mini-3.8b")
    with pytest.raises(AssertionError, match="max_len"):
        eng = Engine(cfg.scaled(dtype="float32"), init_params(cfg, 0, device="cpu"),
                     EngineConfig(max_len=4), device="cpu")
        eng.prefill(np.zeros((1, 8), np.int64))


def test_batch_scheduler_left_pads_and_fifo():
    sched = BatchScheduler(batch_size=3)
    for p in ([1, 2, 3], [4, 5], [6]):
        sched.add(np.asarray(p, np.int32))
    batch = sched.next_batch()
    assert batch.shape == (3, 3)
    np.testing.assert_array_equal(batch[1], [0, 4, 5])
    assert sched.next_batch() is None
    sched = BatchScheduler(batch_size=2)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (3, 1, 2, 4, 2)]
    for p in prompts:
        sched.add(p)
    seen = []
    while (batch := sched.next_batch()) is not None:
        assert batch.shape[0] <= 2
        seen.extend(row[row != 0].tolist() for row in batch)
    assert seen == [p.tolist() for p in prompts]


def test_batch_scheduler_continuous_holds_partial_batch():
    sched = BatchScheduler(batch_size=2, continuous=True, window_s=1.0)
    sched.add(np.asarray([1], np.int32), now=0.0)
    assert sched.next_batch(now=0.5) is None          # held for joiners
    sched.add(np.asarray([2], np.int32), now=0.6)
    assert sched.next_batch(now=0.6).shape == (2, 1)  # the join fills it
    sched.add(np.asarray([3], np.int32), now=1.0)
    assert sched.next_batch(now=2.0).shape == (1, 1)  # window expired
