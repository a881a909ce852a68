"""The port's spans and counted host syncs (``repro_torch.core.trace``) on the
CPU at smoke size: ``Engine.last_stats``' per-step intervals, host times and
sync counts for a dense model and a MoE at a full-depth and a cut level; the
profiler ranges of the engine, the MoE dispatch, the gateway and the
trainer's update; and no ``record_function`` at all while no profiler
records."""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import trace
from repro_torch.core.resource_manager import Event
from repro_torch.core.variants import VariantPool
from repro_torch.launch.serve import build_gateway, demo_requests
from repro_torch.models import init_params
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.train import train_step as ts

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
STEPS = 3
PROMPT = 6

# (arch, layers, level): mixtral cut to 4 layers keeps 4 at levels 0-3 and 3
# at levels 4-5, every layer a MoE layer
CASES = [("phi4-mini-3.8b", None, 0), ("mixtral-8x7b", 4, 0), ("mixtral-8x7b", 4, 5)]


def _engine(arch, layers, level):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    if layers is not None:
        cfg = cfg.scaled(num_layers=layers)
    vcfg = VariantPool(cfg)[level].config
    eng = Engine(vcfg, init_params(vcfg, 3, device="cpu"),
                 EngineConfig(max_len=PROMPT + STEPS + 1), device="cpu")
    toks = np.random.default_rng(4).integers(1, vcfg.vocab_size, size=(2, PROMPT))
    return vcfg, eng, toks


def _moe_layers(cfg) -> int:
    return cfg.num_layers if cfg.moe is not None else 0


def _want_syncs(cfg, steps) -> dict:
    want = {"engine.upload": 1, "engine.collect": 2}
    if cfg.moe is not None:
        want["moe.dispatch"] = _moe_layers(cfg) * (1 + steps)
    return want


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("engine.decode_step") is trace.NULL
    assert trace.span("gateway.handle") is trace.span("moe.dispatch")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(trace.span("x"), torch.profiler.record_function)


def test_host_sync_counts_and_times_each_entry():
    before, wait0 = dict(trace.counts), trace.wait_s()
    for _ in range(3):
        with trace.host_sync("test.sync"):
            pass
    with trace.host_sync("test.other"):
        pass
    assert trace.counts_since(before) == {"test.sync": 3, "test.other": 1}
    assert trace.wait_s() >= wait0
    assert trace.counts_since(dict(trace.counts)) == {}


@pytest.mark.parametrize("arch,layers,level", CASES)
def test_last_stats_steps_host_times_and_syncs(arch, layers, level):
    cfg, eng, toks = _engine(arch, layers, level)
    if layers is not None:
        assert cfg.num_layers == (4 if level < 4 else 3)
    out = eng.generate(toks, num_steps=STEPS)
    st = eng.last_stats
    assert out.shape == (2, STEPS) and st["finite"] is True
    assert len(st["step_ms"]) == STEPS and all(t >= 0 for t in st["step_ms"])
    assert sum(st["step_ms"]) == pytest.approx(st["decode_ms_per_step"] * STEPS, rel=1e-12)
    assert st["prefill_ms"] > 0
    assert st["prefill_host_ms"] >= 0 and st["decode_host_ms"] >= 0
    assert st["syncs"] == _want_syncs(cfg, STEPS)
    # a second batch counts its own syncs only
    eng.generate(toks, num_steps=1)
    assert eng.last_stats["syncs"] == _want_syncs(cfg, 1)
    assert len(eng.last_stats["step_ms"]) == 1


def test_last_stats_keys_leave_the_harness_keys_free():
    _, eng, toks = _engine("phi4-mini-3.8b", None, 0)
    eng.generate(toks, num_steps=1)
    assert set(eng.last_stats) == {"prefill_ms", "decode_ms_per_step", "finite", "step_ms",
                                   "prefill_host_ms", "decode_host_ms", "syncs"}
    harness_keys = {"rid", "level", "n", "plen", "out", "host_s", "prompts", "served",
                    "in_span"}
    assert not set(eng.last_stats) & harness_keys


def _range_counts(prof) -> dict:
    out = {}
    for e in prof.events():
        out[e.name] = out.get(e.name, 0) + 1
    return out


@pytest.mark.parametrize("arch,layers,level", CASES)
def test_profiler_sees_the_engine_and_moe_ranges(arch, layers, level):
    cfg, eng, toks = _engine(arch, layers, level)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate(toks, num_steps=STEPS)
    got = _range_counts(prof)
    want = {"engine.upload": 1, "engine.prefill": 1, "engine.pad_caches": 1,
            "engine.decode_step": STEPS, "engine.collect": 2,
            "moe.dispatch": _moe_layers(cfg) * (1 + STEPS)}
    assert {k: got.get(k, 0) for k in want} == want
    assert eng.last_stats["syncs"] == _want_syncs(cfg, STEPS)


def test_profiler_sees_one_gateway_range_a_request():
    gn = build_gateway(get_smoke_config("phi4-mini-3.8b"))
    reqs = demo_requests(gn, 5, seed=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for r in reqs:
            gn.handle(Event(kind="workload", request=r))
    assert _range_counts(prof).get("gateway.handle", 0) == len(reqs)
    assert len(gn.dispatches) == len(reqs)


def _train_once(cfg):
    tcfg = ts.TrainConfig(remat=False)
    state = ts.init_train_state(cfg, tcfg, 0, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(5))
    return ts.train_step(cfg, tcfg, state, {"tokens": tokens})


def test_profiler_sees_the_trainers_update_range():
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train_once(cfg)
    got = _range_counts(prof)
    assert got.get("train.apply_updates", 0) == 1
    assert got.get("moe.dispatch", 0) == cfg.num_layers


def test_no_record_function_opens_without_a_profiler(monkeypatch):
    """Serving (dense and MoE), the gateway and a train step with no
    profiler running open no ``record_function`` in the port."""
    opened = []
    real = torch.profiler.record_function

    class Counting(real):
        def __init__(self, name, *a, **kw):
            opened.append(name)
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    for arch, layers, level in CASES:
        _, eng, toks = _engine(arch, layers, level)
        eng.generate(toks, num_steps=STEPS)
    gn = build_gateway(get_smoke_config("phi4-mini-3.8b"))
    for r in demo_requests(gn, 3, seed=2):
        gn.handle(Event(kind="workload", request=r))
    _train_once(get_smoke_config("mixtral-8x7b").scaled(dtype="float32"))
    assert opened == []
    # the counting class does count once a profiler records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert opened == ["probe"]


def test_every_range_of_the_port_goes_through_span():
    users = sorted(str(p.relative_to(SRC)) for p in SRC.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["core/trace.py"]
