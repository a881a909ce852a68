"""Port gateway on the CPU: the framework-free control plane (configs,
variant ladder, profiling table, planners, gateway FSM) against the JAX
package's, and the serve launcher end to end.

The planners are held against the JAX package's retained reference
implementations (``reference:<name>``): assignments and levels exactly,
predicted floats to 1e-9 relative (the fast and the reference planners sum
in another order, so the last bits may differ)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.profiling as jprof
import repro.sched as jsched
from repro.core.requests import InferenceRequest as JaxRequest
from repro.core.variants import VariantPool as JaxVariantPool
from repro.roofline.analysis import HBM_BW, PEAK_FLOPS
from _torch_util import jax_asdict, jax_form
from repro_torch import configs
from repro_torch.core import profiling as prof
from repro_torch.core.cluster import DEFAULT_NODES
from repro_torch.core.requests import InferenceRequest
from repro_torch.core.resource_manager import Event
from repro_torch.core.variants import VariantPool
from repro_torch.launch import serve
from repro_torch.sched import (ClusterState, get_policy, registered_policies,
                               resolve_policy)

ARCH = "phi4-mini-3.8b"
REFERENCE_HW = prof.HardwareSpec(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW)


@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_configs_equal(arch, kind):
    get, jget = ((configs.get_config, jconfigs.get_config) if kind == "full"
                 else (configs.get_smoke_config, jconfigs.get_smoke_config))
    a, b = jax_form(get(arch)), jget(arch)
    assert jax_asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert a.param_count(active_only=True) == b.param_count(active_only=True)


def test_registry_and_shapes_equal():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs.cells() == jconfigs.cells()
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-2b", "mixtral-8x7b",
                                  "deepseek-v3-671b", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b"])
def test_variant_ladder_equal(arch):
    a = VariantPool(jax_form(configs.get_config(arch)))
    b = JaxVariantPool(jconfigs.get_config(arch))
    assert len(a) == len(b) == 6
    for va, vb in zip(a.variants, b.variants):
        assert jax_asdict(va.config) == dataclasses.asdict(vb.config)
        assert (va.level, va.alpha, va.accuracy, va.rel_active_params) == (
            vb.level, vb.alpha, vb.accuracy, vb.rel_active_params)


def test_rwkv6_ladder_and_table():
    """rwkv6: channel-mix width 7168 down to 2560 at alpha 0.35, 18 of 24
    layers at levels 4-5, and finite analytic rates without an attention
    layer, equal to the JAX package's under its constants."""
    cfg = configs.get_config("rwkv6-1.6b")
    pool = VariantPool(cfg)
    assert [v.config.d_ff for v in pool.variants] == [7168, 6144, 4992, 3968, 3200, 2560]
    assert [v.config.num_layers for v in pool.variants] == [24] * 4 + [18] * 2
    nodes = [prof.NodeProfile(n.name, n.chips, n.capability) for n in DEFAULT_NODES]
    t = prof.ProfilingTable(pool, nodes, seq_len=512)
    assert np.isfinite(t.perf).all() and (t.perf > 0).all()
    jnodes = [jprof.NodeProfile(n.name, n.chips, n.capability) for n in DEFAULT_NODES]
    jt = jprof.ProfilingTable(JaxVariantPool(jconfigs.get_config("rwkv6-1.6b")),
                              jnodes, seq_len=512)
    ref_t = prof.ProfilingTable(VariantPool(jax_form(cfg)), nodes, seq_len=512,
                                hw=REFERENCE_HW)
    np.testing.assert_array_equal(ref_t.perf, jt.perf)


def _tables(seq_len=512, hw=REFERENCE_HW):
    nodes = [prof.NodeProfile(n.name, n.chips, n.capability) for n in DEFAULT_NODES]
    jnodes = [jprof.NodeProfile(n.name, n.chips, n.capability) for n in DEFAULT_NODES]
    t = prof.ProfilingTable(VariantPool(configs.get_config(ARCH)), nodes,
                            seq_len=seq_len, hw=hw)
    jt = jprof.ProfilingTable(JaxVariantPool(jconfigs.get_config(ARCH)), jnodes,
                              seq_len=seq_len)
    return t, jt


@pytest.mark.parametrize("seq_len", [128, 512])
def test_profiling_table_equal_under_reference_constants(seq_len):
    """The port holds no constant of the reference's target: they come in
    here, at test time, and then the table is bit-identical."""
    t, jt = _tables(seq_len)
    np.testing.assert_array_equal(t.perf, jt.perf)
    np.testing.assert_array_equal(t.perf_b, jt.perf_b)
    np.testing.assert_array_equal(t.accuracies, jt.accuracies)
    assert t.batch_grid == jt.batch_grid
    for b in (1, 3, 8, 24, 64):
        np.testing.assert_array_equal(t.perf_at_batch(b), jt.perf_at_batch(b))
    cfg = configs.get_config(ARCH)
    assert prof.variant_item_cost(cfg, seq_len, 4) == jprof.variant_item_cost(
        jconfigs.get_config(ARCH), seq_len, 4)
    assert prof.analytic_throughput(cfg, seq_len, 64, 0.9, hw=REFERENCE_HW) == \
        jprof.analytic_throughput(jconfigs.get_config(ARCH), seq_len, 64, 0.9)


def test_profiling_default_is_the_h100():
    assert prof.H100_SXM == prof.HardwareSpec(989e12, 3.35e12)
    cfg = configs.get_config(ARCH)
    cost = prof.variant_item_cost(cfg, 512)
    want = 1.0 / max(cost["flops"] / 989e12, cost["bytes"] / 3.35e12)
    assert prof.analytic_throughput(cfg, 512, 1, 1.0) == pytest.approx(want, rel=1e-12)
    t = prof.ProfilingTable(VariantPool(cfg), [prof.NodeProfile("n", 2, 0.5)], 512)
    assert t.hw is prof.H100_SXM
    assert t.perf[0, 0] == pytest.approx(want, rel=1e-12)
    t_ref, _ = _tables()
    assert not np.allclose(t_ref.perf[:, :1], t.perf)


def _measured(pool_cls, profile_cls, table_cls, cfg, caps, avail):
    pool = pool_cls(cfg)
    caps = np.asarray(caps, dtype=np.float64)
    speed = np.linspace(1.0, 2.1, len(pool))[:, None]
    nodes = [profile_cls(f"n{i}", chips=1, available=avail[i])
             for i in range(len(caps))]
    return table_cls(pool, nodes, measured=caps[None, :] * speed)


def _plan_grid():
    """Seeded random cluster states and requests, built on both sides."""
    rng = np.random.default_rng(2025)
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    for trial in range(40):
        n = int(rng.integers(1, 7))
        caps = rng.uniform(10.0, 120.0, n)
        avail = [True] * n
        if n > 1 and rng.random() < 0.3:
            avail[int(rng.integers(n))] = False
        backlogs = {f"n{i}": float(rng.uniform(0.0, 0.5))
                    for i in range(n) if rng.random() < 0.5}
        now = float(rng.uniform(0.0, 10.0))
        t = _measured(VariantPool, prof.NodeProfile, prof.ProfilingTable, cfg,
                      caps, avail)
        jt = _measured(JaxVariantPool, jprof.NodeProfile, jprof.ProfilingTable,
                       jcfg, caps, avail)
        lo, hi = t.perf[0].sum(), t.perf[-1].sum()
        kw = dict(rid=trial, num_items=int(rng.choice([1, 13, 260, 520, 650])),
                  perf_req=float(lo + rng.uniform(0.0, 1.0) * (hi - lo)),
                  acc_req=float(rng.uniform(85.0, 91.0)))
        yield (ClusterState.from_table(t, now=now, backlogs=backlogs),
               InferenceRequest(**kw),
               jsched.ClusterState.from_table(jt, now=now, backlogs=backlogs),
               JaxRequest(**kw))


def _same_plan(a, b):
    assert [dataclasses.astuple(x) for x in a.dispatch.assignments] == \
        [dataclasses.astuple(x) for x in b.dispatch.assignments]
    assert a.policy == b.policy and a.feasible == b.feasible
    for f in ("makespan_s", "exec_makespan_s", "finish_s", "predicted_acc",
              "alloc_perf"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-9, abs=1e-12), f
    assert dict(a.node_service_s) == pytest.approx(dict(b.node_service_s), rel=1e-9)
    assert dict(a.node_finish_s) == pytest.approx(dict(b.node_finish_s), rel=1e-9)


def test_policy_registry_equal():
    assert registered_policies() == jsched.registered_policies()


@pytest.mark.parametrize("name", ["uniform", "uniform_apx", "asymmetric",
                                  "proportional", "exact_oracle", "accuracy_edf"])
def test_plans_equal_reference(name):
    """The port's planner and its own ``reference:`` twin both against the JAX
    package's reference implementation."""
    checked = 0
    has_reference = name != "accuracy_edf"     # it has no retained twin
    for state, req, jstate, jreq in _plan_grid():
        if has_reference:
            want = jsched.resolve_policy(f"reference:{name}").plan(jstate, jreq)
            _same_plan(resolve_policy(f"reference:{name}").plan(state, req), want)
        else:
            want = jsched.get_policy(name).plan(jstate, jreq)
        _same_plan(get_policy(name).plan(state, req), want)
        checked += 1
    assert checked == 40


def test_gateway_trace_and_disconnect():
    gn = serve.build_gateway(configs.get_config(ARCH), policy="proportional")
    reqs = serve.demo_requests(gn, 4, seed=3)
    assert [s.value for s in gn.log] == ["profile", "netcom"]
    res = gn.handle(Event(kind="workload", request=reqs[0]))
    assert res.achieved_perf > 0 and gn.dispatches[-1].total_items == reqs[0].num_items
    gn.handle(Event(kind="disconnect", node="slice-b"))
    gn.handle(Event(kind="workload", request=reqs[1]))
    assert all(a.node != "slice-b" for a in gn.dispatches[-1].assignments)
    gn.handle(Event(kind="reconnect", node="slice-b"))
    gn.handle(Event(kind="workload", request=reqs[2]))
    assert any(a.node == "slice-b" for a in gn.dispatches[-1].assignments)
    assert set(gn.summary()) >= {"perf_violation_rate", "mean_acc"}


def test_gateway_matches_jax_gateway_under_reference_constants():
    """Same trace through both gateways: same dispatches, same results."""
    from repro.core.cluster import SimBackend as JaxSimBackend
    from repro.core.resource_manager import Event as JaxEvent
    from repro.core.resource_manager import GatewayNode as JaxGatewayNode
    from repro.launch.serve import demo_requests as jax_demo_requests
    gn = serve.build_gateway(configs.get_config(ARCH), policy="proportional",
                             hw=REFERENCE_HW)
    _, jt = _tables()
    jgn = JaxGatewayNode(jt, JaxSimBackend(jt), policy="proportional")
    jgn.startup()
    reqs, jreqs = serve.demo_requests(gn, 5, seed=1), jax_demo_requests(jgn, 5, seed=1)
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)
        if i == 2:
            gn.handle(Event(kind="disconnect", node="slice-b"))
            jgn.handle(JaxEvent(kind="disconnect", node="slice-b"))
        res, jres = gn.handle(Event(kind="workload", request=r)), \
            jgn.handle(JaxEvent(kind="workload", request=jr))
        assert [dataclasses.astuple(a) for a in gn.dispatches[-1].assignments] == \
            [dataclasses.astuple(a) for a in jgn.dispatches[-1].assignments]
        assert res.achieved_perf == pytest.approx(jres.achieved_perf, rel=1e-12)
        assert res.achieved_acc == pytest.approx(jres.achieved_acc, rel=1e-12)


@pytest.mark.parametrize("policy", ["proportional", "uniform_apx"])
def test_serve_main_smoke_cpu(policy, capsys):
    report = serve.main(["--smoke", "--device", "cpu", "--dtype", "float32",
                         "--requests", "3", "--disconnect", "--policy", policy,
                         "--prompt-len", "12", "--decode-steps", "3",
                         "--max-len", "24", "--batch", "2"])
    out = capsys.readouterr().out
    assert "disconnected" in out and "summary:" in out
    assert len(report["results"]) == 3 and report["disconnected"] == ["slice-b"]
    assert report["runs"]
    smoke = configs.get_smoke_config(ARCH)
    for r in report["runs"]:
        assert r["tokens"].shape == (2, 3) and r["finite"]
        assert 0 <= r["tokens"].min() and r["tokens"].max() < smoke.vocab_size
        assert r["node"] != "slice-b" or r["rid"] < 1
    # one engine per accuracy level, shared by the nodes that run it
    assert set(report["engines"]) == {r["level"] for r in report["runs"]}
    pool = VariantPool(smoke)
    for lvl, eng in report["engines"].items():
        assert eng.cfg.d_ff == pool[lvl].config.d_ff
        assert eng.cfg.num_layers == pool[lvl].config.num_layers
        assert eng.ecfg.use_kernels and eng.device.type == "cpu"


def test_serve_main_smoke_cpu_rwkv6(capsys):
    report = serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                         "--dtype", "float32", "--requests", "3", "--disconnect",
                         "--prompt-len", "12", "--decode-steps", "3",
                         "--max-len", "24", "--batch", "2"])
    assert "arch=rwkv6-1.6b" in capsys.readouterr().out
    assert report["runs"] and report["disconnected"] == ["slice-b"]
    smoke = configs.get_smoke_config("rwkv6-1.6b")
    for r in report["runs"]:
        assert r["tokens"].shape == (2, 3) and r["finite"]
        assert 0 <= r["tokens"].min() and r["tokens"].max() < smoke.vocab_size
    for eng in report["engines"].values():
        assert eng.cfg.attention_kind == "none" and eng.ecfg.use_kernels


def test_engine_pool_is_lazy_and_seeded():
    pool = serve.EnginePool(configs.get_smoke_config(ARCH), device="cpu",
                            dtype="float32", max_len=32, seed=4)
    assert pool.engines == {}
    e2 = pool.engine_for(2)
    assert pool.engine_for(2) is e2 and set(pool.engines) == {2}
    other = serve.EnginePool(configs.get_smoke_config(ARCH), device="cpu",
                             dtype="float32", max_len=32, seed=4).engine_for(2)
    assert torch.equal(e2.params["final_norm"], other.params["final_norm"])
    assert torch.equal(e2.params["embed"]["embedding"],
                       other.params["embed"]["embedding"])
    toks = serve.make_prompts(256, 3, 5, seed=1, device="cpu")
    assert toks.shape == (3, 5) and toks.dtype == torch.long


def test_engine_pool_bound_evicts_least_recently_used():
    """With ``max_engines=2`` a third level drops the least recently used
    engine; a dropped level is rebuilt from its seed, bit for bit."""
    pool = serve.EnginePool(configs.get_smoke_config("jamba-1.5-large-398b"),
                            device="cpu", dtype="float32", max_len=32, seed=7,
                            max_engines=2)
    e0 = pool.engine_for(0)
    first = {k: v.clone() for k, v in e0.params["layers"]["sub0"]["mamba"].items()}
    pool.engine_for(3)
    assert pool.engine_for(0) is e0            # a hit refreshes level 0
    pool.engine_for(5)                         # evicts level 3, not level 0
    assert list(pool.engines) == [0, 5] and pool.builds == 3
    pool.engine_for(1)                         # evicts level 0
    assert list(pool.engines) == [5, 1]
    del e0
    again = pool.engine_for(0)
    assert list(pool.engines) == [1, 0] and pool.builds == 5
    for k, v in again.params["layers"]["sub0"]["mamba"].items():
        assert torch.equal(v, first[k]), k
    assert serve.EnginePool(configs.get_smoke_config(ARCH), device="cpu").max_engines is None
    with pytest.raises(ValueError, match="max_engines"):
        serve.EnginePool(configs.get_smoke_config(ARCH), device="cpu", max_engines=0)


def test_serve_main_smoke_cpu_jamba(capsys):
    report = serve.main(["--arch", "jamba-1.5-large-398b", "--smoke", "--device", "cpu",
                         "--dtype", "float32", "--requests", "3", "--disconnect",
                         "--prompt-len", "12", "--decode-steps", "3",
                         "--max-len", "24", "--batch", "2"])
    assert "arch=jamba-1.5-large-398b" in capsys.readouterr().out
    assert report["runs"] and report["disconnected"] == ["slice-b"]
    smoke = configs.get_smoke_config("jamba-1.5-large-398b")
    for r in report["runs"]:
        assert r["tokens"].shape == (2, 3) and r["finite"]
        assert 0 <= r["tokens"].min() and r["tokens"].max() < smoke.vocab_size
    levels = {r["level"] for r in report["runs"]}
    assert set(report["engines"]) == levels and report["engine_builds"] == len(levels)
    for eng in report["engines"].values():
        assert eng.cfg.ssm.kind == "mamba"
        assert eng.cfg.moe.num_experts == smoke.moe.num_experts


def test_serve_trace_plans_the_config_it_is_given():
    """``cfg=`` replaces the arch's own config: the gateway's table and
    variant ladder, and the engines, are built from it."""
    full = configs.get_config("jamba-1.5-large-398b")
    cut = full.scaled(num_layers=8, moe=dataclasses.replace(full.moe, num_experts=8))
    small = cut.scaled(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=256, moe=dataclasses.replace(
                           cut.moe, d_ff_expert=128),
                       ssm=dataclasses.replace(cut.ssm, d_state=8), dtype="float32")
    report = serve.serve_trace(cfg=small, requests=2, device="cpu", dtype="float32",
                               batch=2, prompt_len=8, decode_steps=2, max_len=16,
                               max_engines=1, verbose=False)
    gn = report["gateway"]
    assert len(report["engines"]) == 1              # bounded: one level resident
    levels = [r["level"] for r in report["runs"]]
    assert report["engine_builds"] == 1 + sum(a != b for a, b in zip(levels, levels[1:]))
    assert gn.table.pool.base is small
    assert gn.table.pool[0].config.moe.num_experts == 8
    want = VariantPool(small)
    np.testing.assert_allclose(gn.table.perf[0], serve.build_gateway(small).table.perf[0])
    ((lvl, eng),) = report["engines"].items()
    assert eng.cfg == want[lvl].config
    other = serve.build_gateway(full)
    assert not np.allclose(other.table.perf[0], gn.table.perf[0])
