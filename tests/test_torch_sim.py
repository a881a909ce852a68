"""The port's online simulator against the JAX package's.

The simulator stack (``repro_torch.sim``, ``repro_torch.control``, the
sharded control plane) is pure host code. Under the JAX package's per-chip
peaks it must reproduce the committed golden digests and the golden sweep
CSV byte for byte, and on sharded, tenant, batching and trace-replay runs
every record and log line must equal the JAX package's on the same inputs.
"""
import contextlib
import dataclasses
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.launch import sim as launch_sim

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _golden_digest  # noqa: E402
from _golden_digest import describe_mismatch, report_digest  # noqa: E402
from _torch_host_util import REF_HW, canon  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _port_report(scenario, policy, control):
    """``_golden_digest.run_report``'s run, through the port's entry point."""
    sim, _ = launch_sim.build_sim(
        scenario, policy, control, seed=_golden_digest.SEED,
        horizon_s=_golden_digest.HORIZON_S,
        num_standby=_golden_digest.NUM_STANDBY, hw=REF_HW)
    return sim.run()


# ---- the golden pins ---------------------------------------------------
@pytest.mark.parametrize("case", _golden_digest.DIGEST_CASES,
                         ids=lambda c: f"{c[0]}/{c[2]}")
def test_golden_digest(case):
    with open(os.path.join(GOLDEN_DIR, "sim_digest.json")) as f:
        entry = json.load(f)["/".join(case)]
    want = entry["combined"] if isinstance(entry, dict) else entry
    report = _port_report(*case)
    if report_digest(report) != want:
        pytest.fail(describe_mismatch(report, entry))


@pytest.mark.parametrize("case", [("node-churn", "proportional", "full"),
                                  ("overload", "proportional", "none")])
def test_chip_smoke_digest_is_the_golden_digest(case):
    """``chip_smoke.py``'s sim phase hashes a run as the golden digest does."""
    chip_smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                                run_name="chip_smoke")
    report = _port_report(*case)
    assert chip_smoke["sim_digest"](report) == report_digest(report)


def test_golden_csv_all_scenarios(capsys):
    """``python -m repro_torch.launch.sim --scenario all --horizon 6``
    prints the committed sweep CSV (6 scenarios x 5 policies x none,full)."""
    assert launch_sim.main(["--scenario", "all", "--horizon", "6"],
                           hw=REF_HW) == 0
    with open(os.path.join(GOLDEN_DIR, "run_sim_all_h6.csv")) as f:
        assert capsys.readouterr().out == f.read()


# ---- record-by-record parity with the JAX package -----------------------
def _assert_reports_equal(got, want):
    assert len(got.records) == len(want.records)
    for i, (a, b) in enumerate(zip(got.records, want.records)):
        assert canon(a) == canon(b), f"record {i} differs"
    assert got.log == want.log
    skip = ("wall_s", "n_events", "plan_cache_hits", "plan_cache_misses")
    assert ({k: repr(v) for k, v in got.summary().items() if k not in skip}
            == {k: repr(v) for k, v in want.summary().items()
                if k not in skip})
    assert canon(got.tenant_summary()) == canon(want.tenant_summary())
    assert canon(got.scaling) == canon(want.scaling)
    assert dict(got.admission_counts) == dict(want.admission_counts)
    assert repr(got.end_s) == repr(want.end_s)
    assert got.n_events == want.n_events


def _reference_sim(scenario, policy, control, *, seed, horizon_s,
                   num_standby=2, max_batch=1, seq_len=512, cells=0,
                   admission_rate=0.0,
                   cell_strategy="stripe", router="least-backlog",
                   rebalance_s=0.0, fair=False, tenant_batch_cap=0):
    """The JAX package's stack, configured exactly as the simulator's run
    path configures it (``benchmarks/run_sim.py``'s ``run_one``)."""
    from repro.configs import get_config as r_get_config
    from repro.control import (AdmissionController as RAdmission,
                               Autoscaler as RAutoscaler,
                               FairShareScheduler as RFairShare)
    from repro.core.cluster import (SimBackend as RSimBackend,
                                    cluster_nodes as r_cluster_nodes,
                                    synthetic_fleet as r_synthetic_fleet)
    from repro.core.profiling import ProfilingTable as RTable
    from repro.core.resource_manager import GatewayNode as RGatewayNode
    from repro.core.variants import VariantPool as RPool
    from repro.sim import (FLEET_SIZES, OnlineSimulator as ROnline,
                           ShardedSimulator as RSharded,
                           build_scenario as r_build_scenario)

    pool = RPool(r_get_config(launch_sim.ARCH))

    def profiles():
        if scenario in FLEET_SIZES:
            return r_synthetic_fleet(FLEET_SIZES[scenario], seed=seed,
                                     num_standby=num_standby)
        return r_cluster_nodes(num_standby)

    table = RTable(pool, profiles(), seq_len=seq_len)
    sc = r_build_scenario(scenario, table, seed=seed, horizon_s=horizon_s)
    fs_weights = tenant_rates = None
    if fair:
        fs_weights = {t.name: t.fair_share for t in sc.tenants}
        tenant_rates = {t.name: t.rate_limit for t in sc.tenants
                        if t.rate_limit is not None} or None
    gated = control in ("admission", "full")
    if cells > 0:
        return RSharded(
            lambda ps: RTable(pool, ps, seq_len=seq_len), profiles(),
            sc.arrivals, sc.faults, cells=cells, strategy=cell_strategy,
            router=router, policy=policy, seed=seed, noise_std=0.0,
            scenario=sc.name, horizon_s=sc.horizon_s, admission=gated,
            admission_rate=admission_rate or None,
            admission_tenant_rates=tenant_rates if gated else None,
            autoscale=control in ("autoscale", "full") and num_standby > 0,
            max_batch=max_batch, formation_window_s=0.0, fairshare=fair,
            fairshare_weights=fs_weights, rebalance_s=rebalance_s)
    gn = RGatewayNode(table, RSimBackend(table, noise_std=0.0, seed=seed),
                      policy=policy, max_batch=max_batch)
    admission = (RAdmission(table, rate=admission_rate or None,
                            tenant_rates=tenant_rates)
                 if gated else None)
    autoscaler = None
    if control in ("autoscale", "full") and num_standby > 0:
        autoscaler = RAutoscaler(
            table, [n.name for n in table.nodes if not n.available])
    fairshare = (RFairShare(fs_weights, max_outstanding_items=
                            launch_sim.FAIR_OUTSTANDING_ITEMS)
                 if fair else None)
    return ROnline(gn, sc.arrivals, sc.faults, scenario=sc.name,
                   horizon_s=sc.horizon_s, admission=admission,
                   autoscaler=autoscaler, fairshare=fairshare,
                   tenant_batch_cap=tenant_batch_cap)


PARITY_CASES = {
    "fleet-64/cells1/full": dict(scenario="fleet-64", control="full",
                                 horizon_s=6.0, cells=1),
    "fleet-64/cells4/none": dict(scenario="fleet-64", control="none",
                                 horizon_s=6.0, cells=4),
    "fleet-64/cells4/autoscale/by-class/rendezvous": dict(
        scenario="fleet-64", control="autoscale", horizon_s=6.0, cells=4,
        num_standby=4, cell_strategy="by-class", router="rendezvous",
        rebalance_s=0.5),
    "noisy-neighbor/fair/cap4": dict(
        scenario="noisy-neighbor", control="full", horizon_s=6.0,
        fair=True, max_batch=8, tenant_batch_cap=4),
    "overload/batch32/seq8": dict(scenario="overload", control="full",
                                  horizon_s=6.0, max_batch=32, seq_len=8),
    # fleet-1024 sizes its requests for 64-node cells, so every cell's
    # gate admits and serves within deadline: the per-cell split of the
    # fleet-wide rate (and of each tenant's rate, below) decides admits
    "fleet-1024/cells16/full/rate2000": dict(
        scenario="fleet-1024", control="full", horizon_s=0.1, cells=16,
        admission_rate=2000.0),
    "noisy-neighbor/cells4/fair": dict(
        scenario="noisy-neighbor", control="full", horizon_s=6.0, cells=4,
        fair=True),
}


@pytest.mark.parametrize("name", sorted(PARITY_CASES))
def test_records_match_jax_package(name):
    kw = dict(PARITY_CASES[name])
    scenario, control = kw.pop("scenario"), kw.pop("control")
    sim, _ = launch_sim.build_sim(scenario, "proportional", control, seed=0,
                                  hw=REF_HW, **kw)
    got = sim.run()
    want = _reference_sim(scenario, "proportional", control, seed=0,
                          **kw).run()
    assert got.records and any(r.done for r in got.records)
    if kw.get("cells", 0) > 1 and control == "full":
        assert any(r.meets_deadline for r in got.records)
        assert any(r.rejected for r in got.records)
    _assert_reports_equal(got, want)


def test_cells1_equals_unsharded():
    """``cells=1`` runs the unsharded gateway byte for byte."""
    runs = [launch_sim.build_sim("fleet-64", "proportional", "full", seed=0,
                                 horizon_s=6.0, cells=c, hw=REF_HW)[0].run()
            for c in (0, 1)]
    _assert_reports_equal(*runs)


def _write_trace(path, n=80, seed=3):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.025, n))
    rows = ["arrival_s,num_items,seq_len,slo_class,perf_req,acc_req,"
            "deadline_s,rid"]
    for i in range(n):
        items = int(rng.integers(20, 600))
        perf = float(rng.uniform(1500.0, 12000.0))
        slo = "strict" if rng.random() < 0.3 else "degradable"
        deadline = "" if rng.random() < 0.5 else f"{rng.uniform(0.05, 0.8)!r}"
        rows.append(f"{float(t[i])!r},{items},512,{slo},{perf!r},"
                    f"{float(rng.uniform(85.0, 95.0))!r},{deadline},{i}")
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("max_batch", [1, 8])
def test_trace_replay_matches_jax_package(tmp_path, max_batch):
    path = tmp_path / "serving_log.csv"
    _write_trace(path)
    name = f"trace:{path}"
    sim, sc = launch_sim.build_sim(name, "proportional", "full", seed=0,
                                   horizon_s=0.0, max_batch=max_batch,
                                   hw=REF_HW)
    got = sim.run()
    assert len(got.records) == 80 and sc.name == name
    assert any(r.done for r in got.records)
    want = _reference_sim(name, "proportional", "full", seed=0,
                          horizon_s=0.0, max_batch=max_batch).run()
    _assert_reports_equal(got, want)


def test_cli_trace_and_json(tmp_path, capsys):
    """The CLI's trace replay and ``--json`` rows agree with ``run_one``."""
    path = tmp_path / "serving_log.csv"
    _write_trace(path, n=30)
    out_json = tmp_path / "rows.json"
    assert launch_sim.main(["--scenario", f"trace:{path}", "--policies",
                            "proportional", "--control", "full",
                            "--max-batch", "1,8", "--json", str(out_json)],
                           hw=REF_HW) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].endswith(",max_batch") and len(lines) == 3
    rows = json.loads(out_json.read_text())["rows"]
    assert [r["max_batch"] for r in rows] == [1, 8]
    assert all(r["offered"] == 30.0 for r in rows)


# ---- the event queue against its retained tuple-heap twin --------------
_OPS = st.lists(st.one_of(
    st.tuples(st.just("push"), st.integers(0, 11)),
    st.tuples(st.just("chunk"), st.lists(st.integers(0, 11), min_size=1,
                                         max_size=6)),
    st.tuples(st.just("pop"), st.just(0))), max_size=120)


@settings(max_examples=60, deadline=None)
@given(_OPS)
def test_event_queue_matches_reference(ops):
    """The slab queue, the port's retained heap twin and the JAX package's
    slab queue pop the same (time, seq, kind, payload) stream."""
    from repro.sim.events import SeqCounter as RSeq, SlabEventQueue as RSlab
    from repro_torch.sim import events, events_reference
    queues = [events.SlabEventQueue(events.SeqCounter()),
              events_reference.EventQueue(events.SeqCounter()),
              RSlab(RSeq())]
    streams = [[] for _ in queues]
    chunk_seq = 1_000_000
    for i, (op, arg) in enumerate(ops):
        if op == "push":
            for q in queues:
                q.push(arg / 4.0, f"k{i}", i=i)
        elif op == "chunk":
            items = [(t / 4.0, chunk_seq + j, f"c{i}", {"i": i})
                     for j, t in enumerate(arg)]
            chunk_seq += len(arg)
            for q in queues:
                q.push_chunk(list(items))
        else:
            for q, out in zip(queues, streams):
                out.append(q.pop_parts() if q else None)
    assert len({len(q) for q in queues}) == 1
    for q, out in zip(queues, streams):
        while q:
            out.append(q.pop_parts())
    assert streams[0] == streams[1] == streams[2]


# ---- the retained twins: each fast path against the path it replaced ----
def _twin_fleet(seed):
    from repro_torch.core.cluster import synthetic_fleet
    return synthetic_fleet(16, seed=seed % 97, num_standby=2)


def _twin_table(profiles):
    from repro_torch.configs import get_config
    from repro_torch.core.profiling import ProfilingTable
    from repro_torch.core.variants import VariantPool
    return ProfilingTable(VariantPool(get_config(launch_sim.ARCH)),
                          profiles, seq_len=512)


def _twin_stream(sim, rep):
    """Everything the event loop can influence: the digest-hashed record
    fields, the full log, the event count and the routing decisions. The
    plan-cache counters are left out: the reference stack plans cold."""
    records = [(rec.request.rid, rec.arrival_s, rec.dispatch_s,
                rec.finish_s, rec.done, rec.rejected, rec.redistributed,
                rec.result.per_node_time if rec.done else None)
               for rec in rep.records]
    return (records, rep.log, rep.n_events, rep.end_s,
            sorted(sim.routed_cell.items()), sim.rebalances)


def _twin_runs(seed, scenario, cells, variants, **kw):
    """One ShardedSimulator per ``variants`` entry, each a (constructor
    kwargs, runner name) pair, over the same 16-node fleet and traffic."""
    from repro_torch.sim import ShardedSimulator, build_scenario
    profiles = _twin_fleet(seed)
    sc = build_scenario(scenario, _twin_table(
        [dataclasses.replace(p) for p in profiles]), seed=seed,
        horizon_s=0.8)
    out = []
    for extra, runner in variants:
        sim = ShardedSimulator(
            _twin_table, [dataclasses.replace(p) for p in profiles],
            sc.arrivals, sc.faults, cells=cells, scenario=sc.name,
            horizon_s=sc.horizon_s, seed=0, autoscale=True, **kw, **extra)
        out.append(_twin_stream(sim, getattr(sim, runner)()))
    return out


@pytest.mark.parametrize("cells", [1, 4, 16])
@pytest.mark.parametrize("seed,scenario,max_batch,fair,gated", [
    (11, "node-churn", 1, False, False),
    (3, "node-churn", 32, False, True),
    (7, "straggler-storm", 1, False, True),
    (88, "straggler-storm", 32, True, False),
    (5, "tenant-skew", 32, True, True),
    (1234, "noisy-neighbor", 1, True, False),
])
def test_fused_stack_matches_reference_stack(seed, scenario, max_batch,
                                             fair, gated, cells):
    """The slab queue + fused dispatch + plan-reuse stack produces the
    event stream of ``reference_stack=True`` (tuple-heap queue, the
    pre-fusion ``_handle_reference`` chain, cold planning) exactly."""
    fast, ref = _twin_runs(
        seed, scenario, cells,
        [({}, "run"), ({"reference_stack": True}, "run")],
        admission=gated, max_batch=max_batch, fairshare=fair,
        rebalance_s=0.25)
    assert fast[0] and fast == ref


@pytest.mark.parametrize("cells", [1, 4, 16])
@pytest.mark.parametrize("seed,scenario,rebalance,gated", [
    (11, "node-churn", False, False),
    (3, "node-churn", True, True),
    (7, "straggler-storm", False, True),
    (88, "straggler-storm", True, True),
])
def test_run_draining_matches_per_event_reference(seed, scenario,
                                                  rebalance, gated, cells):
    """``ShardedSimulator.run``'s batched run-draining merge pops the
    events of the per-event ``run_reference`` merge, in the same order."""
    fast, ref = _twin_runs(seed, scenario, cells,
                           [({}, "run"), ({}, "run_reference")],
                           admission=gated,
                           rebalance_s=0.25 if rebalance else 0.0)
    assert fast[0] and fast == ref


@pytest.mark.parametrize("scenario,max_batch,noise", [
    ("steady", 1, 0.05), ("straggler-storm", 1, 0.05),
    ("node-churn", 1, 0.0), ("node-churn", 32, 0.0)])
def test_fast_control_plane_matches_legacy(scenario, max_batch, noise):
    """The incremental snapshot/backlog path and the fast planners give
    the serving metrics of ``legacy_control_plane=True`` (a ClusterState
    copied per event, per-share backlog recompute, ``reference:``
    planning), under noise, straggler decay, batching and admission."""
    from repro_torch.control import AdmissionController
    from repro_torch.core.cluster import SimBackend, cluster_nodes
    from repro_torch.core.resource_manager import GatewayNode
    from repro_torch.sim import OnlineSimulator, build_scenario

    def run(legacy):
        table = _twin_table(cluster_nodes(0))
        sc = build_scenario(scenario, table, seed=3, horizon_s=4.0)
        policy = "reference:proportional" if legacy else "proportional"
        gn = GatewayNode(table, SimBackend(table, noise_std=noise, seed=3),
                         policy=policy, max_batch=max_batch,
                         snapshot_caching=not legacy)
        return OnlineSimulator(gn, sc.arrivals, sc.faults,
                               scenario=sc.name, horizon_s=sc.horizon_s,
                               admission=AdmissionController(table),
                               legacy_control_plane=legacy).run()

    fast, legacy = run(False), run(True)
    sf, sl = fast.summary(), legacy.summary()
    assert sf.keys() == sl.keys()
    for k in sf:
        if k.startswith("plan_cache") or k == "wall_s":
            continue            # the reference planner plans cold
        assert sf[k] == pytest.approx(sl[k], abs=1e-9), k
    assert len(fast.log) == len(legacy.log)
    assert fast.n_events == legacy.n_events > 0


# ---- the example --------------------------------------------------------
def test_online_sim_example_runs():
    path = os.path.join(ROOT, "examples", "online_sim_torch.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="online_sim_torch")["main"]()
    out = buf.getvalue()
    assert "policy=proportional scenario=node-churn" in out
    assert "admission+autoscaling" in out and "re-DISTRIBUTE" in out

