"""Online serving simulator: sweep dispatch policy x admission control x
autoscaling across simulator scenarios and report per-configuration
latency / deadline / goodput metrics — the paper's comparisons, under
sustained load with a closed-loop gateway.

Run:
  PYTHONPATH=src python -m repro_torch.launch.sim \
      --scenario steady --policies uniform,proportional
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario overload
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario all \
      --horizon 6 --verbose --json sim_metrics.json
  # continuous batching in the memory-bound short-seq regime
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario overload \
      --max-batch 1,32 --seq-len 8
  # replay a real serving log (CSV/JSONL)
  PYTHONPATH=src python -m repro_torch.launch.sim \
      --scenario trace:serving_log.csv --max-batch 32

Output: one CSV row per (scenario, policy, control) with p50/p99
latency, the deadline-violation rate *for admitted requests*, goodput
(admitted requests that met their deadline, per sim-second), shed rate,
degraded-admission count, scale-up count + latency, and mean accuracy.
``--control`` picks the gateway configurations to sweep:

  none       every request admitted, fixed node set
  admission  token-bucket + SLO-feasibility gate (reject/degrade)
  autoscale  standby-pool scaling only (every request admitted)
  full       admission + autoscaling

``--scenario fleet-64`` / ``fleet-256`` run the large-fleet
control-plane stressors over a ``synthetic_fleet`` table of the
matching size (short per-fleet default horizons; they are excluded from
``all`` because event counts scale with fleet size). ``--cells N``
shards the control plane into N per-cell gateways behind a root router
(``ShardedSimulator``; ``cells=1`` is byte-identical to the unsharded
gateway).

``--json`` additionally dumps every row (plus the admission outcome and
scaling-action detail, per-run wall-clock, simulator events/sec, and —
for tenant scenarios — the per-tenant breakdown) under a versioned
``{"schema_version": ..., "rows": [...]}`` envelope.

Continuous batching: ``--max-batch`` sweeps engine-batch caps (1 =
batching off, the one-share-at-a-time execution model); ``--seq-len``
picks the serving item size (short items are the memory-bound regime
where batching pays) and ``--formation-window`` the partial-batch hold
window. ``--scenario trace:<path>`` replays a CSV/JSONL serving log
instead of a synthetic arrival process.

Multi-tenant fairness: ``--scenario tenants`` expands to the tenant
scenarios (noisy-neighbor / tenant-skew / flash-crowd-tenant; they stay
out of ``all`` because their metrics only mean something next to the
per-tenant breakdown). ``--fairshare`` picks the gateway fairness
bundle — per-tenant admission token buckets (each tenant's
``rate_limit`` from the scenario's TenantSpecs) plus a deficit-round-
robin fair queue in front of the gate (weights from each spec's
``fair_share``):

  auto   on for tenant scenarios, off otherwise (the default)
  on     force the bundle (tenant scenarios only)
  off    tenant-blind gateway
  both   sweep off then on — the fairness A/B (adds a CSV column)

``--tenants`` prints the per-tenant breakdown (offered / admitted /
shed / admitted-violation rate / service ratio / p99) to stderr under
each row.

Service times come from the analytic profiling table over the per-card
peaks ``hw`` (default: the H100 SXM data sheet); the run itself is pure
host code and touches no device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.configs import get_config
from repro_torch.control import (AdmissionController, Autoscaler,
                                 FairShareScheduler)
from repro_torch.core.cluster import (STANDBY_NODES, SimBackend,
                                      cluster_nodes, synthetic_fleet)
from repro_torch.core.profiling import H100_SXM, HardwareSpec, ProfilingTable
from repro_torch.core.resource_manager import GatewayNode
from repro_torch.core.variants import VariantPool
from repro_torch.sched import registered_policies
from repro_torch.sched.policy import REFERENCE_PREFIX
from repro_torch.sim import (FLEET_HORIZONS, FLEET_SCENARIOS, FLEET_SIZES,
                             SCENARIOS, TENANT_SCENARIOS, OnlineSimulator,
                             ShardedSimulator, build_scenario)
from repro_torch.sim.scenarios import TRACE_PREFIX

ARCH = "phi4-mini-3.8b"
CONTROL_MODES = ("none", "admission", "autoscale", "full")
FAIRSHARE_MODES = ("auto", "on", "off", "both")
# version stamp on the --json artifact so downstream diffs can tell a
# shape change from a metric change
SCHEMA_VERSION = 1
# fair-queue outstanding cap for the --fairshare bundle: one max-size
# request (item_choices tops out at 650) of in-flight work per tenant
# beyond its water-filled share. The DRR quantum alone orders release;
# the cap is what keeps a flooding tenant from parking the whole gate
# budget in its own queue between drains.
FAIR_OUTSTANDING_ITEMS = 650
# the classic sweep stays the paper's five policies so the CSV keeps its
# shape; newer registry entries (accuracy_edf, ...) run when named via
# --policies
SWEEP_POLICIES = ("uniform", "uniform_apx", "asymmetric", "proportional",
                  "exact_oracle")


def _fleet_profiles(scenario_name: str, num_standby: int, seed: int):
    """NodeProfile list for a scenario: a synthetic heterogeneous fleet
    of the matching size for fleet scenarios, else the paper's default
    4-board cluster (+ standby slices)."""
    if scenario_name in FLEET_SIZES:
        return synthetic_fleet(FLEET_SIZES[scenario_name], seed=seed,
                               num_standby=num_standby)
    return cluster_nodes(num_standby)


def _fresh_table(scenario_name: str, num_standby: int, seed: int,
                 seq_len: int = 512, *,
                 hw: HardwareSpec = H100_SXM) -> ProfilingTable:
    """Each run gets its own table: the GN mutates it (straggler EWMA,
    availability, re-profiling), so sharing would leak state. Standby
    slices are present-but-unavailable in *every* mode so the seeded
    arrival trace is identical across control configurations. Fleet
    scenarios get a synthetic heterogeneous fleet of the matching size
    instead of the paper's default 4-board cluster."""
    pool = VariantPool(get_config(ARCH))
    nodes = _fleet_profiles(scenario_name, num_standby, seed)
    return ProfilingTable(pool, nodes, seq_len=seq_len, hw=hw)


def build_sim(scenario_name: str, policy: str, control: str, *, seed: int,
              horizon_s: float, noise_std: float = 0.0,
              num_standby: int = 2, admission_rate: float = 0.0,
              max_batch: int = 1, seq_len: int = 512,
              formation_window_s: float = 0.0, cells: int = 0,
              cell_strategy: str = "stripe", router: str = "least-backlog",
              rebalance_s: float = 0.0, fair: bool = False,
              tenant_batch_cap: int = 0, hw: HardwareSpec = H100_SXM):
    """One configured run, not yet started: ``(sim, scenario)``, where
    ``sim`` is an :class:`OnlineSimulator` (``cells == 0``) or a
    :class:`ShardedSimulator` over ``cells`` per-cell gateways. Every
    call builds fresh tables, so two calls with the same arguments run
    the same trace."""
    table = _fresh_table(scenario_name, num_standby, seed, seq_len=seq_len,
                         hw=hw)
    sc = build_scenario(scenario_name, table, seed=seed,
                        horizon_s=horizon_s)
    fs_weights = tenant_rates = None
    if fair:
        assert sc.tenants, (
            f"--fairshare needs a tenant scenario, got {scenario_name!r}")
        # the fairness bundle is declared by the scenario itself: DRR
        # weights from each tenant's fair_share entitlement, per-tenant
        # admission buckets from each tenant's rate_limit (the capacity
        # lever — DRR ordering alone cannot reallocate node backlog)
        fs_weights = {t.name: t.fair_share for t in sc.tenants}
        tenant_rates = {t.name: t.rate_limit for t in sc.tenants
                        if t.rate_limit is not None} or None
    if cells > 0:
        # sharded control plane: per-cell gateway stacks behind a root
        # router. cells=1 is byte-identical to the unsharded path below,
        # so the same trace compares.
        pool = VariantPool(get_config(ARCH))
        profiles = _fleet_profiles(scenario_name, num_standby, seed)
        sim = ShardedSimulator(
            lambda ps: ProfilingTable(pool, ps, seq_len=seq_len, hw=hw),
            profiles, sc.arrivals, sc.faults,
            cells=cells, strategy=cell_strategy, router=router,
            policy=policy, seed=seed, noise_std=noise_std,
            scenario=sc.name, horizon_s=sc.horizon_s,
            admission=control in ("admission", "full"),
            admission_rate=(admission_rate if admission_rate > 0
                            else None),
            admission_tenant_rates=(tenant_rates
                                    if control in ("admission", "full")
                                    else None),
            autoscale=(control in ("autoscale", "full")
                       and num_standby > 0),
            max_batch=max_batch,
            formation_window_s=formation_window_s,
            fairshare=fair, fairshare_weights=fs_weights,
            rebalance_s=rebalance_s)
    else:
        gn = GatewayNode(table, SimBackend(table, noise_std=noise_std,
                                           seed=seed), policy=policy,
                         max_batch=max_batch)
        admission = None
        if control in ("admission", "full"):
            admission = AdmissionController(
                table, rate=admission_rate if admission_rate > 0 else None,
                tenant_rates=tenant_rates)
        autoscaler = None
        if control in ("autoscale", "full") and num_standby > 0:
            standby_names = [n.name for n in table.nodes if not n.available]
            autoscaler = Autoscaler(table, standby_names)
        fairshare = None
        if fair:
            fairshare = FairShareScheduler(
                fs_weights, max_outstanding_items=FAIR_OUTSTANDING_ITEMS)
        sim = OnlineSimulator(gn, sc.arrivals, sc.faults,
                              scenario=sc.name, horizon_s=sc.horizon_s,
                              admission=admission, autoscaler=autoscaler,
                              fairshare=fairshare,
                              tenant_batch_cap=tenant_batch_cap,
                              formation_window_s=formation_window_s)
    return sim, sc


def run_one(scenario_name: str, policy: str, control: str, *, seed: int,
            horizon_s: float, noise_std: float, num_standby: int,
            admission_rate: float, verbose: bool, max_batch: int = 1,
            seq_len: int = 512, formation_window_s: float = 0.0,
            cells: int = 0, cell_strategy: str = "stripe",
            router: str = "least-backlog",
            rebalance_s: float = 0.0, fair: bool = False,
            tenant_batch_cap: int = 0,
            hw: HardwareSpec = H100_SXM) -> dict:
    t_wall = time.perf_counter()
    sim, sc = build_sim(scenario_name, policy, control, seed=seed,
                        horizon_s=horizon_s, noise_std=noise_std,
                        num_standby=num_standby,
                        admission_rate=admission_rate, max_batch=max_batch,
                        seq_len=seq_len,
                        formation_window_s=formation_window_s, cells=cells,
                        cell_strategy=cell_strategy, router=router,
                        rebalance_s=rebalance_s, fair=fair,
                        tenant_batch_cap=tenant_batch_cap, hw=hw)
    report = sim.run()
    summary = report.summary()
    fallbacks = summary.get("plan_fallbacks", 0.0)
    if fallbacks:
        # e.g. exact_oracle beyond max_enum_nodes silently planning with
        # the paper heuristic — never let that pollute gap numbers unseen
        print(f"    [{policy}/{control}] WARNING: {fallbacks:.0f} "
              "plan(s) used a fallback policy (see Plan.meta)",
              file=sys.stderr)
    if verbose:
        for line in report.log:
            if any(k in line for k in
                   ("disconnect", "re-DISTRIBUTE", "reconnect",
                    "straggler", "parked", "REJECTED", "DEGRADED",
                    "scale-up", "scale-down", "node_up")):
                print(f"    [{policy}/{control}] {line}", file=sys.stderr)
    row = {"scenario": sc.name, "policy": policy, "control": control,
           "seed": seed, "max_batch": max_batch, "seq_len": seq_len,
           "cells": cells, "fairshare": bool(fair)}
    if sc.tenants:
        # per-tenant breakdown + who the scenario marks abusive (the
        # stack never reads the flag; the fairness gate's victim set is
        # everyone else)
        row["tenants"] = report.tenant_summary()
        row["abusive_tenants"] = sorted(
            t.name for t in sc.tenants if t.abusive)
    if cells > 0:
        row["cell_strategy"] = cell_strategy
        row["router"] = router
        row["rebalances"] = len(sim.rebalances)
        row["plans_made"] = sim.plans_made()
    row.update({k: float(v) for k, v in summary.items()})
    row["admission_counts"] = dict(report.admission_counts)
    row["scaling_actions"] = [
        {"kind": a.kind, "node": a.node, "decided_s": a.decided_s,
         "ready_s": a.ready_s, "reason": a.reason}
        for a in report.scaling]
    # control-plane wall-clock: the whole cell (table build + trace +
    # sim) and the event loop alone
    row["wall_clock_s"] = time.perf_counter() - t_wall
    row["sim_wall_s"] = report.wall_s
    row["sim_events"] = report.n_events
    row["events_per_sec"] = report.n_events / max(report.wall_s, 1e-9)
    return row


def _fair_modes(scenario_name: str, mode: str):
    """Fairshare settings to sweep for one scenario: ``auto`` turns the
    bundle on exactly for scenarios that declare tenants, ``both`` is
    the off-then-on A/B (validated to run over tenant scenarios only)."""
    if mode == "off":
        return [False]
    if mode == "auto":
        return [True] if scenario_name in TENANT_SCENARIOS else [False]
    return [False, True] if mode == "both" else [True]


def _print_tenants(row):
    fs = "on" if row["fairshare"] else "off"
    for name in sorted(row["tenants"]):
        m = row["tenants"][name]
        tag = (" (abusive)" if name in row.get("abusive_tenants", ())
               else "")
        print(f"    [{row['policy']}/{row['control']}/fs-{fs}] "
              f"tenant={name}{tag} offered={m['offered']:.0f} "
              f"admitted={m['admitted']:.0f} shed={m['shed_rate']:.3f} "
              f"viol={m['admitted_violation_rate']:.3f} "
              f"sr={m['service_ratio']:.3f} "
              f"p99={m['p99_latency_s']:.4f}s "
              f"goodput={m['goodput_rps']:.2f}", file=sys.stderr)


def main(argv=None, *, hw: HardwareSpec = H100_SXM) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sim",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="steady",
                    help=f"one of {sorted(SCENARIOS)}, a fleet scenario "
                         f"({sorted(FLEET_SCENARIOS)}), a tenant "
                         f"scenario ({sorted(TENANT_SCENARIOS)}), "
                         "'tenants' (all tenant scenarios), "
                         f"'{TRACE_PREFIX}<path>' (serving-log replay), "
                         "or 'all' (the classic grid; fleet and tenant "
                         "scenarios run only when named — fleet event "
                         "counts scale with fleet size, tenant metrics "
                         "only mean something with the per-tenant "
                         "breakdown)")
    policy_names = registered_policies()
    ap.add_argument("--policies", default=",".join(SWEEP_POLICIES),
                    help="comma-separated subset of "
                         f"{sorted(policy_names)} (default: the classic "
                         "five-policy sweep — newer registry entries run "
                         "when named)")
    ap.add_argument("--max-batch", default="1",
                    help="comma-separated engine-batch caps to sweep "
                         "(default 1 = continuous batching off; e.g. "
                         "'1,32' is the batching A/B)")
    ap.add_argument("--seq-len", type=int, default=512,
                    help="profiling-table sequence length (the serving "
                         "item size). Short items (<=32) are the "
                         "memory-bound regime where batching pays")
    ap.add_argument("--formation-window", type=float, default=0.0,
                    help="continuous-batching partial-batch hold window "
                         "in sim-seconds (0 = launch as soon as the "
                         "server frees)")
    ap.add_argument("--control", default="none,full",
                    help="comma-separated subset of "
                         f"{CONTROL_MODES} to sweep")
    ap.add_argument("--fairshare", default="auto",
                    choices=FAIRSHARE_MODES,
                    help="multi-tenant fairness bundle (per-tenant "
                         "admission buckets + DRR fair queue): auto = on "
                         "for tenant scenarios / off otherwise, both = "
                         "the off-then-on A/B sweep (tenant scenarios "
                         "only)")
    ap.add_argument("--tenants", action="store_true",
                    help="print the per-tenant breakdown (offered / "
                         "admitted / shed / admitted-violation rate / "
                         "service ratio / p99) to stderr under each row")
    ap.add_argument("--tenant-batch-cap", type=int, default=0,
                    help="max items one tenant may claim in a formed "
                         "engine batch before the work-conserving fill "
                         "(0 = tenant-blind formation; unsharded path "
                         "only)")
    ap.add_argument("--standby", type=int, default=2,
                    help="standby nodes available to the autoscaler "
                         f"(0..{len(STANDBY_NODES)})")
    ap.add_argument("--admission-rate", type=float, default=0.0,
                    help="token-bucket refill rate in req/s "
                         "(<=0 disables rate shaping; the SLO-feasibility "
                         "gate always runs)")
    ap.add_argument("--cells", type=int, default=0,
                    help="shard the control plane into this many cells "
                         "(ShardedSimulator); 0 = the unsharded single "
                         "gateway. cells=1 is byte-identical to 0 and "
                         "exists to validate the sharding layer")
    ap.add_argument("--cell-strategy", default="stripe",
                    choices=("stripe", "by-class"),
                    help="fleet partition strategy "
                         "(repro_torch.sched.shard)")
    ap.add_argument("--router", default="least-backlog",
                    choices=("least-backlog", "rendezvous"),
                    help="root request-routing policy across cells")
    ap.add_argument("--rebalance", type=float, default=0.0,
                    help="root rebalance period in sim-seconds: move one "
                         "pooled standby node from the calmest to the "
                         "hottest cell when their normalized backlogs "
                         "diverge (0 = off; multi-cell only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=float, default=None,
                    help="arrival horizon in sim-seconds (default: 30, "
                         "or the per-fleet default for fleet scenarios "
                         f"— {FLEET_HORIZONS})")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="execution-time noise std (SimBackend)")
    ap.add_argument("--json", default="",
                    help="also dump all rows (with admission/scaling "
                         "detail) to this JSON file")
    ap.add_argument("--verbose", action="store_true",
                    help="print fault/admission/scaling log lines to "
                         "stderr")
    args = ap.parse_args(argv)

    scenario_names = (sorted(SCENARIOS) if args.scenario == "all"
                      else sorted(TENANT_SCENARIOS)
                      if args.scenario == "tenants"
                      else [args.scenario])
    for s in scenario_names:
        if s.startswith(TRACE_PREFIX):
            trace_path = s[len(TRACE_PREFIX):]
            if not os.path.exists(trace_path):
                ap.error(f"trace file not found: {trace_path!r}")
        elif (s not in SCENARIOS and s not in FLEET_SCENARIOS
              and s not in TENANT_SCENARIOS):
            ap.error(f"unknown scenario {s!r}; have {sorted(SCENARIOS)}, "
                     f"{sorted(FLEET_SCENARIOS)}, "
                     f"{sorted(TENANT_SCENARIOS)}, "
                     f"'{TRACE_PREFIX}<path>' (serving-log replay), "
                     "'tenants', or 'all'")
    policies = [p.strip() for p in args.policies.split(",") if p.strip()]
    if not policies:
        ap.error("--policies must name at least one policy "
                 f"from {sorted(policy_names)}")
    for p in policies:
        # reference:<name> rows run the retained unoptimized planners
        base = p[len(REFERENCE_PREFIX):] if p.startswith(REFERENCE_PREFIX) \
            else p
        if base not in policy_names:
            ap.error(f"unknown policy {p!r}; have {sorted(policy_names)} "
                     f"(optionally prefixed with {REFERENCE_PREFIX!r})")
    controls = [c.strip() for c in args.control.split(",") if c.strip()]
    if not controls:
        ap.error(f"--control must name at least one of {CONTROL_MODES}")
    for c in controls:
        if c not in CONTROL_MODES:
            ap.error(f"unknown control mode {c!r}; have {CONTROL_MODES}")
    if args.horizon is not None and args.horizon <= 0:
        ap.error("--horizon must be > 0 sim-seconds")
    if args.cells < 0:
        ap.error("--cells must be >= 0 (0 = unsharded)")
    if args.rebalance < 0:
        ap.error("--rebalance must be >= 0 sim-seconds (0 = off)")
    try:
        batches = [int(b) for b in args.max_batch.split(",") if b.strip()]
    except ValueError:
        batches = []
    if not batches or any(b < 1 for b in batches):
        ap.error("--max-batch must be a comma-separated list of ints >= 1")
    if args.seq_len < 1:
        ap.error("--seq-len must be >= 1")
    if args.formation_window < 0:
        ap.error("--formation-window must be >= 0")
    non_tenant = [s for s in scenario_names if s not in TENANT_SCENARIOS]
    if args.fairshare in ("on", "both") and non_tenant:
        ap.error(f"--fairshare {args.fairshare} needs tenant scenarios "
                 "(the bundle's weights and rate limits come from the "
                 f"scenario's TenantSpecs); {non_tenant} declare none. "
                 "Use --scenario tenants or a name from "
                 f"{sorted(TENANT_SCENARIOS)}")
    if args.tenant_batch_cap < 0:
        ap.error("--tenant-batch-cap must be >= 0 (0 = tenant-blind)")
    if args.tenant_batch_cap > 0 and args.cells > 0:
        ap.error("--tenant-batch-cap only plumbs into the unsharded "
                 "path (--cells 0); per-cell batch formation stays "
                 "tenant-blind")
    fleet_only = all(s in FLEET_SCENARIOS for s in scenario_names)
    if args.standby < 0:
        ap.error("--standby must be >= 0")
    if not fleet_only and args.standby > len(STANDBY_NODES):
        # classic cluster standby comes from the fixed STANDBY_NODES
        # pool; fleet tables synthesize any number of standby slices
        ap.error(f"--standby must be in 0..{len(STANDBY_NODES)} for "
                 "non-fleet scenarios")
    if args.standby == 0 and any(c in ("autoscale", "full")
                                 for c in controls):
        ap.error("--standby 0 leaves the autoscaler with an empty pool; "
                 "rows labeled 'autoscale'/'full' would silently behave "
                 "like 'none'/'admission' — raise --standby or drop "
                 "those control modes")

    cols = ("scenario", "policy", "control", "offered", "admitted",
            "completed", "shed_rate", "degraded", "p50_latency_s",
            "p99_latency_s", "deadline_violation_rate", "goodput_rps",
            "mean_acc", "scale_ups", "mean_scale_up_latency_s",
            "redistributes")
    # a bare batch-1 sweep keeps the classic CSV shape; a --max-batch
    # sweep appends the batch column
    batch_sweep = batches != [1]
    if batch_sweep:
        cols = cols + ("max_batch",)
    # ... and a sweep that ever runs the fairness bundle appends the
    # fairshare column; pure fs-off sweeps keep the classic shape
    fair_sweep = any(True in _fair_modes(s, args.fairshare)
                     for s in scenario_names)
    if fair_sweep:
        cols = cols + ("fairshare",)
    print(",".join(cols))
    rows = []
    for sname in scenario_names:
        horizon = args.horizon
        if horizon is None:
            # trace replay derives its horizon from the last logged
            # arrival unless one is forced explicitly
            horizon = (0.0 if sname.startswith(TRACE_PREFIX)
                       else FLEET_HORIZONS.get(sname, 30.0))
        for policy in policies:
            for control in controls:
                for max_batch, fair in (
                        (b, f) for b in batches
                        for f in _fair_modes(sname, args.fairshare)):
                    row = run_one(sname, policy, control, seed=args.seed,
                                  horizon_s=horizon,
                                  noise_std=args.noise,
                                  num_standby=args.standby,
                                  admission_rate=args.admission_rate,
                                  verbose=args.verbose,
                                  max_batch=max_batch,
                                  seq_len=args.seq_len,
                                  formation_window_s=args.formation_window,
                                  cells=args.cells,
                                  cell_strategy=args.cell_strategy,
                                  router=args.router,
                                  rebalance_s=args.rebalance,
                                  fair=fair,
                                  tenant_batch_cap=args.tenant_batch_cap,
                                  hw=hw)
                    rows.append(row)
                    out = [
                        row["scenario"], row["policy"], row["control"],
                        f"{row['offered']:.0f}", f"{row['admitted']:.0f}",
                        f"{row['completed']:.0f}",
                        f"{row['shed_rate']:.3f}",
                        f"{row['degraded']:.0f}",
                        f"{row['p50_latency_s']:.4f}",
                        f"{row['p99_latency_s']:.4f}",
                        f"{row['deadline_violation_rate']:.3f}",
                        f"{row['goodput_rps']:.2f}",
                        f"{row['mean_acc']:.2f}",
                        f"{row['scale_ups']:.0f}",
                        f"{row['mean_scale_up_latency_s']:.2f}",
                        f"{row['redistributes']:.0f}",
                    ]
                    if batch_sweep:
                        out.append(f"{row['max_batch']:d}")
                    if fair_sweep:
                        out.append("on" if row["fairshare"] else "off")
                    print(",".join(out))
                    if args.tenants and "tenants" in row:
                        _print_tenants(row)
    # plan-cache effectiveness across the sweep: the counters ride on
    # every row's summary, so the aggregate hit rate is free to report
    hits = sum(row.get("plan_cache_hits", 0.0) for row in rows)
    misses = sum(row.get("plan_cache_misses", 0.0) for row in rows)
    if hits + misses > 0:
        print(f"plan cache: {hits:.0f}/{hits + misses:.0f} plans reused "
              f"(hit rate {hits / (hits + misses):.3f})", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION, "rows": rows},
                      f, indent=2, sort_keys=True)
        print(f"wrote {len(rows)} rows to {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
