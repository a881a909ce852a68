"""Scenario DSL: canned online-serving situations for the simulator.

A ``Scenario`` is (arrival process, timed faults, horizon) built against a
ProfilingTable so arrival rates and perf requirements scale with the
cluster actually being simulated. Builders:

  * ``steady``          — homogeneous Poisson at ``load`` x the cluster's
                          full-accuracy capacity
  * ``diurnal``         — sinusoidal ramp (day/night traffic swing)
  * ``node-churn``      — steady load + two mid-stream disconnects and one
                          reconnect (paper Fig. 9, online)
  * ``straggler-storm`` — steady load + rolling DVFS slowdowns that later
                          clear (paper's throttling experiment, online)
  * ``fleet-64`` / ``fleet-256`` — large-fleet control-plane stressors:
                          steady load plus a churn wave over a synthetic
                          heterogeneous fleet (``FLEET_SCENARIOS``; build
                          the matching table with
                          ``core.cluster.synthetic_fleet``). Kept out of
                          ``SCENARIOS`` so ``--scenario all`` sweeps stay
                          the classic grid — every request fans a share to
                          every node, so fleet event counts scale ~linearly
                          with fleet size and want short horizons
                          (``FLEET_HORIZONS``).
  * ``fleet-1024`` / ``fleet-4096`` — sharded-control-plane scale
                          points: same churn-wave shape, but requests are
                          sized for a 64-node cell (``capacity_frac``) so
                          the trace stays feasible when each lands on one
                          cell's slice of the fleet. fleet-4096 is beyond
                          a single gateway's MAX_EVENTS budget and exists
                          for ``cells >= 16`` runs.

Use :func:`build_scenario` for name-based lookup (``repro_torch.launch.sim``)
— it resolves classic and fleet names — or call the builders directly
with custom knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiling import ProfilingTable
from repro_torch.sim.arrivals import (Arrival, BurstArrivals, DiurnalArrivals,
                                PoissonArrivals, RequestSampler,
                                TenantSpec, TraceArrivals)
from repro_torch.sim.simulator import TimedFault


@dataclasses.dataclass
class Scenario:
    """One reproducible serving situation: who arrives when, what breaks.

    ``tenants`` carries the multi-tenant mix (when any) out of the
    builder so the harness can wire the gateway to match — fair-share
    weights and per-tenant rate limits come from these specs. Empty for
    every single-tenant scenario.
    """
    name: str
    description: str
    arrivals: List[Arrival]
    faults: List[TimedFault]
    horizon_s: float
    tenants: Tuple[TenantSpec, ...] = ()


def _rate_for_load(table: ProfilingTable, sampler: RequestSampler,
                   load: float) -> float:
    """Requests/s such that offered work ~= load x full-accuracy capacity.

    Capacity is the level-0 throughput (items/s) of the *available* nodes
    — standby slices waiting on the autoscaler don't serve and must not
    dilute the load factor; the mean request carries mean(item_choices)
    items.
    """
    cols = [j for j, n in enumerate(table.nodes) if n.available]
    cols = cols or list(range(table.num_nodes))
    capacity = table.perf[0, cols].sum()
    mean_items = float(np.mean(sampler.item_choices))
    return load * capacity / mean_items


def steady(table: ProfilingTable, *, seed: int = 0, horizon_s: float = 60.0,
           load: float = 0.7,
           sampler: Optional[RequestSampler] = None) -> Scenario:
    sampler = sampler or RequestSampler(table)
    rate = _rate_for_load(table, sampler, load)
    return Scenario(
        name="steady",
        description=f"Poisson arrivals at {load:.0%} of full-accuracy "
                    f"capacity ({rate:.2f} req/s) for {horizon_s:.0f}s",
        arrivals=PoissonArrivals(rate, horizon_s, sampler, seed).generate(),
        faults=[], horizon_s=horizon_s)


def diurnal(table: ProfilingTable, *, seed: int = 0, horizon_s: float = 120.0,
            load: float = 0.55, amplitude: float = 0.8,
            sampler: Optional[RequestSampler] = None) -> Scenario:
    sampler = sampler or RequestSampler(table)
    rate = _rate_for_load(table, sampler, load)
    return Scenario(
        name="diurnal",
        description=f"sinusoidal ramp around {load:.0%} load, "
                    f"peak {(1 + amplitude) * load:.0%}",
        arrivals=DiurnalArrivals(rate, horizon_s, sampler, seed,
                                 amplitude=amplitude).generate(),
        faults=[], horizon_s=horizon_s)


def node_churn(table: ProfilingTable, *, seed: int = 0,
               horizon_s: float = 90.0, load: float = 0.85,
               sampler: Optional[RequestSampler] = None) -> Scenario:
    """Two weakest nodes drop mid-stream; one comes back — every drop
    re-DISTRIBUTEs the affected in-flight requests over the survivors."""
    sampler = sampler or RequestSampler(table)
    rate = _rate_for_load(table, sampler, load)
    # faults hit *serving* nodes — a standby slice can't disconnect
    names = [n.name for n in table.nodes if n.available]
    victims = [names[-1], names[-2] if len(names) > 1 else names[-1]]
    return Scenario(
        name="node-churn",
        description=f"steady {load:.0%} load; {victims[0]} drops at 1/3 "
                    f"horizon (rejoins at 2/3), {victims[1]} drops at 1/2",
        arrivals=PoissonArrivals(rate, horizon_s, sampler, seed).generate(),
        faults=[
            TimedFault(time=horizon_s / 3, kind="disconnect",
                       node=victims[0]),
            TimedFault(time=horizon_s / 2, kind="disconnect",
                       node=victims[1]),
            TimedFault(time=2 * horizon_s / 3, kind="reconnect",
                       node=victims[0]),
        ],
        horizon_s=horizon_s)


def straggler_storm(table: ProfilingTable, *, seed: int = 0,
                    horizon_s: float = 90.0, load: float = 0.5,
                    slowdown: float = 0.4,
                    sampler: Optional[RequestSampler] = None) -> Scenario:
    """Rolling DVFS-style throttling: each node in turn runs at
    ``slowdown`` x its profiled perf for a window, then recovers."""
    sampler = sampler or RequestSampler(table)
    rate = _rate_for_load(table, sampler, load)
    names = [n.name for n in table.nodes if n.available]
    window = horizon_s / (len(names) + 1)
    faults: List[TimedFault] = []
    for i, n in enumerate(names):
        t0 = window * (i + 0.5)
        faults.append(TimedFault(time=t0, kind="straggler", node=n,
                                 slowdown=slowdown))
        faults.append(TimedFault(time=t0 + window, kind="straggler_clear",
                                 node=n))
    return Scenario(
        name="straggler-storm",
        description=f"rolling {slowdown:g}x slowdowns, one node at a time",
        arrivals=PoissonArrivals(rate, horizon_s, sampler, seed).generate(),
        faults=faults, horizon_s=horizon_s)


def overload(table: ProfilingTable, *, seed: int = 0,
             horizon_s: float = 60.0, load: float = 1.6,
             sampler: Optional[RequestSampler] = None) -> Scenario:
    """Sustained saturation: Poisson arrivals at ``load`` > 1 x the active
    cluster's full-accuracy capacity. Without admission control every
    policy's queues grow without bound (backlog paid in p99); with the
    closed-loop gateway the excess is shed/degraded and standby slices
    spawn."""
    assert load > 1.0, "overload means offered > capacity; use steady below"
    sampler = sampler or RequestSampler(table)
    rate = _rate_for_load(table, sampler, load)
    return Scenario(
        name="overload",
        description=f"sustained Poisson at {load:.0%} of active capacity "
                    f"({rate:.2f} req/s) for {horizon_s:.0f}s",
        arrivals=PoissonArrivals(rate, horizon_s, sampler, seed).generate(),
        faults=[], horizon_s=horizon_s)


def flash_crowd(table: ProfilingTable, *, seed: int = 0,
                horizon_s: float = 90.0, base_load: float = 0.4,
                peak_load: float = 2.5, burst_start_frac: float = 1 / 3,
                burst_len_frac: float = 1 / 6,
                sampler: Optional[RequestSampler] = None) -> Scenario:
    """Quiet traffic with a sudden rectangular burst far above capacity —
    the scale-up-latency stressor: the autoscaler must spot the spike,
    pay the warm-up, and drain before the deadline budget of the burst's
    tail is gone; admission sheds what the warm-up window cannot save."""
    sampler = sampler or RequestSampler(table)
    base = _rate_for_load(table, sampler, base_load)
    peak = _rate_for_load(table, sampler, peak_load)
    t0 = horizon_s * burst_start_frac
    t1 = t0 + horizon_s * burst_len_frac
    return Scenario(
        name="flash-crowd",
        description=f"{base_load:.0%} base load with a "
                    f"{peak_load:.0%}-of-capacity burst in "
                    f"[{t0:.0f}s, {t1:.0f}s)",
        arrivals=BurstArrivals(base, peak, t0, t1, horizon_s, sampler,
                               seed).generate(),
        faults=[], horizon_s=horizon_s)


def trace(table: ProfilingTable, arrivals: Sequence[Arrival],
          faults: Sequence[TimedFault] = (), *,
          name: str = "trace") -> Scenario:
    """Wrap an explicit trace + fault list (tests, replayed logs)."""
    arr = TraceArrivals(arrivals).generate()
    horizon = max((t for t, _ in arr), default=0.0)
    return Scenario(name=name, description="explicit trace",
                    arrivals=arr, faults=list(faults), horizon_s=horizon)


def fleet(table: ProfilingTable, *, seed: int = 0, horizon_s: float = 6.0,
          load: float = 0.7, churn_frac: float = 0.05,
          capacity_frac: float = 1.0,
          sampler: Optional[RequestSampler] = None,
          name: str = "fleet") -> Scenario:
    """Large-fleet control-plane stressor: steady Poisson at ``load`` x
    capacity over a many-node heterogeneous fleet, plus a churn wave —
    the weakest ``churn_frac`` of the fleet drops at 1/3 horizon and
    rejoins at 2/3 — so snapshot/plan caches see availability churn, not
    just steady state. Built for ``synthetic_fleet`` tables but works on
    any; pair with short horizons (every request fans a share onto every
    available node, so events ~= arrivals x fleet size).

    ``capacity_frac`` sizes each request's perf_req against that fraction
    of the fleet's capacity (see ``RequestSampler.capacity_frac``): the
    sharded fleet scenarios set it to ~cell_size/fleet_size so requests
    stay feasible inside one cell's slice. Only the default sampler is
    scaled — an explicit ``sampler`` keeps its own calibration."""
    sampler = sampler or RequestSampler(table,
                                        capacity_frac=capacity_frac)
    rate = _rate_for_load(table, sampler, load)
    active = [(j, n.name) for j, n in enumerate(table.nodes) if n.available]
    # churn the weakest level-0 columns: losing them stresses replanning
    # without collapsing capacity
    victims = sorted(active, key=lambda jn: table.perf[0, jn[0]])
    victims = [nm for _, nm in victims[:max(1, int(len(active)
                                                  * churn_frac))]]
    faults: List[TimedFault] = []
    for nm in victims:
        faults.append(TimedFault(time=horizon_s / 3, kind="disconnect",
                                 node=nm))
        faults.append(TimedFault(time=2 * horizon_s / 3, kind="reconnect",
                                 node=nm))
    return Scenario(
        name=name,
        description=f"{len(active)}-node fleet at {load:.0%} load "
                    f"({rate:.1f} req/s), {len(victims)} node(s) churning",
        arrivals=PoissonArrivals(rate, horizon_s, sampler, seed).generate(),
        faults=faults, horizon_s=horizon_s)


def fleet_64(table: ProfilingTable, *, seed: int = 0, **kwargs) -> Scenario:
    kwargs.setdefault("horizon_s", FLEET_HORIZONS["fleet-64"])
    return fleet(table, seed=seed, name="fleet-64", **kwargs)


def fleet_256(table: ProfilingTable, *, seed: int = 0, **kwargs) -> Scenario:
    kwargs.setdefault("horizon_s", FLEET_HORIZONS["fleet-256"])
    return fleet(table, seed=seed, name="fleet-256", **kwargs)


def fleet_1024(table: ProfilingTable, *, seed: int = 0,
               **kwargs) -> Scenario:
    """Sharded-control-plane scale point: requests are sized for a
    64-node cell (capacity_frac=1/16), so the same trace is feasible for
    a single 1024-node gateway *and* for 16 cells of 64 — the bench's
    cells=1 vs cells=16 comparison runs identical offered load. The
    short default horizon keeps an unsharded run under the simulator's
    MAX_EVENTS guard (events ~= arrivals x fleet size)."""
    kwargs.setdefault("horizon_s", FLEET_HORIZONS["fleet-1024"])
    kwargs.setdefault("capacity_frac", 1.0 / 16.0)
    return fleet(table, seed=seed, name="fleet-1024", **kwargs)


def fleet_4096(table: ProfilingTable, *, seed: int = 0,
               **kwargs) -> Scenario:
    """Beyond single-gateway reach: at 4096 nodes an unsharded run blows
    MAX_EVENTS at any useful horizon — this scenario exists for the
    sharded control plane (cells >= 16). Requests sized for 64-node
    cells (capacity_frac=1/64)."""
    kwargs.setdefault("horizon_s", FLEET_HORIZONS["fleet-4096"])
    kwargs.setdefault("capacity_frac", 1.0 / 64.0)
    return fleet(table, seed=seed, name="fleet-4096", **kwargs)


# ---- multi-tenant scenarios -------------------------------------------
def _merge_streams(*streams: Sequence[Arrival]) -> List[Arrival]:
    """Merge independently generated arrival streams into one trace:
    time-sorted, rids reassigned in arrival order (the simulator keys
    records by rid, so merged traces must not collide)."""
    merged = sorted((a for s in streams for a in s), key=lambda a: a[0])
    return [(t, dataclasses.replace(req, rid=i))
            for i, (t, req) in enumerate(merged)]


def noisy_neighbor(table: ProfilingTable, *, seed: int = 0,
                   horizon_s: float = 40.0, load: float = 2.4,
                   abuser_frac: float = 0.75,
                   sampler: Optional[RequestSampler] = None) -> Scenario:
    """One tenant floods the gateway with ``abuser_frac`` of a
    ``load`` > 1 offered stream while two well-behaved tenants stay
    comfortably inside capacity. The tenancy headline case: with fair
    scheduling on, the victims' admitted requests must keep meeting
    their deadlines no matter what the hot tenant does; tenant-blind
    serving lets the abuser's backlog push everyone's p99 over budget.
    Entitlements are equal (``share`` unset) and every tenant carries
    the *same* per-tenant rate limit — an equal slice of the cluster's
    admittable request rate — so the gateway is *not* told who the
    abuser is; the abuser simply exhausts its own slice."""
    victims_frac = (1.0 - abuser_frac) / 2.0
    # equal slice of the capacity-rate (the request rate a load of 1.0
    # would offer): victims run well inside theirs, the abuser's flood
    # drains its own bucket and nobody else's
    slice_rate = _rate_for_load(table, RequestSampler(table), 1.0) / 3.0
    tenants = (
        TenantSpec("tenant-hot", weight=abuser_frac, abusive=True,
                   rate_limit=slice_rate),
        TenantSpec("tenant-a", weight=victims_frac,
                   rate_limit=slice_rate),
        TenantSpec("tenant-b", weight=victims_frac,
                   rate_limit=slice_rate),
    )
    sampler = sampler or RequestSampler(table, tenants=tenants)
    rate = _rate_for_load(table, sampler, load)
    return Scenario(
        name="noisy-neighbor",
        description=f"{load:.0%}-of-capacity Poisson stream, "
                    f"{abuser_frac:.0%} of it from one abusive tenant; "
                    "two victim tenants offer well under capacity",
        arrivals=PoissonArrivals(rate, horizon_s, sampler,
                                 seed).generate(),
        faults=[], horizon_s=horizon_s, tenants=tenants)


def tenant_skew(table: ProfilingTable, *, seed: int = 0,
                horizon_s: float = 40.0, load: float = 0.9,
                sampler: Optional[RequestSampler] = None) -> Scenario:
    """Four tenants with a heavily skewed but *declared* mix: fair-share
    entitlements track the arrival weights and each tenant carries a
    matching per-tenant admission rate limit (25% headroom), so the
    per-tenant token buckets shape exactly the traffic each tenant was
    sold. Near-capacity load keeps the DRR ring busy without the
    overload shedding dominating the metrics."""
    weights = (0.55, 0.25, 0.15, 0.05)
    base_rate = _rate_for_load(table, RequestSampler(table), load)
    tenants = tuple(
        TenantSpec(f"tenant-{i}", weight=w, share=w,
                   rate_limit=1.25 * w * base_rate)
        for i, w in enumerate(weights))
    sampler = sampler or RequestSampler(table, tenants=tenants)
    rate = _rate_for_load(table, sampler, load)
    return Scenario(
        name="tenant-skew",
        description=f"4 tenants at {load:.0%} load, mix "
                    f"{'/'.join(f'{w:.0%}' for w in weights)}; "
                    "entitlements and rate limits track the mix",
        arrivals=PoissonArrivals(rate, horizon_s, sampler,
                                 seed).generate(),
        faults=[], horizon_s=horizon_s, tenants=tenants)


def flash_crowd_tenant(table: ProfilingTable, *, seed: int = 0,
                       horizon_s: float = 60.0, base_load: float = 0.45,
                       hot_base_load: float = 0.05,
                       hot_peak_load: float = 2.0,
                       burst_start_frac: float = 1 / 3,
                       burst_len_frac: float = 1 / 6) -> Scenario:
    """Flash crowd confined to one tenant: three steady tenants share a
    comfortable base load while a fourth idles — then bursts alone to
    ``hot_peak_load`` x capacity for a window. Unlike ``flash-crowd``
    (where the spike is everyone's), the right outcome here is
    *asymmetric*: the bursting tenant eats its own shed/queueing while
    the steady tenants ride through untouched."""
    steady_specs = tuple(
        TenantSpec(f"tenant-{c}", weight=1.0) for c in "abc")
    hot_spec = (TenantSpec("tenant-hot", weight=1.0, abusive=True),)
    base_sampler = RequestSampler(table, tenants=steady_specs)
    hot_sampler = RequestSampler(table, tenants=hot_spec)
    base = _rate_for_load(table, base_sampler, base_load)
    hot_base = _rate_for_load(table, hot_sampler, hot_base_load)
    hot_peak = _rate_for_load(table, hot_sampler, hot_peak_load)
    t0 = horizon_s * burst_start_frac
    t1 = t0 + horizon_s * burst_len_frac
    arrivals = _merge_streams(
        PoissonArrivals(base, horizon_s, base_sampler, seed).generate(),
        BurstArrivals(hot_base, hot_peak, t0, t1, horizon_s, hot_sampler,
                      seed + 1).generate())
    return Scenario(
        name="flash-crowd-tenant",
        description=f"3 steady tenants at {base_load:.0%} total; "
                    f"tenant-hot bursts to {hot_peak_load:.0%} of "
                    f"capacity in [{t0:.0f}s, {t1:.0f}s)",
        arrivals=arrivals, faults=[], horizon_s=horizon_s,
        tenants=steady_specs + hot_spec)


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "steady": steady,
    "diurnal": diurnal,
    "node-churn": node_churn,
    "straggler-storm": straggler_storm,
    "overload": overload,
    "flash-crowd": flash_crowd,
}

# fleet scenarios resolve through build_scenario but stay out of the
# ``all`` sweep: their event counts scale with fleet size
FLEET_SIZES: Dict[str, int] = {"fleet-64": 64, "fleet-256": 256,
                               "fleet-1024": 1024, "fleet-4096": 4096}
FLEET_HORIZONS: Dict[str, float] = {"fleet-64": 6.0, "fleet-256": 2.0,
                                    "fleet-1024": 0.4, "fleet-4096": 0.05}
FLEET_SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "fleet-64": fleet_64,
    "fleet-256": fleet_256,
    "fleet-1024": fleet_1024,
    "fleet-4096": fleet_4096,
}

# multi-tenant scenarios resolve through build_scenario (and run_sim's
# ``--scenario tenants`` alias) but stay out of the classic ``all``
# sweep: their metrics only mean something next to the per-tenant
# breakdown and the fairness gate
TENANT_SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "noisy-neighbor": noisy_neighbor,
    "tenant-skew": tenant_skew,
    "flash-crowd-tenant": flash_crowd_tenant,
}


# scenario-spec prefix for file-backed trace replay:
# ``trace:path/to/log.csv`` (or .jsonl) loads the serving log through
# :meth:`TraceArrivals.from_file` instead of a synthetic process
TRACE_PREFIX = "trace:"


def trace_file(table: ProfilingTable, path: str, *,
               horizon_s: float = 0.0, **from_file_kwargs) -> Scenario:
    """File-backed trace replay (real serving logs, CSV/JSONL)."""
    arr = TraceArrivals.from_file(path, **from_file_kwargs).generate()
    horizon = horizon_s or max((t for t, _ in arr), default=0.0)
    return Scenario(name=f"trace:{path}",
                    description=f"replay of {len(arr)} logged arrivals "
                                f"from {path}",
                    arrivals=arr, faults=[], horizon_s=horizon)


def build_scenario(name: str, table: ProfilingTable, *, seed: int = 0,
                   **kwargs) -> Scenario:
    if name.startswith(TRACE_PREFIX):
        return trace_file(table, name[len(TRACE_PREFIX):], **kwargs)
    builder = (SCENARIOS.get(name) or FLEET_SCENARIOS.get(name)
               or TENANT_SCENARIOS.get(name))
    if builder is None:
        raise KeyError(
            f"unknown scenario {name!r}; have "
            f"{sorted(SCENARIOS) + sorted(FLEET_SCENARIOS) + sorted(TENANT_SCENARIOS)}"
            f", or '{TRACE_PREFIX}<path>' for file-backed replay")
    return builder(table, seed=seed, **kwargs)
