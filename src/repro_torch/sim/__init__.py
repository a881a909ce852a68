"""Discrete-event online serving simulation (sim clock, arrivals, faults).

Public surface:
  * events      — SimClock, EventQueue, SeqCounter, SimEvent
  * arrivals    — PoissonArrivals, DiurnalArrivals, BurstArrivals,
                  TraceArrivals, RequestSampler, TenantSpec
  * simulator   — OnlineSimulator, TimedFault, RequestRecord, SimReport
  * sharded     — ShardedSimulator (per-cell gateways behind a root
                  router; ``cells=1`` is byte-identical to the unsharded
                  OnlineSimulator)
  * scenarios   — Scenario, build_scenario, SCENARIOS + builders

The closed-loop gateway controls (AdmissionController, Autoscaler) live in
``repro_torch.control`` and plug into OnlineSimulator via its ``admission`` /
``autoscaler`` constructor args; the cell partition/router logic lives in
``repro_torch.sched.shard``.
"""
from repro_torch.sim.arrivals import (ArrivalProcess, BurstArrivals,
                                DiurnalArrivals, PoissonArrivals,
                                RequestSampler, TenantSpec, TraceArrivals)
from repro_torch.sim.events import EventQueue, SeqCounter, SimClock, SimEvent
from repro_torch.sim.scenarios import (FLEET_HORIZONS, FLEET_SCENARIOS,
                                 FLEET_SIZES, SCENARIOS, TENANT_SCENARIOS,
                                 Scenario, build_scenario)
from repro_torch.sim.simulator import (OnlineSimulator, RequestRecord, SimReport,
                                 TimedFault)
from repro_torch.sim.sharded import ShardedSimulator    # noqa: E402  (needs simulator)

__all__ = [
    "ArrivalProcess", "BurstArrivals", "DiurnalArrivals", "PoissonArrivals",
    "RequestSampler", "TenantSpec", "TraceArrivals", "EventQueue",
    "SeqCounter", "SimClock", "SimEvent",
    "SCENARIOS", "FLEET_SCENARIOS", "FLEET_SIZES", "FLEET_HORIZONS",
    "TENANT_SCENARIOS", "Scenario", "build_scenario", "OnlineSimulator",
    "ShardedSimulator", "RequestRecord", "SimReport", "TimedFault",
]
