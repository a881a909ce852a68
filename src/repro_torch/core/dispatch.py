"""Legacy dispatch surface — thin shim over ``repro_torch.sched``.

The policy implementations (paper §III-C Algorithm 1 + baselines) live in
``repro_torch.sched.policies`` on the unified ``ClusterState -> Policy.plan()
-> Plan`` protocol; this module is the reference package's legacy
free-function surface,

    dispatch(policy_name, table, request) -> Dispatch
    POLICIES = {name: fn(table, request) -> Dispatch}

kept in the port for parity: nothing in the port calls it, and
``tests/test_torch_shard_dispatch.py`` holds every function against
``repro.core.dispatch`` on the same tables and requests. Each call snapshots
the table into an immutable ClusterState (no backlogs, t=0 — the
timeless/offline view) and unwraps the resulting Plan's Dispatch. New
code should use ``repro_torch.sched`` directly: the Plan carries the predicted
finish times / makespan / feasibility the gate needs.
"""
from __future__ import annotations

from repro_torch.core.profiling import ProfilingTable
from repro_torch.core.requests import Dispatch, InferenceRequest
from repro_torch.sched import ClusterState, get_policy, registered_policies


def _plan_offline(name: str, table: ProfilingTable,
                  request: InferenceRequest, **kwargs) -> Dispatch:
    state = ClusterState.from_table(table)
    return get_policy(name, **kwargs).plan(state, request).dispatch


def uniform(table: ProfilingTable, request: InferenceRequest) -> Dispatch:
    return _plan_offline("uniform", table, request)


def uniform_apx(table: ProfilingTable, request: InferenceRequest,
                margin: float = 0.02) -> Dispatch:
    return _plan_offline("uniform_apx", table, request, margin=margin)


def asymmetric(table: ProfilingTable, request: InferenceRequest) -> Dispatch:
    return _plan_offline("asymmetric", table, request)


def proportional(table: ProfilingTable, request: InferenceRequest,
                 margin: float = 0.02) -> Dispatch:
    return _plan_offline("proportional", table, request, margin=margin)


def exact_oracle(table: ProfilingTable, request: InferenceRequest,
                 max_enum_nodes: int = 7) -> Dispatch:
    return _plan_offline("exact_oracle", table, request,
                         max_enum_nodes=max_enum_nodes)


def accuracy_edf(table: ProfilingTable,
                 request: InferenceRequest) -> Dispatch:
    return _plan_offline("accuracy_edf", table, request)


POLICIES = {
    "uniform": uniform,
    "uniform_apx": uniform_apx,
    "asymmetric": asymmetric,
    "proportional": proportional,
    "exact_oracle": exact_oracle,
    "accuracy_edf": accuracy_edf,
}

# every registered policy must stay reachable through the legacy surface
assert set(POLICIES) == set(registered_policies()), (
    "repro_torch.sched registry and legacy POLICIES shim diverged")


def dispatch(policy: str, table: ProfilingTable,
             request: InferenceRequest) -> Dispatch:
    return POLICIES[policy](table, request)
