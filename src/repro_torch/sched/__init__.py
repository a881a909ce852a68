"""Unified scheduling API: ClusterState -> Policy.plan() -> Plan.

Public surface:
  * state    — ClusterState (immutable snapshot: profiling view,
               availability, backlogs, standby set, sim time)
  * plan     — Plan (Dispatch + predicted finish times / makespan /
               feasibility metadata)
  * policy   — Policy protocol, @register_policy, get_policy,
               resolve_policy, registered_policies
  * policies — the five registered policies (uniform, uniform_apx,
               asymmetric, proportional, exact_oracle)

The sharded control plane (``shard``) and the legacy free-function shim
(``core.dispatch``) are not part of this package yet.
"""
from repro_torch.sched.plan import Plan
from repro_torch.sched.policies import (Asymmetric, ExactOracle, Proportional,
                                  Uniform, UniformApx)
from repro_torch.sched.policy import (Policy, get_policy, register_policy,
                                registered_policies, resolve_policy)
from repro_torch.sched.reference import ReferencePolicy
from repro_torch.sched.state import ClusterState, SnapshotCache

__all__ = [
    "ClusterState", "SnapshotCache", "Plan", "Policy",
    "register_policy", "registered_policies", "get_policy",
    "resolve_policy", "ReferencePolicy",
    "Uniform", "UniformApx", "Asymmetric", "Proportional", "ExactOracle",
]
