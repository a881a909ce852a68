"""The Plan: a Dispatch plus the predictions it was chosen on.

Policies return a :class:`Plan`, not a bare Dispatch: the workload split
*and* the per-node finish times / makespan / feasibility the policy
predicted from the :class:`~repro_torch.sched.state.ClusterState` snapshot.
The admission gate decides admit/degrade/reject from those predictions
and the simulator then dispatches this exact plan — plan once, reuse in
the gate (no second planning pass between gate and queues).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Mapping

from repro_torch.core.requests import Dispatch, InferenceRequest

_EMPTY: Mapping[str, object] = types.MappingProxyType({})


@dataclasses.dataclass(frozen=True)
class Plan:
    """One policy decision over one ClusterState snapshot.

    All times are on the sim clock. ``node_finish_s[name]`` is
    ``created_s + backlog_s(name) + service`` — when the node's share is
    predicted to complete given the queue it joins; only nodes carrying a
    non-empty share appear. ``makespan_s`` spans dispatch to the last
    share's finish (queue wait included), matching the online
    simulator's realized makespan; ``exec_makespan_s`` is the pure
    service makespan the timeless/offline path realizes.
    """
    dispatch: Dispatch
    policy: str
    created_s: float                       # snapshot time the plan is for
    node_service_s: Mapping[str, float]    # predicted pure service per node
    node_finish_s: Mapping[str, float]     # created + backlog + service
    exec_makespan_s: float                 # max service (offline makespan)
    makespan_s: float                      # finish_s - created_s
    finish_s: float                        # predicted last-share completion
    alloc_perf: float                      # sum of assigned throughputs
    predicted_acc: float                   # workload-weighted accuracy %
    feasible: bool                         # alloc_perf meets perf_req
    meta: Mapping[str, object] = _EMPTY    # policy annotations (fallbacks…)

    @property
    def request(self) -> InferenceRequest:
        return self.dispatch.request

    @property
    def slack_s(self) -> float:
        """Deadline slack as seen at planning time: latency budget minus
        the predicted queue wait + service span. Negative => the plan is
        predicted to miss the deadline (measured from ``created_s``, the
        arrival instant in the online path)."""
        budget = self.request.latency_budget_s
        if budget == float("inf"):
            return float("inf")
        return budget - self.makespan_s

    @property
    def meets_deadline(self) -> bool:
        return self.slack_s >= -1e-9
