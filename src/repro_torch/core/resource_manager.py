"""Distributed Resource Manager: Gateway/Local-node FSMs (paper Fig. 4).

Gateway Node (GN) states: PROFILE -> NETCOM -> {DISTRIBUTE on workload |
DISTRIBUTE on disconnect} -> NETCOM (broadcast) -> INFERENCE -> NETCOM.
Local Node (LN) states:   PROFILE -> NETCOM -> (wait) -> INFERENCE -> NETCOM.

The implementation is event-driven over an in-process message bus standing
in for the paper's POSIX sockets; on a real fleet the bus maps onto the
coordinator RPC plane (the data plane stays pjit'd per-group inference).
Every transition is logged so tests can assert the exact FSM sequences,
including the disconnect -> re-Distribute path (paper Fig. 9) and the
beyond-paper straggler EWMA decay.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core import trace
from repro_torch.core.cluster import SimBackend
from repro_torch.core.profiling import NodeProfile, ProfilingTable
from repro_torch.core.requests import (Dispatch, ExecutionResult, InferenceRequest,
                                 violation_summary)
from repro_torch.sched import ClusterState, Plan, Policy, SnapshotCache, resolve_policy


class GNState(enum.Enum):
    PROFILE = "profile"
    NETCOM = "netcom"
    DISTRIBUTE = "distribute"
    INFERENCE = "inference"


class LNState(enum.Enum):
    PROFILE = "profile"
    NETCOM = "netcom"
    WAIT = "wait"
    INFERENCE = "inference"


@dataclasses.dataclass
class Event:
    # "workload" | "disconnect" | "reconnect" | "straggler"
    # | "spawn" | "retire"  (autoscaler membership changes)
    kind: str
    request: Optional[InferenceRequest] = None
    node: Optional[str] = None
    slowdown: float = 1.0
    time: float = 0.0         # sim-clock timestamp (0 = timeless/offline)


class LocalNode:
    """LN FSM: profiles itself, waits for (workload, apx) and runs it."""

    def __init__(self, profile: NodeProfile):
        self.profile = profile
        self.state = LNState.PROFILE
        self.log: List[LNState] = [self.state]

    def _to(self, s: LNState):
        self.state = s
        self.log.append(s)

    def run_profile(self, table: ProfilingTable, j: int) -> np.ndarray:
        """PROFILE: measure/predict own column, then NETCOM it to the GN."""
        assert self.state == LNState.PROFILE
        column = table.perf[:, j].copy()
        self._to(LNState.NETCOM)
        self._to(LNState.WAIT)
        return column

    def run_inference(self, items: int, apx_level: int,
                      backend_time: float) -> Dict[str, float]:
        assert self.state == LNState.WAIT
        self._to(LNState.INFERENCE)
        result = {"items": items, "apx": apx_level, "time_s": backend_time}
        self._to(LNState.NETCOM)
        self._to(LNState.WAIT)
        return result


class GatewayNode:
    """GN FSM (paper Fig. 4) orchestrating the cluster.

    ``policy`` selects the dispatch strategy; the paper's is
    ``proportional``. Straggler mitigation (beyond paper): the GN applies an
    EWMA decay to a node's profiled column when its observed per-item time
    exceeds the table prediction.
    """

    def __init__(self, table: ProfilingTable, backend: SimBackend,
                 policy: Union[str, Policy] = "proportional", *,
                 straggler_ewma: float = 0.5,
                 snapshot_caching: bool = True,
                 max_batch: int = 1):
        self.table = table
        self.backend = backend
        # engine-batch cap of the serving runtime: every snapshot this GN
        # takes carries it, so policies and the admission gate price at
        # the batch the node runtime will actually achieve. 1 = batching
        # off (the pre-batching scalar model, bit-identical)
        assert max_batch >= 1, "max_batch must be >= 1"
        self.max_batch = max_batch
        # copy-on-write snapshots: one frozen profiling view shared across
        # snapshots until the table's version says it mutated. False
        # forces a full copy per snapshot (the unoptimized baseline the bench
        # measures against; it also leaves Plan memo keys unset)
        self._snap_cache = SnapshotCache() if snapshot_caching else None
        self.policy_obj: Policy = resolve_policy(policy)
        self.policy: str = self.policy_obj.name   # registry name (reports)
        self.state = GNState.PROFILE
        self.log: List[GNState] = [self.state]
        self.locals: Dict[str, LocalNode] = {
            n.name: LocalNode(n) for n in table.nodes}
        self._name_idx: Dict[str, int] = {
            n.name: j for j, n in enumerate(table.nodes)}
        self.results: List[ExecutionResult] = []
        self.dispatches: List[Dispatch] = []
        self.plans: List[Plan] = []
        self.straggler_ewma = straggler_ewma
        self._profiled = False

    def _to(self, s: GNState):
        self.state = s
        self.log.append(s)

    # ---- PROFILE + initial NETCOM ------------------------------------
    def startup(self):
        """PROFILE own column, NETCOM gathers LN columns into the table."""
        assert self.state == GNState.PROFILE
        for j, (name, ln) in enumerate(self.locals.items()):
            col = ln.run_profile(self.table, j)
            self.table.update_node(j, col)
        self._profiled = True
        self._to(GNState.NETCOM)

    # ---- event loop ---------------------------------------------------
    def handle(self, ev: Event) -> Optional[ExecutionResult]:
        with trace.span("gateway.handle"):
            return self._handle(ev)

    def _handle(self, ev: Event) -> Optional[ExecutionResult]:
        assert self._profiled, "startup() first"
        if ev.kind == "workload":
            return self._handle_workload(ev.request, now=ev.time)
        if ev.kind == "disconnect":
            self._set_available(ev.node, False)
            # Fig. 4: disconnection triggers re-Distribute of the current
            # workload over the survivors (handled on next workload or by
            # redistribute() for an in-flight one)
            return None
        if ev.kind == "reconnect":
            self._set_available(ev.node, True)
            return None
        if ev.kind == "straggler":
            self.backend.set_straggler(ev.node, ev.slowdown)
            return None
        if ev.kind == "spawn":
            # autoscaler scale-up: the node re-runs PROFILE on join so the
            # dispatch policy sees a fresh column, then enters the set
            names = [n.name for n in self.table.nodes]
            self.table.reprofile_node(names.index(ev.node))
            self._set_available(ev.node, True)
            return None
        if ev.kind == "retire":
            # autoscaler scale-down: leave the serving set; in-flight and
            # queued shares drain (the caller keeps the queue running)
            self._set_available(ev.node, False)
            return None
        raise ValueError(ev.kind)

    def _set_available(self, node: str, avail: bool):
        for n in self.table.nodes:
            if n.name == node:
                n.available = avail

    def snapshot(self, *, now: float = 0.0,
                 backlogs: Optional[Mapping[str, float]] = None,
                 standby: Sequence[str] = ()) -> ClusterState:
        """Freeze the cluster into an immutable ClusterState: the pruned
        profiling view, availability, per-node backlog seconds, the
        autoscaler's standby set, and the sim time. This is the only
        thing a policy (or the admission gate) ever reads. Snapshots are
        copy-on-write: the heavy arrays are shared until a table mutation
        bumps ``ProfilingTable.version``."""
        if self._snap_cache is not None:
            return self._snap_cache.snapshot(self.table, now=now,
                                             backlogs=backlogs,
                                             standby=tuple(standby),
                                             max_batch=self.max_batch)
        return ClusterState.from_table(self.table, now=now,
                                       backlogs=backlogs,
                                       standby=tuple(standby),
                                       max_batch=self.max_batch)

    def plan(self, request: InferenceRequest, *, now: float = 0.0,
             backlogs: Optional[Mapping[str, float]] = None,
             standby: Sequence[str] = ()) -> Plan:
        """NETCOM -> DISTRIBUTE -> NETCOM (broadcast): snapshot the
        cluster, delegate to the policy object, and commit the resulting
        Plan WITHOUT executing.

        The online simulator calls this at a request's dispatch time,
        schedules the plan's shares onto per-node work queues itself, and
        reports the timed outcome back through :meth:`complete`.
        """
        state = self.snapshot(now=now, backlogs=backlogs, standby=standby)
        return self.commit(self.policy_obj.plan(state, request))

    def commit(self, plan: Plan) -> Plan:
        """Record a Plan as this GN's dispatch decision (FSM DISTRIBUTE
        transition). The admission gate plans through the policy itself;
        committing the *same* Plan here is what guarantees gate and
        queues act on one planning pass."""
        self._to(GNState.DISTRIBUTE)
        self.dispatches.append(plan.dispatch)
        self.plans.append(plan)
        self._to(GNState.NETCOM)
        return plan

    def complete(self, d: Dispatch, result: ExecutionResult) -> ExecutionResult:
        """INFERENCE -> NETCOM: record an executed dispatch's outcome,
        drive the LN FSMs, and apply straggler feedback."""
        self._to(GNState.INFERENCE)
        for a in d.assignments:
            if a.items > 0:
                ln = self.locals[a.node]
                ln.run_inference(a.items, a.apx_level,
                                 result.per_node_time.get(a.node, 0.0))
        # straggler mitigation: decay profiled perf toward observed perf
        self._apply_straggler_feedback(d, result)
        self._to(GNState.NETCOM)
        self.results.append(result)
        return result

    def _handle_workload(self, request: InferenceRequest,
                         now: float = 0.0) -> ExecutionResult:
        """Synchronous (timeless) path: plan + execute-all-at-once +
        complete. ``now`` stamps the dispatch on the sim clock."""
        d = self.plan(request, now=now).dispatch
        result = self.backend.execute(d, now=max(now, request.arrival_s))
        return self.complete(d, result)

    def redistribute(self, request: InferenceRequest,
                     now: float = 0.0) -> ExecutionResult:
        """Disconnect-during-execution path: re-enter DISTRIBUTE with the
        surviving nodes and re-run the request (paper Fig. 4 right edge)."""
        return self._handle_workload(request, now=now)

    def _apply_straggler_feedback(self, d: Dispatch, r: ExecutionResult):
        for a in d.assignments:
            if a.items == 0:
                continue
            observed_t = r.per_node_time.get(a.node)
            if observed_t is None or observed_t <= 0:
                continue
            j = self._name_idx[a.node]
            if self.max_batch > 1:
                # batch-aware prediction: comparing a batched execution
                # against the scalar REF_BATCH prediction would read the
                # amortization itself as a straggler signal (or mask a
                # real one), decaying healthy nodes
                from repro_torch.core.profiling import batched_service_s
                predicted_t = batched_service_s(
                    a.items, self.table.perf_b[a.apx_level, j],
                    self.table.batch_grid, self.max_batch)
            else:
                predicted_t = a.items / max(
                    self.table.perf[a.apx_level, j], 1e-9)
            ratio = predicted_t / observed_t          # <1 means slower
            if ratio < 0.95:
                w = self.straggler_ewma
                self.table.scale_node(j, w * 1.0 + (1 - w) * ratio)

    # ---- reporting ------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        return violation_summary(self.results)
