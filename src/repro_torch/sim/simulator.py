"""Discrete-event online serving simulator (paper §IV under sustained load).

Drives the existing GatewayNode FSM and dispatch policies on a simulated
clock: requests arrive over time (Poisson / diurnal / trace), the GN
re-enters DISTRIBUTE per request, and each assignment becomes a *share* on
its node's FIFO work queue with a service time from ``SimBackend``.
Disconnect / reconnect / straggler faults are timed events injected
mid-stream; a disconnect aborts the dead node's in-flight + queued shares
and re-DISTRIBUTEs the affected requests over the survivors (paper Fig. 9,
now happening *during* execution instead of between manual calls).

Per-request accounting: arrival -> dispatch -> per-share queue wait ->
last-share completion; deadline = the request's ``latency_budget_s``.

Batch-aware node runtime: with ``max_batch > 1`` each node serves
*engine batches* instead of whole shares — continuous batching. Batches
form from the FIFO queue at every service boundary (join-on-arrival: a
share that arrives between batches joins the next one), restricted to
one approximation level per batch (different levels are different model
variants), capped at ``max_batch`` items, and timed on the profiling
table's batch curve. Consecutive full batches of a single share
coalesce into one event (identical timing, O(1) events per share), so
batching does not inflate the event count; a partial batch may be held
for a short formation window (``BatchFormation.window_s``) to let
joiners fill it. ``max_batch=1`` (the default) is the pre-batching
one-share-at-a-time model, byte-identical to the unbatched simulator.

Closed-loop control (optional): each event builds one immutable
``ClusterState`` snapshot (availability, profiling view, per-node queue
backlogs, standby set) shared by both controllers. The
``AdmissionController`` gates every arrival against the token bucket and
the dispatch policy's own backlog-aware ``Plan`` (reject / degrade /
admit — the admitted plan is dispatched verbatim, no second planning
pass), and the ``Autoscaler`` spawns/retires standby worker groups on
queue-depth and deadline-violation signals — spawns become serveable
after a warm-up (``node_up`` event) and trigger a re-PROFILE of the
joining node's table column. Requests parked during a total outage
re-enter through the admission gate when capacity returns.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.control.admission import (ADMIT, DEGRADE, REJECT,
                                     AdmissionController)
from repro_torch.control.autoscaler import RETIRE, SPAWN, Autoscaler, ScalingAction
from repro_torch.control.fairshare import FairShareScheduler
from repro_torch.core.batching import BatchFormation
from repro_torch.core.requests import (Assignment, Dispatch, ExecutionResult,
                                 InferenceRequest, _percentile,
                                 violation_summary)
from repro_torch.core.resource_manager import Event, GatewayNode
from repro_torch.sched import ClusterState, Plan
from repro_torch.sim.events import (EventQueue, SimClock, SimEvent,
                              SlabEventQueue)


@dataclasses.dataclass
class TimedFault:
    """A scenario-injected cluster event on the sim clock."""
    time: float
    kind: str                 # disconnect | reconnect | straggler | straggler_clear
    node: str
    slowdown: float = 1.0


@dataclasses.dataclass
class _Share:
    """One node's slice of a dispatched request, living on a work queue.

    Under continuous batching a share is *divisible*: ``remaining``
    counts items not yet completed and ``in_flight`` the items claimed
    by the node's active engine-batch op; ``service_s`` accumulates the
    share's item-weighted slice of every op it rode. The sequential
    (``max_batch=1``) path never touches either and keeps the exact
    pre-batching lifecycle.
    """
    share_id: int
    rid: int
    epoch: int                # request dispatch generation (stale detection)
    assignment: Assignment
    enqueue_s: float
    start_s: float = -1.0
    finish_s: float = -1.0
    service_s: float = 0.0
    predicted_s: float = 0.0  # cached predictor value (backlog accounting)
    remaining: int = 0        # items not yet completed (batched mode)
    in_flight: int = 0        # items claimed by the active op

    @property
    def unclaimed(self) -> int:
        return self.remaining - self.in_flight


@dataclasses.dataclass
class _BatchOp:
    """One engine-batch service op on a node: either a *full run* —
    ``n_batches`` consecutive full engine batches of one share's items,
    coalesced into a single event because nothing can join a full batch
    — or a *mixed/partial batch* of up to ``max_batch`` items spanning
    same-level shares at the FIFO head."""
    op_id: int
    level: int
    takes: List[Tuple[_Share, int]]     # (share, items claimed)
    n_items: int                        # total items the op completes
    batch_size: int                     # engine batch the curve prices
    start_s: float = 0.0
    finish_s: float = 0.0


class NodeRuntime:
    """Per-node execution model: FIFO work queue + batch-forming server.

    With ``formation.max_batch == 1`` this is the original sequential
    one-share-at-a-time server (``running``/``pop_next``); above 1 the
    server forms engine batches continuously (see module docstring).
    Beyond executing, the runtime is a *sensor*: it reports depth,
    backlog seconds, and oldest-share age — the signals the admission
    controller and autoscaler feed on. The backlog sum is maintained
    incrementally (O(1) per enqueue/dequeue/claim instead of O(queued
    shares) per read) and revalidated lazily when the predictor's
    inputs change — the ``version`` arguments below carry
    ``SimBackend.pred_version``, which bumps on every table mutation or
    straggler derate. The share predictor is batch-aware, so the sums
    stay correct under batched service times.
    """

    def __init__(self, name: str, formation: BatchFormation = BatchFormation()):
        self.name = name
        self.formation = formation
        self.up = True
        self.running: Optional[_Share] = None       # sequential mode
        self.active: Optional[_BatchOp] = None      # batched mode
        self.forming_token = 0      # invalidates scheduled launch timers
        self.queue: Deque[_Share] = collections.deque()
        self._queued_pred_s = 0.0
        self._pred_version: object = None

    def _revalidate(self, predictor: Callable[[_Share], float],
                    version: object):
        """Re-predict every queued share when the profiling view or the
        straggler derates changed since the cached sum was built."""
        if version != self._pred_version:
            total = 0.0
            for s in self.queue:
                s.predicted_s = predictor(s)
                total += s.predicted_s
            self._queued_pred_s = total
            self._pred_version = version

    def enqueue(self, share: _Share,
                predictor: Callable[[_Share], float], version: object):
        self._revalidate(predictor, version)
        share.remaining = share.assignment.items
        share.predicted_s = predictor(share)
        self.queue.append(share)
        self._queued_pred_s += share.predicted_s

    def pop_next(self) -> _Share:
        share = self.queue.popleft()
        self._queued_pred_s -= share.predicted_s
        if not self.queue:
            self._queued_pred_s = 0.0   # pin float drift at the idle point
        return share

    def claim(self, takes: List[Tuple[_Share, int]],
              predictor: Callable[[_Share], float]):
        """Mark op items in-flight, keeping the backlog sum incremental:
        each claimed share's queued prediction shrinks to its unclaimed
        remainder (O(takes), not O(queue))."""
        for share, take in takes:
            old = share.predicted_s
            share.in_flight = take
            share.predicted_s = predictor(share)
            self._queued_pred_s += share.predicted_s - old

    def settle(self, op: _BatchOp) -> List[_Share]:
        """Apply a completed op: consume the claimed items and pop the
        completed FIFO prefix. Returns the shares that finished."""
        for share, take in op.takes:
            share.remaining -= take
            share.in_flight = 0
        done = []
        while self.queue and self.queue[0].remaining == 0:
            done.append(self.pop_next())
        return done

    def drop_rid(self, rid: int):
        self.queue = collections.deque(s for s in self.queue if s.rid != rid)
        self._queued_pred_s = sum(s.predicted_s for s in self.queue)

    def clear_queue(self):
        self.queue.clear()
        self._queued_pred_s = 0.0

    # ---- control-loop signals ---------------------------------------
    def depth(self) -> int:
        """Shares on this node (running + queued). Batched mode counts
        queued shares only — in-flight shares stay queued until done."""
        return len(self.queue) + (1 if self.running is not None else 0)

    def _active_remaining_s(self, now: float) -> float:
        total = 0.0
        if self.running is not None:
            total += max(0.0, self.running.finish_s - now)
        if self.active is not None:
            total += max(0.0, self.active.finish_s - now)
        return total

    def backlog_s(self, now: float,
                  predictor: Callable[[_Share], float],
                  version: object) -> float:
        """Predicted seconds of work ahead of a share enqueued now: the
        in-service work's remaining time plus every queued share's
        predicted service time over its unclaimed items (noise-free, so
        reading the signal is side-effect free). O(1) in the steady
        state via the incremental sum."""
        self._revalidate(predictor, version)
        return self._active_remaining_s(now) + self._queued_pred_s

    def backlog_s_recompute(self, now: float,
                            predictor: Callable[[_Share], float]) -> float:
        """Unoptimized backlog read: walk the queue calling the predictor per
        share. Retained as the baseline the incremental sensor is
        held against (``legacy_control_plane=True``)."""
        total = self._active_remaining_s(now)
        for s in self.queue:
            total += predictor(s)
        return total

    def oldest_age_s(self, now: float) -> float:
        """Age of the oldest waiting share (0 when the queue is empty)."""
        if not self.queue:
            return 0.0
        return max(0.0, now - self.queue[0].enqueue_s)


# back-compat alias: the older name for the sequential-mode runtime
_NodeQueue = NodeRuntime


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle of one request through the simulator."""
    request: InferenceRequest
    arrival_s: float
    dispatch_s: float = -1.0          # latest (re-)DISTRIBUTE time
    first_dispatch_s: float = -1.0
    finish_s: float = -1.0
    queue_wait_s: float = 0.0         # max share wait of the final dispatch
    redistributed: int = 0            # disconnect-triggered re-dispatches
    result: Optional[ExecutionResult] = None
    # admission outcome
    rejected: bool = False            # shed at the gateway, never dispatched
    reject_reason: str = ""
    degraded_admission: bool = False  # admitted with a renegotiated SLO
    effective_request: Optional[InferenceRequest] = None  # degraded copy
    # internal scheduling state
    epoch: int = 0
    pending_shares: int = 0
    dispatch: Optional[Dispatch] = None
    plan: Optional[Plan] = None       # the Plan behind the final dispatch
    per_node_time: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def admitted(self) -> bool:
        return not self.rejected

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def meets_deadline(self) -> bool:
        return self.done and self.latency_s <= (
            self.request.latency_budget_s + 1e-9)


@dataclasses.dataclass
class SimReport:
    """Outcome of one simulated run of one policy over one scenario."""
    policy: str
    scenario: str
    horizon_s: float
    records: List[RequestRecord]
    log: List[str]
    scaling: List[ScalingAction] = dataclasses.field(default_factory=list)
    admission_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    end_s: float = 0.0                # sim clock when the last event fired
    n_events: int = 0                 # events the loop processed
    wall_s: float = 0.0               # host wall-clock of run()
    # plan-reuse cache effectiveness over the run (policy-level reuse
    # across gate + dispatch planning); excluded from the golden digests
    # like wall_s/n_events — telemetry, not behaviour
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0

    def summary(self) -> Dict[str, float]:
        """Aggregate metrics. Latency / deadline metrics cover *admitted*
        requests only (a shed request has no latency); rejected load shows
        up in ``shed_rate`` and in goodput's denominator instead, so
        shedding cannot masquerade as a latency win for free."""
        admitted = [r for r in self.records if r.admitted]
        done = [r.result for r in admitted if r.done]
        s = violation_summary(done)
        n_adm = max(len(admitted), 1)
        rejected = len(self.records) - len(admitted)
        span = max(self.end_s, self.horizon_s, 1e-12)
        s["completed"] = float(len(done))
        s["offered"] = float(len(self.records))
        s["admitted"] = float(len(admitted))
        s["rejected"] = float(rejected)
        s["shed_rate"] = rejected / max(len(self.records), 1)
        s["degraded"] = float(
            sum(r.degraded_admission for r in self.records))
        s["deadline_violation_rate"] = (
            sum(not r.meets_deadline for r in admitted) / n_adm)
        # goodput: admitted requests that completed within deadline, per
        # sim-second of the whole run (drain included)
        s["goodput_rps"] = sum(
            r.meets_deadline for r in admitted) / span
        s["redistributes"] = float(sum(r.redistributed for r in self.records))
        # plan-predicted vs realized makespan: how honestly the policy's
        # (batch-aware) pricing matches what the runtime then does. Over
        # admitted, completed, never-redistributed requests; 0 when no
        # request qualifies (or no gate ran, so no plan was retained)
        errs = [
            abs((r.finish_s - r.dispatch_s) - r.plan.makespan_s)
            / max(r.finish_s - r.dispatch_s, 1e-12)
            for r in self.records
            if r.admitted and r.done and not r.redistributed
            and r.plan is not None]
        s["plan_makespan_err"] = (sum(errs) / len(errs)) if errs else 0.0
        # oracle (or any policy) falling back to a heuristic plan: count
        # it so optimality-gap numbers can't be polluted unnoticed
        s["plan_fallbacks"] = float(sum(
            1 for r in self.records
            if r.plan is not None and "fallback" in r.plan.meta))
        s["plan_cache_hits"] = float(self.plan_cache_hits)
        s["plan_cache_misses"] = float(self.plan_cache_misses)
        spawns = [a for a in self.scaling if a.kind == SPAWN]
        lat = [a.ready_s - a.decided_s for a in spawns]
        s["scale_ups"] = float(len(spawns))
        s["scale_downs"] = float(
            sum(a.kind == RETIRE for a in self.scaling))
        s["mean_scale_up_latency_s"] = (sum(lat) / len(lat)) if lat else 0.0
        # fairness index only when the run actually had >= 2 tenants:
        # single-tenant summaries keep the exact pre-tenancy key set
        # (the tenants=1 byte-identity pin hashes this dict)
        if len({r.request.tenant for r in self.records}) >= 2:
            s["fairness_jain"] = self.jain_fairness()
        return s

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant serving outcomes. ``service_ratio`` is the input
        to the Jain index: requests served within deadline over requests
        offered, so both shedding and admitted-then-violated hurt a
        tenant's share equally (the time span cancels out of the
        ratio). ``admitted_violation_rate`` is the tenancy headline —
        of the requests the gate let in, how many missed."""
        by_tenant: Dict[str, List[RequestRecord]] = {}
        for r in self.records:
            by_tenant.setdefault(r.request.tenant, []).append(r)
        span = max(self.end_s, self.horizon_s, 1e-12)
        out: Dict[str, Dict[str, float]] = {}
        for tenant in sorted(by_tenant):
            recs = by_tenant[tenant]
            admitted = [r for r in recs if r.admitted]
            met = sum(r.meets_deadline for r in admitted)
            lat = sorted(r.latency_s for r in admitted if r.done)
            out[tenant] = {
                "offered": float(len(recs)),
                "admitted": float(len(admitted)),
                "rejected": float(len(recs) - len(admitted)),
                "shed_rate": (len(recs) - len(admitted))
                             / max(len(recs), 1),
                "completed": float(sum(r.done for r in admitted)),
                "met_deadline": float(met),
                "goodput_rps": met / span,
                "admitted_violation_rate":
                    sum(not r.meets_deadline for r in admitted)
                    / max(len(admitted), 1),
                "degraded": float(
                    sum(r.degraded_admission for r in recs)),
                "p50_latency_s": _percentile(lat, 0.50),
                "p99_latency_s": _percentile(lat, 0.99),
                "service_ratio": met / max(len(recs), 1),
            }
        return out

    def jain_fairness(self) -> float:
        """Jain's index J = (sum x)^2 / (n * sum x^2) over per-tenant
        service ratios: 1.0 = perfectly even service, 1/n = one tenant
        got everything. All-zero ratios count as perfectly fair (every
        tenant equally starved)."""
        xs = [v["service_ratio"] for v in self.tenant_summary().values()]
        if len(xs) <= 1:
            return 1.0
        total = sum(xs)
        if total <= 0.0:
            return 1.0
        return total * total / (len(xs) * sum(x * x for x in xs))


class OnlineSimulator:
    """Event loop tying arrivals + faults to the GatewayNode and the
    per-node work queues. Run-to-completion: after the last arrival the
    loop drains every queue, so overloaded policies pay their backlog in
    latency rather than dropping work."""

    MAX_EVENTS = 2_000_000    # runaway guard

    def __init__(self, gn: GatewayNode,
                 arrivals: Sequence[Tuple[float, InferenceRequest]],
                 faults: Sequence[TimedFault] = (),
                 scenario: str = "custom", horizon_s: float = 0.0,
                 admission: Optional[AdmissionController] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 fairshare: Optional[FairShareScheduler] = None,
                 legacy_control_plane: bool = False,
                 max_batch: Optional[int] = None,
                 formation_window_s: float = 0.0,
                 tenant_batch_cap: int = 0,
                 event_queue: Optional[EventQueue] = None,
                 sanitize: Optional[bool] = None):
        self.gn = gn
        self.backend = gn.backend
        self.admission = admission
        self.autoscaler = autoscaler
        # runtime sanitizer: None adopts the REPRO_SANITIZE env default
        # (read once at import); True/False forces the simulator-side
        # checks per instance. The checks are pure asserts over values
        # already computed — arming them cannot change behaviour, only
        # crash earlier (tier-1 proves goldens stay byte-identical).
        self.sanitize = (_sanitize.ENABLED if sanitize is None
                         else bool(sanitize))
        self._san_last: Tuple[float, int] = (float("-inf"), -1)
        # multi-tenant fair scheduler in front of the gate: arrivals
        # queue per tenant and reach the gate in DRR order. None (the
        # default) is the pre-tenancy arrival->gate fast path, untouched.
        self.fairshare = fairshare
        # continuous batching: engine-batch cap per node runtime. None
        # adopts the GN's own cap, so planner pricing and execution are
        # configured in one place; 1 = the sequential pre-batching model
        self.batching = BatchFormation(
            max_batch=gn.max_batch if max_batch is None else max_batch,
            window_s=formation_window_s, tenant_cap=tenant_batch_cap)
        if max_batch is not None and max_batch != gn.max_batch:
            # the GN snapshots carry gn.max_batch into every Plan — a
            # runtime batching differently would break the plan-once
            # predicted==realized contract silently
            raise ValueError(
                f"simulator max_batch={max_batch} disagrees with the "
                f"GatewayNode's max_batch={gn.max_batch}; construct the "
                "GN with the same cap so plans price what the runtime "
                "executes")
        # True routes snapshots through ClusterState.from_table (full copy
        # per event) and backlog reads through the per-share recompute —
        # the unoptimized control plane, kept as the twin that
        # tests/test_torch_sim.py holds the incremental path against on
        # identical traffic
        self.legacy_control_plane = legacy_control_plane
        if admission is not None and admission.policy is None:
            # gate and dispatch must plan identically: the admission
            # controller adopts the GN's own policy object unless the
            # caller wired a different one in explicitly
            admission.policy = gn.policy_obj
        self.clock = SimClock()
        # the sharded control plane injects a queue wired to a *shared*
        # seq counter so every cell draws dynamic seqs from one total
        # order; standalone use gets a private counter (the pre-shard
        # behaviour, bit-identical)
        self.events = event_queue if event_queue is not None \
            else EventQueue()
        # settlement hook: called once per request when it reaches a
        # terminal outcome (rejected at the gate, or finalized). The
        # sharded root uses it to keep its per-cell outstanding-work
        # routing counters current; None (the default) is a no-op.
        self.on_settled: Optional[Callable[[RequestRecord], None]] = None
        self.nodes: Dict[str, NodeRuntime] = {
            n.name: NodeRuntime(n.name, self.batching)
            for n in gn.table.nodes}
        # batching.enabled is a property chain; the fused event loop
        # branches on it once per event, so hoist it (BatchFormation is
        # frozen — the flag cannot change mid-run)
        self._batched = self.batching.enabled
        # fused dispatch: one handler per event kind, payload-dict in —
        # replaces the _handle if/elif chain on the hot path. Handlers
        # fold the follow-up work (finalize -> start-next) of the old
        # _handle -> _share_done -> _complete_share -> _maybe_start
        # call chain into one pass; event *semantics* and event *counts*
        # are unchanged (see process_run).
        self._handlers: Dict[str, Callable[[Dict], None]] = {
            "arrival": self._ev_arrival,
            "share_done": self._ev_share_done,
            "batch_done": self._ev_batch_done,
            "batch_launch": self._ev_batch_launch,
            "node_up": self._ev_node_up,
            "disconnect": self._ev_disconnect,
            "reconnect": self._ev_reconnect,
            "straggler": self._ev_straggler,
            "straggler_clear": self._ev_straggler_clear,
        }
        self.records: Dict[int, RequestRecord] = {}
        self.log: List[str] = []
        self.scenario = scenario
        self.horizon_s = horizon_s or (
            max((t for t, _ in arrivals), default=0.0))
        self._share_seq = 0
        self._op_seq = 0
        self._parked: List[InferenceRequest] = []   # no available nodes
        seen_rids = set()
        for t, req in arrivals:
            assert abs(req.arrival_s - t) < 1e-9, (
                f"request {req.rid}: arrival_s={req.arrival_s} disagrees "
                f"with its scheduled arrival time {t}")
            assert req.rid not in seen_rids, (
                f"duplicate rid {req.rid} in arrival trace; records and "
                "share accounting are keyed by rid")
            seen_rids.add(req.rid)
            self.events.push(t, "arrival", request=req)
        for f in faults:
            self.events.push(f.time, f.kind, node=f.node,
                             slowdown=f.slowdown)

    # ---- logging -----------------------------------------------------
    def _log(self, msg: str):
        self.log.append(f"t={self.clock.now:10.3f}s  {msg}")

    # ---- main loop ---------------------------------------------------
    def run(self) -> SimReport:
        if not self.gn._profiled:
            self.gn.startup()
        t0 = time.perf_counter()  # detlint: ok[DET001] wall_s telemetry only; excluded from the golden digests
        # the whole run is one unbounded drain through the fused loop;
        # the limit keeps the old per-event MAX_EVENTS guard exact (the
        # pre-fusion loop raised after processing event MAX_EVENTS + 1)
        n_events = self.process_run((float("inf"), -1), self.MAX_EVENTS + 1)
        if n_events > self.MAX_EVENTS:
            raise RuntimeError("simulator exceeded MAX_EVENTS")
        hits, misses = self.plan_cache_counts()
        return SimReport(policy=self.gn.policy, scenario=self.scenario,
                         horizon_s=self.horizon_s,
                         records=[self.records[k]
                                  for k in sorted(self.records)],
                         log=self.log,
                         scaling=(list(self.autoscaler.actions)
                                  if self.autoscaler else []),
                         admission_counts=(dict(self.admission.counts)
                                           if self.admission else {}),
                         end_s=self.clock.now,
                         n_events=n_events,
                         plan_cache_hits=hits, plan_cache_misses=misses,
                         wall_s=time.perf_counter() - t0)  # detlint: ok[DET001] wall_s telemetry only; excluded from the golden digests

    def plan_cache_counts(self) -> Tuple[int, int]:
        """(hits, misses) of the plan-reuse caches this run planned
        through: the GN's dispatch policy and the admission gate's
        planner — usually the same object, deduped by identity so shared
        counters are never double-counted."""
        hits = misses = 0
        seen = set()
        planners = [self.gn.policy_obj]
        if self.admission is not None and self.admission.policy is not None:
            planners.append(self.admission.policy)
        for pol in planners:
            reuse = getattr(pol, "_reuse", None)
            if reuse is not None and id(reuse) not in seen:  # detlint: ok[DET006] identity-dedup of shared counter objects (gate and GN usually share one planner); never an ordering key
                seen.add(id(reuse))  # detlint: ok[DET006] same identity-dedup set
                hits += reuse.hits
                misses += reuse.misses
        return hits, misses

    def process_next(self) -> SimEvent:
        """Pop and handle the earliest scheduled event. ``run()`` is this
        in a loop; the sharded root calls it directly so it can merge
        many cells' queues into one global (time, seq) order."""
        ev = self.events.pop()
        if self.sanitize:
            # (time, seq) must strictly follow the previous event: this
            # catches both a backwards clock and a duplicated/reused seq
            # (which would break the sharded merge loop's total order)
            assert (ev.time, ev.seq) > self._san_last, (
                f"event order violated: ({ev.time}, {ev.seq}) after "
                f"{self._san_last}")
            self._san_last = (ev.time, ev.seq)
        self.clock.advance_to(ev.time)
        self._handle(ev)
        return ev

    def process_run(self, bound: Tuple[float, int], limit: int) -> int:
        """Batched :meth:`process_next`: pop and handle events while the
        head key stays strictly below ``bound``, up to ``limit`` events.
        Returns the number handled.

        The sharded root's run-draining merge calls this once per *run*
        — handling an event only ever pushes follow-ups into this same
        simulator's queue, so as long as the head stays below every
        other merge candidate the global (time, seq) order is unchanged
        and the root pays its bookkeeping per run instead of per event.
        Per-event semantics are byte-identical to ``process_next`` (same
        pops, same sanitizer assert, same clock advance, same handler);
        the body is inlined here because the method-call plumbing is
        exactly the per-event overhead the run variant exists to remove.
        ``limit`` keeps the MAX_EVENTS runaway guard exact: an unbounded
        run (e.g. a lone cell with no arrivals left) could otherwise
        self-schedule past the cap before the root sees a count.

        Two drain bodies, one contract: the slab queue's fast path pops
        raw (time, seq, slot) triples and jumps straight through the
        handler table — no SimEvent, no ``_handle`` frame; any other
        queue (the retained reference twin) drains through
        ``pop``/``_handle``. Same pops, same sanitizer assert, same
        clock advance, same handlers — byte-identical event streams
        (pinned by tests/test_torch_sim.py)."""
        events = self.events
        clock = self.clock
        sanitize = self.sanitize
        bt, bs = bound
        n = 0
        if type(events) is SlabEventQueue:
            heap = events._heap
            kinds = events._kind
            payloads = events._payload
            free = events._free
            handlers = self._handlers
            heappop = heapq.heappop
            while n < limit and heap:
                head = heap[0]
                t = head[0]
                if t > bt or (t == bt and head[1] >= bs):
                    break
                t, seq, slot = heappop(heap)
                if sanitize:
                    key = (t, seq)
                    assert key > self._san_last, (
                        f"event order violated: {key} after "
                        f"{self._san_last}")
                    self._san_last = key
                # clock.advance_to, inlined: heap pop order is non-
                # decreasing per queue, so the backwards-clock assert is
                # structurally unreachable here
                if t > clock.now:
                    clock.now = t
                kind = kinds[slot]
                payload = payloads[slot]
                kinds[slot] = None
                payloads[slot] = None
                free.append(slot)
                h = handlers.get(kind)
                if h is None:
                    raise ValueError(f"unknown sim event kind: {kind}")
                h(payload)
                n += 1
            return n
        handle = self._handle
        while n < limit and events:
            key = events.peek_key()
            if key >= bound:
                break
            ev = events.pop()
            if sanitize:
                assert key > self._san_last, (
                    f"event order violated: {key} after "
                    f"{self._san_last}")
                self._san_last = key
            if key[0] > clock.now:
                clock.now = key[0]
            handle(ev)
            n += 1
        return n

    def _handle(self, ev: SimEvent):
        """Compatibility dispatch for SimEvent consumers (``process_next``
        and the reference drain): one table lookup instead of the old
        if/elif chain, same handlers, same unknown-kind error."""
        h = self._handlers.get(ev.kind)
        if h is None:
            raise ValueError(f"unknown sim event kind: {ev.kind}")
        h(ev.payload)

    def _handle_reference(self, ev: SimEvent):
        """The pre-fusion dispatch chain, retained verbatim: if/elif
        kind dispatch into the unfused helper methods (``_share_done``
        -> ``_complete_share`` -> ``_maybe_start``). The reference
        stack (``ShardedSimulator(reference_stack=True)``) rebinds
        ``_handle`` to this, and ``tests/test_torch_sim.py`` pins its
        event stream byte-identically against the fused handler table — fusion is a call-graph collapse, not
        a semantics change."""
        now = self.clock.now
        if ev.kind == "arrival":
            req: InferenceRequest = ev.payload["request"]
            rec = RequestRecord(request=req, arrival_s=req.arrival_s)
            self.records[req.rid] = rec
            if self.fairshare is not None:
                self.fairshare.enqueue(req)
                self._fair_drain(now)
                self._autoscale_tick(now, None)
                return
            state = (self._snapshot(now) if self.admission is not None
                     or self._autoscaler_ready(now) else None)
            self._admit(rec, now, state)
            self._autoscale_tick(now, state)
        elif ev.kind == "share_done":
            self._share_done(ev.payload["node"], ev.payload["share_id"])
            self._autoscale_tick(now, None)
        elif ev.kind == "batch_done":
            self._batch_done(ev.payload["node"], ev.payload["op_id"])
            self._autoscale_tick(now, None)
        elif ev.kind == "batch_launch":
            self._batch_launch(ev.payload["node"], ev.payload["token"])
        elif ev.kind == "node_up":
            self._node_up(ev.payload["node"])
        elif ev.kind == "disconnect":
            self._disconnect(ev.payload["node"])
        elif ev.kind == "reconnect":
            self._reconnect(ev.payload["node"])
        elif ev.kind in ("straggler", "straggler_clear"):
            slowdown = (1.0 if ev.kind == "straggler_clear"
                        else ev.payload["slowdown"])
            self.gn.handle(Event(kind="straggler", node=ev.payload["node"],
                                 slowdown=slowdown, time=now))
            self._log(f"{ev.kind} node={ev.payload['node']} "
                      f"slowdown={slowdown:g}")
        else:
            raise ValueError(f"unknown sim event kind: {ev.kind}")

    # ---- fused event handlers (payload-dict in, one per kind) --------
    def _ev_arrival(self, payload: Dict):
        now = self.clock.now
        req: InferenceRequest = payload["request"]
        rec = RequestRecord(request=req, arrival_s=req.arrival_s)
        self.records[req.rid] = rec
        if self.fairshare is not None:
            # tenant FIFO first; the DRR ring decides who reaches
            # the gate, so a flooding tenant queues behind its own
            # share instead of ahead of everyone else's arrivals
            self.fairshare.enqueue(req)
            self._fair_drain(now)
            self._autoscale_tick(now, None)
            return
        # one ClusterState snapshot per event, shared by both
        # controllers (and by the plan the gate hands to the queues)
        state = (self._snapshot(now) if self.admission is not None
                 or self._autoscaler_ready(now) else None)
        self._admit(rec, now, state)
        if self.autoscaler is not None:
            self._autoscale_tick(now, state)

    def _ev_share_done(self, payload: Dict):
        # the old _share_done -> _complete_share -> _maybe_start chain,
        # fused: finalize the share and start the node's next share in
        # one pass (same node, same timestamp, strictly larger seq for
        # any follow-up event — the run-draining safety argument)
        nq = self.nodes[payload["node"]]
        share = nq.running
        if share is not None and share.share_id == payload["share_id"]:
            nq.running = None
            rec = self.records[share.rid]
            if share.epoch == rec.epoch and not rec.done:
                rec.per_node_time[nq.name] = share.service_s
                rec.queue_wait_s = max(rec.queue_wait_s,
                                       share.start_s - rec.dispatch_s)
                rec.pending_shares -= 1
                if rec.pending_shares == 0:
                    self._finalize(rec)
            # else: a share of a superseded dispatch generation —
            # discard, the node just paid the time.
            if self._batched:
                self._maybe_start_batched(nq)
            elif nq.up and nq.running is None and nq.queue:
                # _finalize above may have started this node already
                # (fair-share drain admitting new work) — re-check
                self._start_next(nq)
        if self.autoscaler is not None:
            self._autoscale_tick(self.clock.now, None)

    def _ev_batch_done(self, payload: Dict):
        self._batch_done(payload["node"], payload["op_id"])
        if self.autoscaler is not None:
            self._autoscale_tick(self.clock.now, None)

    def _ev_batch_launch(self, payload: Dict):
        self._batch_launch(payload["node"], payload["token"])

    def _ev_node_up(self, payload: Dict):
        self._node_up(payload["node"])

    def _ev_disconnect(self, payload: Dict):
        self._disconnect(payload["node"])

    def _ev_reconnect(self, payload: Dict):
        self._reconnect(payload["node"])

    def _ev_straggler(self, payload: Dict):
        node = payload["node"]
        slowdown = payload["slowdown"]
        self.gn.handle(Event(kind="straggler", node=node,
                             slowdown=slowdown, time=self.clock.now))
        self._log(f"straggler node={node} slowdown={slowdown:g}")

    def _ev_straggler_clear(self, payload: Dict):
        # clearing ignores the payload's slowdown, exactly as before
        node = payload["node"]
        self.gn.handle(Event(kind="straggler", node=node,
                             slowdown=1.0, time=self.clock.now))
        self._log(f"straggler_clear node={node} slowdown={1.0:g}")

    # ---- closed-loop control ----------------------------------------
    def _share_pred(self, share: _Share) -> float:
        """Deterministic service prediction for one queued share's
        unclaimed items — the scalar predictor when batching is off, the
        engine-batch decomposition (at the unclaimed remainder) when on;
        the same math the planners price Plans with."""
        if not self.batching.enabled:
            return self.backend.predicted_time(share.assignment)
        return self.backend.batched_predicted_time(
            share.assignment, self.batching.max_batch,
            items=share.unclaimed)

    def _backlogs(self, now: float) -> Dict[str, float]:
        """Per-node backlog seconds from the queue sensors — incremental
        O(nodes) reads unless the legacy control plane was requested."""
        pred = self._share_pred
        if self.legacy_control_plane:
            return {name: nq.backlog_s_recompute(now, pred)
                    for name, nq in self.nodes.items()}
        version = self.backend.pred_version
        return {name: nq.backlog_s(now, pred, version)
                for name, nq in self.nodes.items()}

    def _snapshot(self, now: float) -> ClusterState:
        """One immutable ClusterState per event: per-node backlog
        seconds from the queue sensors, availability from the table, and
        the autoscaler's current standby pool — the single signal the
        admission gate, the policy, and the autoscaler all read."""
        backlogs = self._backlogs(now)
        standby: Tuple[str, ...] = ()
        if self.autoscaler is not None:
            standby = tuple(self.autoscaler.standby) + self.autoscaler.pending
        if self.legacy_control_plane:
            return ClusterState.from_table(self.gn.table, now=now,
                                           backlogs=backlogs,
                                           standby=standby,
                                           max_batch=self.batching.max_batch)
        return self.gn.snapshot(now=now, backlogs=backlogs,
                                standby=standby)

    def _admit(self, rec: RequestRecord, now: float,
               state: Optional[ClusterState]):
        """Admission gate in front of DISTRIBUTE; absent a controller
        every request is admitted unchanged (the ungated simulator). On
        ADMIT/DEGRADE the decision's own Plan is dispatched — there is
        no second planning pass between gate and queues."""
        if self.admission is None:
            self._dispatch(rec, now)
            return
        if state is None:
            state = self._snapshot(now)
        decision = self.admission.decide(rec.request, state)
        if decision.outcome == REJECT:
            self._shed(rec, decision.reason,
                       detail=f", est_wait={decision.est_wait_s:.3f}s")
            return
        rec.rejected = False
        if decision.outcome == DEGRADE:
            rec.degraded_admission = True
            rec.effective_request = decision.request
            self._log(f"rid={rec.request.rid} admitted DEGRADED "
                      f"(perf_req {rec.request.perf_req:.1f}->"
                      f"{decision.request.perf_req:.1f} items/s)")
        else:
            assert decision.outcome == ADMIT
        self._dispatch(rec, now, plan=decision.plan)

    def _shed(self, rec: RequestRecord, reason: str, detail: str = ""):
        """Terminal rejection: shared by the gate's REJECT outcome and
        the fair scheduler's expired-in-queue path. Accounting is
        identical either way — a shed is a failed SLO for the
        autoscaler, a settled record for the sharded root."""
        rec.rejected = True
        rec.reject_reason = reason
        rec.degraded_admission = False
        rec.effective_request = None
        if self.autoscaler is not None:
            # a shed is a failed SLO: it must push the autoscaler
            # toward capacity even though no queue ever saw it
            self.autoscaler.record_outcome(False)
        self._log(f"rid={rec.request.rid} REJECTED ({reason}{detail})")
        if self.on_settled is not None:
            self.on_settled(rec)

    def _fair_drain(self, now: float):
        """Release fair-queue requests to the gate in DRR order until
        the scheduler withholds (everything released, or the
        outstanding-items cap is full). A request whose whole latency
        budget burned while queued is shed without planning — the gate
        would reject it anyway, this just skips the wasted plan."""
        fs = self.fairshare
        assert fs is not None
        while True:
            req = fs.next_request()
            if req is None:
                return
            rec = self.records[req.rid]
            budget = req.latency_budget_s
            if budget != float("inf") and now - req.arrival_s >= budget:
                self._shed(rec, "fairshare_expired")
                continue
            self._admit(rec, now, None)
            if not rec.rejected:
                fs.on_admitted(req.tenant, req.num_items)

    def _autoscaler_ready(self, now: float) -> bool:
        return self.autoscaler is not None and self.autoscaler.ready(now)

    def _autoscale_tick(self, now: float,
                        state: Optional[ClusterState]):
        """Evaluate the autoscaler, reusing the event's ClusterState when
        one was already built; skip the snapshot entirely while the
        cooldown / warm-up guard would discard it unread."""
        if not self._autoscaler_ready(now):
            return
        if state is None:
            state = self._snapshot(now)
        action = self.autoscaler.evaluate(state)
        if action is None:
            return
        if action.kind == SPAWN:
            self._log(f"scale-up decided node={action.node} "
                      f"ready at t={action.ready_s:.3f}s ({action.reason})")
            self.events.push(action.ready_s, "node_up", node=action.node)
        else:
            self._log(f"scale-down node={action.node} ({action.reason})")
            # leave the serving set now; already-queued shares drain
            self.gn.handle(Event(kind="retire", node=action.node, time=now))

    def _node_up(self, node: str):
        """A spawned node finished warming up: PROFILE + join + serve."""
        now = self.clock.now
        self.gn.handle(Event(kind="spawn", node=node, time=now))
        if self.autoscaler is not None:
            self.autoscaler.on_ready(node)
        nq = self.nodes[node]
        nq.up = True
        self._log(f"node_up node={node} (warmed up, re-profiled)")
        self._maybe_start(nq)
        self._readmit_parked(now, "scale-up")

    def _readmit_parked(self, now: float, why: str):
        """Parked requests re-enter through the admission gate (token
        bucket included) when capacity returns — a scale-up or reconnect
        must not smuggle them past the shed/degrade accounting."""
        parked, self._parked = self._parked, []
        for req in parked:
            self._log(f"rid={req.rid} re-admitted after {why} "
                      "(through the gate)")
            self._admit(self.records[req.rid], now, None)

    # ---- dispatch & execution ---------------------------------------
    def _dispatch(self, rec: RequestRecord, now: float,
                  plan: Optional[Plan] = None):
        """GN re-enters DISTRIBUTE for this request; shares hit the queues.
        ``plan`` is the admission gate's own Plan when one exists — the GN
        commits it verbatim (plan-once); otherwise the GN plans here. A
        degraded admission dispatches its renegotiated copy (higher
        perf_req -> coarser apx levels), never the original."""
        try:
            if plan is None:
                # no-gate and re-DISTRIBUTE paths plan here; feed the
                # live backlogs so the Plan's finish/makespan predictions
                # stay exact even when the queues are busy
                plan = self.gn.plan(rec.effective_request or rec.request,
                                    now=now, backlogs=self._backlogs(now))
            else:
                self.gn.commit(plan)
        except RuntimeError:
            # every node down: park until a reconnect re-admits it
            self._parked.append(rec.request)
            self._log(f"rid={rec.request.rid} parked (no available nodes)")
            return
        d = plan.dispatch
        rec.epoch += 1
        rec.dispatch = d
        rec.plan = plan
        rec.dispatch_s = now
        if rec.first_dispatch_s < 0:
            rec.first_dispatch_s = now
        rec.per_node_time = {}
        rec.queue_wait_s = 0.0
        rec.pending_shares = sum(1 for a in d.assignments if a.items > 0)
        pred = self._share_pred
        version = self.backend.pred_version
        nodes = self.nodes
        batched = self._batched
        rid = rec.request.rid
        epoch = rec.epoch
        seq = self._share_seq
        for a in d.assignments:
            if a.items == 0:
                continue
            seq += 1
            share = _Share(share_id=seq, rid=rid,
                           epoch=epoch, assignment=a, enqueue_s=now)
            nq = nodes[a.node]
            nq.enqueue(share, pred, version)
            # enqueue-then-start, fused (idle-node fast path: the share
            # just enqueued is the head)
            if batched:
                self._maybe_start_batched(nq)
            elif nq.up and nq.running is None:
                self._start_next(nq)
        self._share_seq = seq

    def _maybe_start(self, nq: NodeRuntime):
        if self._batched:
            self._maybe_start_batched(nq)
            return
        if not nq.up or nq.running is not None or not nq.queue:
            return
        self._start_next(nq)

    def _start_next(self, nq: NodeRuntime):
        """Start the node's next queued share (caller checked up/idle/
        non-empty): pop, price, and schedule its completion."""
        share = nq.pop_next()
        share.start_s = self.clock.now
        share.service_s = self.backend.assignment_time(share.assignment)
        share.finish_s = share.start_s + share.service_s
        nq.running = share
        self.events.push(share.finish_s, "share_done", node=nq.name,
                         share_id=share.share_id)

    def _share_done(self, node: str, share_id: int):
        nq = self.nodes[node]
        share = nq.running
        if share is None or share.share_id != share_id:
            return                      # aborted by a disconnect: stale event
        nq.running = None
        self._complete_share(nq, share)
        self._maybe_start(nq)

    def _complete_share(self, nq: NodeRuntime, share: _Share):
        """Account one finished share against its request (shared by the
        sequential and the batched completion paths)."""
        rec = self.records[share.rid]
        if share.epoch == rec.epoch and not rec.done:
            rec.per_node_time[nq.name] = share.service_s
            rec.queue_wait_s = max(rec.queue_wait_s,
                                   share.start_s - rec.dispatch_s)
            rec.pending_shares -= 1
            if rec.pending_shares == 0:
                self._finalize(rec)
        # else: a share of a superseded dispatch generation — discard,
        # the node just paid the time.

    # ---- continuous batching (max_batch > 1) -------------------------
    def _form_op(self, nq: NodeRuntime) -> _BatchOp:
        """Form the next engine-batch op from the FIFO head: a coalesced
        full-run when the head share alone fills the cap (nothing could
        join those batches anyway), else a mixed/partial batch over the
        same-level FIFO prefix."""
        cap = self.batching.max_batch
        head = nq.queue[0]
        level = head.assignment.apx_level
        if head.unclaimed >= cap:
            n_full = head.unclaimed // cap
            return _BatchOp(op_id=0, level=level,
                            takes=[(head, n_full * cap)],
                            n_items=n_full * cap, batch_size=cap)
        if self.batching.tenant_cap > 0:
            return self._form_op_tenant_aware(nq, cap, level)
        takes = [(head, head.unclaimed)]
        total = head.unclaimed
        for s in itertools.islice(nq.queue, 1, None):
            if total >= cap:
                break
            if s.assignment.apx_level != level:
                break       # strict FIFO: never skip over a share
            # a joiner contributes at most its own tail remainder: taking
            # items out of a share's full engine batches would fragment
            # them into a new partial batch later — slower than the plan
            # priced, which the straggler EWMA would misread as a slow
            # node. Tail-only joins are a pure win for both shares.
            tail = s.unclaimed if s.unclaimed < cap else s.unclaimed % cap
            take = min(tail, cap - total)
            if take == 0:
                break       # clean multiple: nothing joinable in order
            takes.append((s, take))
            total += take
        return _BatchOp(op_id=0, level=level, takes=takes,
                        n_items=total, batch_size=min(total, cap))

    def _form_op_tenant_aware(self, nq: NodeRuntime, cap: int,
                              level: int) -> _BatchOp:
        """Mixed-batch formation with a per-tenant item cap: pass 1
        takes up to ``tenant_cap`` items per tenant over the same-level
        FIFO prefix (so a flooding tenant cannot fill the whole batch
        while another tenant's share waits right behind it); pass 2
        re-fills leftover slots in FIFO order *ignoring* the caps, so
        the cap never launches a smaller batch than the tenant-blind
        scheduler would (work conservation). The tail-only join rule is
        unchanged — a joiner contributes at most its own partial-batch
        remainder."""
        cap_t = self.batching.tenant_cap
        prefix: List[_Share] = []
        for s in nq.queue:
            if s.assignment.apx_level != level:
                break       # strict FIFO across levels, exactly as before
            prefix.append(s)
            if sum(p.unclaimed for p in prefix) >= cap + cap_t:
                break       # enough candidates to fill any batch shape

        def _tail(s: _Share) -> int:
            return s.unclaimed if s.unclaimed < cap else s.unclaimed % cap

        taken: Dict[int, int] = {}          # share_id -> items this op
        by_tenant: Dict[str, int] = {}
        total = 0
        for s in prefix:                    # pass 1: capped
            if total >= cap:
                break
            tenant = self.records[s.rid].request.tenant
            room = min(_tail(s), cap - total,
                       cap_t - by_tenant.get(tenant, 0))
            if room > 0:
                taken[s.share_id] = room
                by_tenant[tenant] = by_tenant.get(tenant, 0) + room
                total += room
        for s in prefix:                    # pass 2: work-conserving fill
            if total >= cap:
                break
            room = min(_tail(s) - taken.get(s.share_id, 0), cap - total)
            if room > 0:
                taken[s.share_id] = taken.get(s.share_id, 0) + room
                total += room
        takes = [(s, taken[s.share_id]) for s in prefix
                 if taken.get(s.share_id, 0) > 0]
        return _BatchOp(op_id=0, level=level, takes=takes,
                        n_items=total, batch_size=min(total, cap))

    def _maybe_start_batched(self, nq: NodeRuntime):
        if not nq.up or nq.active is not None or not nq.queue:
            return
        now = self.clock.now
        op = self._form_op(nq)
        oldest_wait = now - nq.queue[0].enqueue_s
        if not self.batching.ready(op.n_items, oldest_wait):
            # partial batch inside the formation window: hold it open
            # for joiners; the timer forces the launch if none arrive
            # (an arrival that fills the batch re-enters here first)
            nq.forming_token += 1
            self.events.push(
                self.batching.hold_until(nq.queue[0].enqueue_s),
                "batch_launch", node=nq.name, token=nq.forming_token)
            return
        self._launch_op(nq, op)

    def _launch_op(self, nq: NodeRuntime, op: _BatchOp):
        now = self.clock.now
        nq.forming_token += 1           # cancel any pending hold timer
        self._op_seq += 1
        op.op_id = self._op_seq
        op.start_s = now
        op.finish_s = now + self.backend.engine_batch_time(
            nq.name, op.level, op.n_items, op.batch_size)
        for share, _ in op.takes:
            if share.start_s < 0:
                share.start_s = now
        nq.claim(op.takes, self._share_pred)
        if self.sanitize:
            _sanitize.check_op_conservation(op, self.batching.max_batch)
        nq.active = op
        self.events.push(op.finish_s, "batch_done", node=nq.name,
                         op_id=op.op_id)

    def _batch_launch(self, node: str, token: int):
        """Formation-window expiry: launch the held partial batch."""
        nq = self.nodes[node]
        if token != nq.forming_token or nq.active is not None:
            return                      # superseded or already launched
        if not nq.up or not nq.queue:
            return
        self._launch_op(nq, self._form_op(nq))

    def _batch_done(self, node: str, op_id: int):
        nq = self.nodes[node]
        op = nq.active
        if op is None or op.op_id != op_id:
            return                      # aborted by a disconnect: stale event
        nq.active = None
        duration = op.finish_s - op.start_s
        for share, take in op.takes:
            # item-weighted attribution: each share pays for exactly the
            # slice of the op its items occupied
            share.service_s += duration * (take / op.n_items)
        for share in nq.settle(op):
            self._complete_share(nq, share)
        self._maybe_start(nq)

    def _finalize(self, rec: RequestRecord):
        now = self.clock.now
        rec.finish_s = now
        d = rec.dispatch
        # makespan_s = dispatch-to-finish span (queue wait included; offline
        # this equals the service makespan since all shares start at
        # dispatch). achieved_perf keeps the offline meaning — pure node
        # execution throughput — so perf_violation stays comparable across
        # paths; queueing pressure shows up in latency_s / meets_deadline.
        makespan = max(now - rec.dispatch_s, 1e-12)
        exec_makespan = max(rec.per_node_time.values(), default=1e-12)
        total = d.total_items
        # account against the *dispatched* request: for a degraded
        # admission that is the renegotiated contract (raised perf_req,
        # relaxed acc_req), so SLO metrics reflect what was promised
        result = ExecutionResult(
            request=d.request, policy=d.policy,
            achieved_perf=total / max(exec_makespan, 1e-12),
            achieved_acc=self.backend.dispatch_accuracy(d),
            makespan_s=makespan, per_node_time=dict(rec.per_node_time),
            arrival_s=rec.arrival_s, start_s=rec.dispatch_s,
            finish_s=now, queue_wait_s=rec.queue_wait_s)
        rec.result = result
        self.gn.complete(d, result)
        if self.autoscaler is not None:
            self.autoscaler.record_outcome(rec.meets_deadline)
        self._log(f"rid={rec.request.rid} done "
                  f"latency={rec.latency_s:.3f}s "
                  f"wait={rec.queue_wait_s:.3f}s "
                  f"{'OK' if rec.meets_deadline else 'DEADLINE-MISS'}")
        if self.on_settled is not None:
            self.on_settled(rec)
        if self.fairshare is not None:
            # settled items free outstanding capacity: let the ring
            # release the next round of fair-queue work immediately
            self.fairshare.on_done(rec.request.tenant,
                                   rec.request.num_items)
            self._fair_drain(now)

    # ---- faults ------------------------------------------------------
    def _disconnect(self, node: str):
        now = self.clock.now
        self.gn.handle(Event(kind="disconnect", node=node, time=now))
        nq = self.nodes[node]
        nq.up = False
        affected: List[int] = []

        def _current(s: _Share) -> bool:
            # a share of a superseded dispatch generation is dead work
            # already — losing it must not re-DISTRIBUTE the request again
            rec = self.records[s.rid]
            return s.epoch == rec.epoch and not rec.done

        if nq.running is not None:
            if _current(nq.running):
                affected.append(nq.running.rid)
            nq.running = None           # abort in-flight share
        if nq.active is not None:
            # abort the in-flight engine batch: every rider loses its
            # whole share (all-or-nothing, like the sequential abort) —
            # mid-batch re-DISTRIBUTE (paper Fig. 9, batched)
            for s, _ in nq.active.takes:
                if _current(s) and s.rid not in affected:
                    affected.append(s.rid)
            nq.active = None
        nq.forming_token += 1           # cancel any held formation
        for s in nq.queue:
            if _current(s) and s.rid not in affected:
                affected.append(s.rid)
        nq.clear_queue()
        self._log(f"disconnect node={node} "
                  f"({len(affected)} in-flight request(s) affected)")
        # Fig. 4 right edge: re-enter DISTRIBUTE over the survivors for
        # every request that lost a share, in arrival order.
        for rid in sorted(affected,
                          key=lambda r: self.records[r].arrival_s):
            rec = self.records[rid]
            if rec.done:
                continue
            for other in self.nodes.values():
                other.drop_rid(rid)     # cancel not-yet-started shares
            rec.redistributed += 1
            self._log(f"re-DISTRIBUTE rid={rid} over survivors "
                      f"(disconnect of {node})")
            self._dispatch(rec, now)

    def _reconnect(self, node: str):
        now = self.clock.now
        self.gn.handle(Event(kind="reconnect", node=node, time=now))
        self.nodes[node].up = True
        self._log(f"reconnect node={node}")
        self._maybe_start(self.nodes[node])
        self._readmit_parked(now, "reconnect")
