"""Sharded control-plane simulator: per-cell gateways behind a root router.

The unsharded :class:`OnlineSimulator` is one gateway planning every
request over the whole fleet — O(levels x nodes) per plan, every share
fanning onto every available node, one snapshot cache, one admission
bucket, one autoscaler. This module splits that into **cells** (see
``repro_torch.sched.shard``): each cell is a complete single-gateway stack —
its own ProfilingTable slice, GatewayNode, SimBackend, admission gate
and autoscaler — and the root here only (a) routes each arrival to one
cell and (b) merges the per-cell event queues into a single global
(time, seq) order, so the simulation is still one deterministic
discrete-event run.

``cells=1`` byte-identity
-------------------------
A 1-cell sharded run must be *indistinguishable* from the unsharded
simulator — same records, same log lines, same event count — so the
sharding layer can never silently change serving behaviour. The merge
is built around seq-number bookkeeping that makes this exact:

  * The unsharded constructor assigns arrival i seq i (push order) and
    fault f seq A+f; dynamic events (share/batch completions, timers,
    node_up) take A+F, A+F+1, ... as they are scheduled.
  * Here, arrival i is *pre-assigned* seq i and pushed only when the
    root routes it; fault f is pre-assigned seq A+f and pushed into its
    owner cell up front; and every cell's EventQueue draws dynamic seqs
    from one shared :class:`SeqCounter` starting at A+F.
  * The root's loop pops the globally smallest (time, seq) among all
    cell queue heads and the next unrouted arrival. Seqs are globally
    unique, so the order is total — and with one cell it is exactly the
    heap order the unsharded loop would have followed.

The hot loop (:meth:`ShardedSimulator.run`) realizes that order with an
indexed min-heap over the cell queue heads plus **batched run-draining**:
once a cell holds the global minimum, its events are popped in a tight
inner loop (``OnlineSimulator.process_run``) for as long as its head key
stays below every other cell head, the next unrouted arrival, and the
next rebalance tick — handling an event only ever schedules follow-ups
into the *same* cell's queue, so no other merge candidate can move while
a run is in flight and the pop order is byte-identical to the per-event
merge. :meth:`ShardedSimulator.run_reference` retains that per-event
merge as the bit-identity twin (the ``reference:`` pattern from
``repro_torch.sched.reference``); ``tests/test_torch_sim.py`` pins the
two against each other. The reference package's ``sim/README.md``
(§"Root merge loop") describes it.

Routing happens at the arrival's own timestamp (it is routed only once
it is the global minimum), so least-backlog decisions see the same
outstanding-work state a real front-end would at that instant.

Rebalancing: every ``rebalance_s`` sim-seconds (multi-cell only) the
root compares the router's normalized per-cell loads and, past
``steal_threshold_s`` of divergence, moves one *pooled* standby node
from the calmest cell's autoscaler to the hottest's
(``release_standby``/``adopt_standby``). Cell tables carry every standby
column regardless of ownership, so adoption needs no re-profiling, and a
rebalance consumes no event seqs — determinism and the ``cells=1``
guarantee are unaffected.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.control.admission import AdmissionController
from repro_torch.control.autoscaler import Autoscaler, ScalingAction
from repro_torch.control.fairshare import FairShareScheduler
from repro_torch.core.cluster import SimBackend
from repro_torch.core.profiling import ProfilingTable
from repro_torch.core.requests import InferenceRequest
from repro_torch.core.resource_manager import GatewayNode
from repro_torch.sched.shard import (CellRouter, CellSpec, partition_fleet,
                               pick_rebalance)
from repro_torch.sim import events_reference
from repro_torch.sim.events import EventQueue, SeqCounter
from repro_torch.sim.simulator import (OnlineSimulator, RequestRecord, SimReport,
                                 TimedFault)


def _scaling_order(action: ScalingAction) -> Tuple[float, str]:
    """Merge order for per-cell autoscaler action logs: decision time,
    node name as the deterministic tie-break (cells act independently,
    so same-instant actions have no inherent order)."""
    return (action.decided_s, action.node)


class ShardedSimulator:
    """Root router + merged event loop over per-cell OnlineSimulators.

    ``table_factory(profiles) -> ProfilingTable`` builds each cell's
    table from its NodeProfile slice — the caller owns pool/seq_len
    choices, and using the same factory that built the full table makes
    the 1-cell table column-identical to the unsharded one. ``profiles``
    is the *full* fleet in table order (``available=False`` entries are
    the standby pool); each cell's slice keeps its serving nodes plus
    every standby column (so cross-cell adoption needs no re-profiling),
    all in original order.
    """

    MAX_EVENTS = OnlineSimulator.MAX_EVENTS

    def __init__(self,
                 table_factory: Callable[[Sequence], ProfilingTable],
                 profiles: Sequence,
                 arrivals: Sequence[Tuple[float, InferenceRequest]],
                 faults: Sequence[TimedFault] = (), *,
                 cells: int = 1,
                 strategy: str = "stripe",
                 router: str = "least-backlog",
                 policy: str = "proportional",
                 seed: int = 0,
                 noise_std: float = 0.0,
                 scenario: str = "custom",
                 horizon_s: float = 0.0,
                 admission: bool = False,
                 admission_rate: Optional[float] = None,
                 admission_burst: float = 8.0,
                 admission_tenant_rates: Optional[Dict[str, float]] = None,
                 autoscale: bool = False,
                 max_batch: int = 1,
                 formation_window_s: float = 0.0,
                 fairshare: bool = False,
                 fairshare_weights: Optional[Dict[str, float]] = None,
                 fairshare_quantum: int = 1024,
                 rebalance_s: float = 0.0,
                 steal_threshold_s: float = 1.0,
                 reference_stack: bool = False):
        # reference_stack=True builds every cell on the retained pre-slab
        # stack: events_reference.EventQueue instead of the slab queue,
        # and plan reuse disabled on every planner (gateway + gate), with
        # every cell dispatching through OnlineSimulator._handle_reference.
        # tests/test_torch_sim.py pins the fast stack's event stream
        # byte-identically against this one.
        self.scenario = scenario
        self.horizon_s = horizon_s or (
            max((t for t, _ in arrivals), default=0.0))
        self.rebalance_s = rebalance_s
        self.steal_threshold_s = steal_threshold_s
        # root-level trace validation (the cells see empty traces, so the
        # unsharded constructor's checks move here). The time-sorted
        # check is the merge-loop precondition — pre-assigned seq i for
        # arrival i only yields the unsharded heap order, and the
        # run-draining bound on the next unrouted arrival only holds, if
        # the trace is time-sorted — asserted once over the whole trace
        # here so the merge loop never re-checks it per event.
        self._arrivals = list(arrivals)
        times = [t for t, _ in self._arrivals]
        assert all(a <= b for a, b in zip(times, times[1:])), (
            "arrival trace must be time-sorted for the sharded merge")
        seen_rids = set()
        for t, req in self._arrivals:
            assert abs(req.arrival_s - t) < 1e-9, (
                f"request {req.rid}: arrival_s={req.arrival_s} disagrees "
                f"with its scheduled arrival time {t}")
            assert req.rid not in seen_rids, (
                f"duplicate rid {req.rid} in arrival trace; records and "
                "share accounting are keyed by rid")
            seen_rids.add(req.rid)

        self.specs: List[CellSpec] = partition_fleet(
            profiles, cells, strategy)
        n_arr, n_faults = len(self._arrivals), len(faults)
        counter = SeqCounter(n_arr + n_faults)
        queue_cls = (events_reference.EventQueue if reference_stack
                     else EventQueue)
        standby_set = {p.name for p in profiles if not p.available}
        owner: Dict[str, int] = {}
        capacities: List[float] = []
        self.cells: List[OnlineSimulator] = []
        for spec in self.specs:
            members = set(spec.nodes) | standby_set
            cell_profiles = [dataclasses.replace(p)
                             for p in profiles if p.name in members]
            ctable = table_factory(cell_profiles)
            backend = SimBackend(ctable, noise_std=noise_std,
                                 seed=seed + spec.cell_id)
            gn = GatewayNode(ctable, backend, policy=policy,
                             max_batch=max_batch)
            adm = None
            if admission:
                # one bucket per cell at a 1/cells slice of the root
                # refill budget: the fleet-wide admission rate stays the
                # configured one, and cells=1 keeps the exact rate.
                # Per-tenant rates split the same way — a tenant's
                # fleet-wide contract is the sum of its per-cell slices.
                rate = None
                if admission_rate is not None and admission_rate > 0:
                    rate = admission_rate / len(self.specs)
                trates = None
                if admission_tenant_rates:
                    trates = {t: r / len(self.specs)
                              for t, r in admission_tenant_rates.items()}
                adm = AdmissionController(ctable, rate=rate,
                                          burst=admission_burst,
                                          tenant_rates=trates,
                                          plan_cache=not reference_stack)
            asc = None
            if autoscale:
                # constructed even when this cell drew no standby nodes:
                # an empty pool can still adopt stolen reserve later
                asc = Autoscaler(ctable, list(spec.standby))
            fss = None
            if fairshare:
                # one DRR ring per cell: fair release is decided against
                # the backlog the owning cell actually serves, so a
                # tenant hot in one cell cannot slow its victims in
                # another. Off (the default) adds nothing to the cell —
                # the cells=1 byte-identity guarantee is untouched.
                fss = FairShareScheduler(fairshare_weights,
                                         quantum_items=fairshare_quantum)
            if reference_stack:
                reuse = getattr(gn.policy_obj, "_reuse", None)
                if reuse is not None:
                    reuse.enabled = False
            cell = OnlineSimulator(
                gn, (), (), scenario=scenario, horizon_s=self.horizon_s,
                admission=adm, autoscaler=asc, fairshare=fss,
                formation_window_s=formation_window_s,
                event_queue=queue_cls(counter))
            if reference_stack:
                # the reference drain also dispatches through the
                # retained pre-fusion if/elif chain, so the twin covers
                # slab + fusion + reuse together
                cell._handle = cell._handle_reference
            cell.on_settled = (
                lambda rec, c=spec.cell_id: self._settled(c, rec))
            self.cells.append(cell)
            for name in spec.nodes + spec.standby:
                owner[name] = spec.cell_id
            # capacity proxy exactly proportional to level-0 throughput
            # under the roofline model (see CellRouter docstring)
            serving = set(spec.nodes)
            capacities.append(sum(p.chips * p.capability
                                  for p in profiles if p.name in serving))
        self.router = CellRouter(self.specs, policy=router,
                                 capacities=capacities)
        # faults go to their owner cell up front with the seq numbers the
        # unsharded constructor would have assigned (A..A+F-1), chunked
        # per owner cell (one heapify per cell instead of F sift-downs;
        # push_chunk preserves the pre-assigned seqs exactly)
        fault_chunks: Dict[int, List] = collections.defaultdict(list)
        for fi, f in enumerate(faults):
            if f.node not in owner:
                raise ValueError(f"fault targets unknown node {f.node!r}")
            fault_chunks[owner[f.node]].append(
                (f.time, n_arr + fi, f.kind,
                 {"node": f.node, "slowdown": f.slowdown}))
        for c, chunk in fault_chunks.items():
            self.cells[c].events.push_chunk(chunk)
        self.routed_cell: Dict[int, int] = {}     # rid -> cell id
        self.rebalances: List[Tuple[float, str, int, int]] = []
        self._root_log: List[str] = []

    # ---- router feedback ----------------------------------------------
    def _settled(self, cell_id: int, rec: RequestRecord):
        self.router.settle(cell_id, rec.request.num_items,
                           tenant=rec.request.tenant)

    # ---- rebalancing ---------------------------------------------------
    def _do_rebalance(self, now: float):
        loads = self.router.loads()
        move = pick_rebalance(loads, min_gap=self.steal_threshold_s)
        if move is None:
            return
        src, dst = move
        src_asc = self.cells[src].autoscaler
        dst_asc = self.cells[dst].autoscaler
        if src_asc is None or dst_asc is None:
            return
        node = src_asc.release_standby()
        if node is None:
            return
        dst_asc.adopt_standby(node)
        self.rebalances.append((now, node, src, dst))
        self._root_log.append(
            f"t={now:10.3f}s  [root] rebalance standby={node} "
            f"cell{src}->cell{dst} "
            f"(load {loads[src]:.3f}s -> {loads[dst]:.3f}s)")

    # ---- main loop -----------------------------------------------------
    def _overflow(self, n_events: int) -> RuntimeError:
        """Diagnosable MAX_EVENTS overflow: which run blew up, how many
        cells were merging, and where each cell's clock had advanced —
        enough to tell a runaway self-scheduling cell from a trace that
        is simply too long for the cap."""
        clocks = ", ".join(f"cell{i}={cell.clock.now:.3f}s"
                           for i, cell in enumerate(self.cells))
        return RuntimeError(
            f"sharded simulator exceeded MAX_EVENTS={self.MAX_EVENTS} "
            f"(n_events={n_events}, cells={len(self.cells)}, "
            f"per-cell clock.now: {clocks})")

    def run(self) -> SimReport:
        """Merged event loop: indexed min-heap over cell queue heads
        with lazy head revalidation, plus batched run-draining — the
        root pays merge cost per *run* of events instead of per event.
        The pop order (and therefore every record, log line, and digest)
        is byte-identical to :meth:`run_reference`, the retained
        per-event merge twin; see the module docstring for why runs
        cannot reorder events."""
        for cell in self.cells:
            if not cell.gn._profiled:
                cell.gn.startup()
        t0 = time.perf_counter()  # detlint: ok[DET001] wall_s telemetry only; excluded from the golden digests
        arr = self._arrivals
        n_arr = len(arr)
        ai = 0
        n_events = 0
        cells = self.cells
        multi = len(cells) > 1
        max_events = self.MAX_EVENTS
        next_reb = (self.rebalance_s
                    if (multi and self.rebalance_s > 0) else float("inf"))
        route = self.router.route
        routed_cell = self.routed_cell
        heappop = heapq.heappop
        heappush = heapq.heappush
        # indexed min-heap over the cell queue heads: entries are
        # (time, seq, cell_id, version). Only the cell being drained (or
        # routed into) can change its head — handling an event schedules
        # follow-ups into the same cell's queue only — so entries for
        # every *other* cell stay exact, and staleness is tracked with a
        # per-cell version counter: bumping ver[c] retires c's entry
        # wherever it sits in the heap (lazy revalidation — it is
        # discarded when it surfaces, never searched for).
        ver = [0] * len(cells)
        heads = []
        for c, cell in enumerate(cells):
            if cell.events:
                t, s = cell.events.peek_key()
                heads.append((t, s, c, 0))
        heapq.heapify(heads)

        def fresh_top():
            while heads:
                e = heads[0]
                if e[3] == ver[e[2]]:
                    return e
                heappop(heads)          # stale: its cell re-pushed below
            return None

        while True:
            top = fresh_top()
            take_arrival = ai < n_arr and (
                top is None or (arr[ai][0], ai) < (top[0], top[1]))
            if top is None and not take_arrival:
                break
            next_t = arr[ai][0] if take_arrival else top[0]
            if next_t >= next_reb:
                self._do_rebalance(next_reb)
                next_reb += self.rebalance_s
                continue
            if take_arrival:
                t, req = arr[ai]
                c = route(req)
                routed_cell[req.rid] = c
                cell = cells[c]
                # pre-assigned seq: exactly what the unsharded
                # constructor would have given this arrival. It is the
                # global minimum right now, so it pops immediately; the
                # routed cell's heap entry (if any) goes stale.
                cell.events.push(t, "arrival", _seq=ai, request=req)
                ai += 1
                ver[c] += 1
                cell.process_next()
                n_events += 1
            else:
                heappop(heads)          # the winner; live per fresh_top
                c = top[2]
                cell = cells[c]
            # run-draining: pop this cell's events in a tight inner loop
            # while its head key stays below every other cell head, the
            # next unrouted arrival, and the next rebalance tick (events
            # at exactly the tick must wait for the rebalance, hence the
            # -1 sentinel seq)
            nxt = fresh_top()
            bound = (next_reb, -1)
            if nxt is not None and (nxt[0], nxt[1]) < bound:
                bound = (nxt[0], nxt[1])
            if ai < n_arr and (arr[ai][0], ai) < bound:
                bound = (arr[ai][0], ai)
            n_events += cell.process_run(bound, max_events + 1 - n_events)
            if n_events > max_events:
                raise self._overflow(n_events)
            if cell.events:
                t, s = cell.events.peek_key()
                # detlint: ok[DET003] root head-index over per-cell EventQueue heads: (t, s) is a queue head's own (time, seq) key, seqs globally unique via the shared SeqCounter
                heappush(heads, (t, s, c, ver[c]))
        wall_s = time.perf_counter() - t0  # detlint: ok[DET001] wall_s telemetry only; excluded from the golden digests
        return self._report(n_events, wall_s, multi)

    def run_reference(self) -> SimReport:
        """Per-event reference merge — the retained pre-optimization
        twin of :meth:`run` (the ``reference:`` pattern from
        ``repro_torch.sched.reference``): a linear O(cells) scan over every
        cell queue head per event, one pop per iteration. Kept verbatim
        so ``tests/test_torch_sim.py`` can pin run-draining's event
        stream against it on identical traffic."""
        for cell in self.cells:
            if not cell.gn._profiled:
                cell.gn.startup()
        t0 = time.perf_counter()  # detlint: ok[DET001] wall_s telemetry only; excluded from the golden digests
        arr = self._arrivals
        ai = 0
        n_events = 0
        multi = len(self.cells) > 1
        next_reb = (self.rebalance_s
                    if (multi and self.rebalance_s > 0) else float("inf"))
        while True:
            # global (time, seq) minimum over every cell queue head and
            # the next unrouted arrival — O(cells) per event, the entire
            # per-event cost the root adds
            best_cell: Optional[OnlineSimulator] = None
            best_key: Optional[Tuple[float, int]] = None
            for cell in self.cells:
                if cell.events:
                    ev = cell.events.peek()
                    key = (ev.time, ev.seq)
                    if best_key is None or key < best_key:
                        best_cell, best_key = cell, key
            arr_key = (arr[ai][0], ai) if ai < len(arr) else None
            if best_key is None and arr_key is None:
                break
            take_arrival = best_key is None or (
                arr_key is not None and arr_key < best_key)
            next_t = arr_key[0] if take_arrival else best_key[0]
            if next_t >= next_reb:
                self._do_rebalance(next_reb)
                next_reb += self.rebalance_s
                continue
            if take_arrival:
                t, req = arr[ai]
                c = self.router.route(req)
                self.routed_cell[req.rid] = c
                # pre-assigned seq: exactly what the unsharded
                # constructor would have given this arrival. It is the
                # global minimum right now, so it pops next iteration.
                self.cells[c].events.push(t, "arrival", _seq=ai,
                                          request=req)
                ai += 1
                continue
            best_cell.process_next()
            n_events += 1
            if n_events > self.MAX_EVENTS:
                raise self._overflow(n_events)
        wall_s = time.perf_counter() - t0  # detlint: ok[DET001] wall_s telemetry only; excluded from the golden digests
        return self._report(n_events, wall_s, multi)

    # ---- report assembly -----------------------------------------------
    def _report(self, n_events: int, wall_s: float,
                multi: bool) -> SimReport:
        records: Dict[int, RequestRecord] = {}
        for cell in self.cells:
            records.update(cell.records)
        scaling: List[ScalingAction] = []
        for cell in self.cells:
            if cell.autoscaler is not None:
                scaling.extend(cell.autoscaler.actions)
        # Counter.update keeps first-seen key insertion order, exactly
        # like the hand-rolled dict.get loop it replaces — the digest
        # over the cells=1 report hashes that order
        admission_counts: collections.Counter = collections.Counter()
        for cell in self.cells:
            if cell.admission is not None:
                admission_counts.update(cell.admission.counts)
        # per-cell planners are distinct objects (fresh policy instance
        # per cell), so summing the per-cell deduped counts is exact
        plan_hits = plan_misses = 0
        for cell in self.cells:
            h, m = cell.plan_cache_counts()
            plan_hits += h
            plan_misses += m
        if multi:
            log = [f"[cell{i}] {line}"
                   for i, cell in enumerate(self.cells)
                   for line in cell.log]
            log.extend(self._root_log)
            scaling.sort(key=_scaling_order)
        else:
            # cells=1: no prefix, no root lines, original action order —
            # the report is byte-identical to the unsharded simulator's
            log = list(self.cells[0].log)
        return SimReport(
            policy=self.cells[0].gn.policy, scenario=self.scenario,
            horizon_s=self.horizon_s,
            records=[records[k] for k in sorted(records)],
            log=log, scaling=scaling,
            admission_counts=dict(admission_counts),
            end_s=max(cell.clock.now for cell in self.cells),
            n_events=n_events, wall_s=wall_s,
            plan_cache_hits=plan_hits, plan_cache_misses=plan_misses)

    # ---- introspection --------------------------------------------------
    def plans_made(self) -> int:
        """Total planning passes across cells. Gated cells plan once per
        admission decision (the decision's plan is committed verbatim on
        admit — plan-once) plus once per re-DISTRIBUTE; ungated cells
        plan once per dispatch plus re-DISTRIBUTEs. Each pass is
        O(levels x cell nodes) now instead of O(levels x fleet) — the
        core of the sharded speedup."""
        total = 0
        for cell in self.cells:
            total += sum(rec.redistributed
                         for rec in cell.records.values())
            if cell.admission is not None:
                total += sum(cell.admission.counts.values())
            else:
                total += sum(not rec.rejected
                             for rec in cell.records.values())
        return total
