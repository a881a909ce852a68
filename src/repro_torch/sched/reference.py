"""Retained reference planners: the pre-vectorization implementations.

This module preserves the original planning code paths — per-element fancy
indexing in plan assembly, a Python remainder loop, per-node level
search loops, the O(rounds x n log n) rebuild-and-sort subset-sum DP,
and ``exact_oracle``'s per-call meshgrid enumeration — as the ground
truth the optimized planners in :mod:`repro_torch.sched.policies` are proven
against:

  * the seeded property test
    (``tests/test_sched_perf.py::test_plans_identical_to_reference``)
    asserts the optimized planners return Plans *identical* (assignments,
    levels, predicted makespan/accuracy) to these across random
    ClusterStates — the optimization only counts if the serving metrics
    are bit-stable;
  * ``benchmarks/bench_sched.py`` times these as the unoptimized baseline the
    plans/sec and events/sec speedups are measured against.

The one deliberate semantic change shared by both implementations: the
remainder distribution uses ``np.argsort(-perfs, kind="stable")``. The
pre-fix default (introsort) was already stable for the <=16-node
clusters every committed benchmark uses (numpy falls back to insertion
sort there) but platform-dependent beyond — equal-perf nodes must get
the remainder in index order on every platform, or fleet-scale runs
stop being reproducible.

Use ``resolve_policy("reference:<name>")`` (or :class:`ReferencePolicy`
directly) to plan with these.
"""
from __future__ import annotations

import types
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.profiling import batched_service_s
from repro_torch.core.requests import (Assignment, Dispatch, InferenceRequest)
from repro_torch.sched.plan import Plan
from repro_torch.sched.state import ClusterState


def _avail_ref(state: ClusterState) -> np.ndarray:
    idx = state.avail_idx
    if len(idx) == 0:
        raise RuntimeError("no available nodes")
    return idx


def _perf_ref(state: ClusterState) -> np.ndarray:
    """Pricing matrix: the batch curve at the runtime's engine-batch cap
    when batching is on (recomputed per call — the reference never
    caches), the scalar REF_BATCH matrix otherwise."""
    if not state.batched:
        return state.perf
    from repro_torch.core.profiling import interp_throughput
    return np.asarray(interp_throughput(state.perf_b, state.batch_grid,
                                        state.max_batch))


def _mk_plan_ref(state: ClusterState, request: InferenceRequest,
                 avail_idx: np.ndarray, levels: np.ndarray, policy: str,
                 shares: Optional[np.ndarray] = None,
                 meta: Optional[Mapping[str, object]] = None) -> Plan:
    """Original plan assembly: per-element gathers + Python remainder loop."""
    perf_m = _perf_ref(state)
    perfs = np.array([perf_m[levels[j], avail_idx[j]]
                      for j in range(len(avail_idx))])
    if shares is None:
        shares = (perfs / perfs.sum() if perfs.sum() > 0
                  else np.ones_like(perfs) / len(perfs))
    if state.batched:
        # the quantizer is shared, not reimplemented: it is plain
        # arithmetic with a fixed tie-break (see repro_torch.sched.split)
        from repro_torch.sched.split import quantized_batch_split
        items = np.asarray(quantized_batch_split(
            state, avail_idx, levels, shares, request.num_items))
    else:
        items = np.floor(request.num_items * shares).astype(int)
        # distribute the remainder to the fastest nodes
        rem = request.num_items - items.sum()
        order = np.argsort(-perfs, kind="stable")
        for i in range(rem):
            items[order[i % len(order)]] += 1
    assignments = tuple(
        Assignment(node=state.names[avail_idx[j]],
                   items=int(items[j]), apx_level=int(levels[j]),
                   perf_alloc=float(perfs[j]))
        for j in range(len(avail_idx)))
    dispatch = Dispatch(request=request, assignments=assignments,
                        policy=policy)

    now = state.now_s
    service: dict = {}
    finish: dict = {}
    for j, a in enumerate(assignments):
        if a.items == 0:
            continue                    # empty shares are never enqueued
        if state.batched:
            t = batched_service_s(a.items,
                                  state.perf_b[a.apx_level, avail_idx[j]],
                                  state.batch_grid, state.max_batch)
        else:
            t = a.items / max(a.perf_alloc, 1e-9)
        service[a.node] = t
        finish[a.node] = now + state.backlog_of(a.node) + t
    if state.batched:
        meta = dict(meta or {})
        meta["assumed_batch"] = state.max_batch
    exec_makespan = max(service.values(), default=0.0)
    finish_s = max(finish.values(), default=now)
    total_acc = sum(a.items * float(state.accuracies[a.apx_level])
                    for a in assignments)
    return Plan(
        dispatch=dispatch, policy=policy, created_s=now,
        node_service_s=types.MappingProxyType(service),
        node_finish_s=types.MappingProxyType(finish),
        exec_makespan_s=exec_makespan,
        makespan_s=finish_s - now, finish_s=finish_s,
        alloc_perf=float(perfs.sum()),
        predicted_acc=total_acc / max(request.num_items, 1),
        feasible=bool(perfs.sum() >= request.perf_req * (1 - 1e-9)),
        meta=types.MappingProxyType(dict(meta or {})))


def _uniform_ref(state: ClusterState, request: InferenceRequest) -> Plan:
    idx = _avail_ref(state)
    levels = np.zeros(len(idx), dtype=int)
    shares = np.ones(len(idx)) / len(idx)
    return _mk_plan_ref(state, request, idx, levels, "uniform", shares)


def _uniform_apx_ref(state: ClusterState, request: InferenceRequest,
                     margin: float = 0.02) -> Plan:
    idx = _avail_ref(state)
    n = len(idx)
    perf_m = _perf_ref(state)
    per_node = (request.perf_req / n) * (
        1.0 + margin + n / max(request.num_items, 1))
    levels = np.empty(n, dtype=int)
    for j, col in enumerate(idx):
        lv = state.num_levels - 1
        for m in range(state.num_levels):
            if perf_m[m, col] >= per_node:
                lv = m
                break
        levels[j] = lv
    shares = np.ones(n) / n
    return _mk_plan_ref(state, request, idx, levels, "uniform_apx", shares)


def _asymmetric_ref(state: ClusterState, request: InferenceRequest) -> Plan:
    idx = _avail_ref(state)
    caps = _perf_ref(state)[0, idx]
    shares = caps / caps.sum()
    levels = np.zeros(len(idx), dtype=int)
    return _mk_plan_ref(state, request, idx, levels, "asymmetric", shares)


def _proportional_ref(state: ClusterState, request: InferenceRequest,
                      margin: float = 0.02) -> Plan:
    idx = _avail_ref(state)
    pruned = _perf_ref(state)[:, idx]              # lines 3-5
    n = len(idx)
    target = request.perf_req * (
        1.0 + margin + n / max(request.num_items, 1))

    perf_vector = pruned.sum(axis=1)               # lines 6-7
    cutoff = state.num_levels - 1
    for m in range(state.num_levels):
        if perf_vector[m] >= target:               # line 8
            cutoff = m
            break
    pruned = pruned[:cutoff + 1]                   # lines 10-11

    perf_b_req = target * pruned[0] / perf_vector[0]   # lines 12-13

    levels = subset_sum_dp_ref(pruned, perf_b_req, target)  # line 14
    return _mk_plan_ref(state, request, idx, levels, "proportional")


def subset_sum_dp_ref(pruned: np.ndarray, perf_b_req: np.ndarray,
                      perf_req: float) -> np.ndarray:
    """Original DP_alg: rebuild + stable-sort the candidate list every round,
    lift the first board whose loss keeps the cluster feasible."""
    m, n = pruned.shape
    levels = np.full(n, m - 1, dtype=int)
    total = pruned[m - 1].sum()
    if total < perf_req:
        # infeasible even at the deepest remaining approximation:
        # best-effort max-throughput (no lifting)
        return levels

    improved = True
    while improved:
        improved = False
        # candidate lifts: (throughput loss, board) — lift cheapest first,
        # preferring boards furthest above their per-board target
        cands = []
        for j in range(n):
            if levels[j] == 0:
                continue
            cur = pruned[levels[j], j]
            up = pruned[levels[j] - 1, j]
            loss = cur - up
            slack = cur - perf_b_req[j]
            cands.append((loss - slack, loss, j))
        for _, loss, j in sorted(cands, key=lambda t: t[0]):
            if total - loss >= perf_req:
                levels[j] -= 1
                total -= loss
                improved = True
                break
    return levels


def _exact_oracle_ref(state: ClusterState, request: InferenceRequest,
                      max_enum_nodes: int = 7) -> Plan:
    import dataclasses

    idx = _avail_ref(state)
    pruned = _perf_ref(state)[:, idx]
    acc = state.accuracies
    m, n = pruned.shape
    if n > max_enum_nodes:
        fb = _proportional_ref(state, request)
        return dataclasses.replace(
            fb,
            dispatch=Dispatch(request=fb.dispatch.request,
                              assignments=fb.dispatch.assignments,
                              policy="exact_oracle"),
            policy="exact_oracle",
            meta=types.MappingProxyType(
                {"fallback": "proportional",
                 "reason": f"n={n} > max_enum_nodes={max_enum_nodes}"}))

    grids = np.meshgrid(*([np.arange(m)] * n), indexing="ij")
    combos = np.stack([g.reshape(-1) for g in grids], axis=1)  # (m^n, n)
    perfs = pruned[combos, np.arange(n)[None, :]]              # (m^n, n)
    total = perfs.sum(axis=1)
    wacc = (perfs * acc[combos]).sum(axis=1) / total
    feasible = total >= request.perf_req * 1.02
    if feasible.any():
        cand = np.where(feasible)[0]
        # max accuracy; tie-break on max throughput
        best = cand[np.lexsort((-total[cand], -wacc[cand]))[0]]
    else:
        best = int(np.argmax(total))
    levels = combos[best]
    return _mk_plan_ref(state, request, idx, levels.astype(int),
                        "exact_oracle")


_REFERENCE_PLANNERS = {
    "uniform": _uniform_ref,
    "uniform_apx": _uniform_apx_ref,
    "asymmetric": _asymmetric_ref,
    "proportional": _proportional_ref,
    "exact_oracle": _exact_oracle_ref,
}


class ReferencePolicy:
    """Policy adapter over the retained reference planners.

    ``resolve_policy("reference:proportional")`` (and therefore
    ``GatewayNode(policy="reference:proportional")`` or ``run_sim.py
    --policies reference:proportional``) routes planning through the
    unoptimized implementation — the equivalence goldens and the bench's
    baseline rows both lean on this.
    """

    def __init__(self, inner: str, **kwargs):
        if inner not in _REFERENCE_PLANNERS:
            raise KeyError(f"no reference planner for {inner!r}; "
                           f"have {sorted(_REFERENCE_PLANNERS)}")
        self.inner = inner
        self.kwargs = kwargs
        self.name = inner               # Plans/Dispatches label as the
        #                                 real policy, so reports line up

    def plan(self, state: ClusterState, request: InferenceRequest) -> Plan:
        return _REFERENCE_PLANNERS[self.inner](state, request,
                                               **self.kwargs)
