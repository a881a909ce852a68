"""Immutable cluster-state snapshot consumed by every scheduling policy.

A ``ClusterState`` is everything a :class:`~repro_torch.sched.policy.Policy`
is allowed to know at planning time, frozen at one sim-clock instant:

  * the profiling view (per-node throughput at each approximation level,
    accuracy ladder) — a *copy* of the live ProfilingTable, so a policy
    can never mutate the table through a side channel;
  * node membership: names, availability mask, and the standby set the
    autoscaler holds in reserve;
  * per-node queue backlog in predicted seconds of work — the signal the
    admission gate and the autoscaler feed on;
  * the snapshot time on the sim clock.

CoEdge/QPART frame partitioning as an optimization over exactly this kind
of explicit state object; adopting that shape is what lets the admission
gate reuse the policy's own plan instead of re-deriving feasibility with
a parallel heuristic (see repro/sched/README.md).
"""
from __future__ import annotations

import dataclasses
import itertools
import types
from typing import FrozenSet, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.profiling import (BATCH_GRID, ProfilingTable,
                                  interp_throughput)


def _frozen_array(a: np.ndarray) -> np.ndarray:
    out = np.array(a, dtype=np.float64, copy=True)
    out.flags.writeable = False
    return out


@dataclasses.dataclass(frozen=True)
class ClusterState:
    """One immutable snapshot of the serving cluster.

    ``perf[m, j]`` is node j's throughput (items/s) at approximation
    level m (0 = most accurate); ``backlog_s[name]`` is the predicted
    seconds of queued + running work ahead of a share enqueued now
    (absent names mean an empty queue). All arrays are read-only copies.
    """
    now_s: float
    names: Tuple[str, ...]
    available: Tuple[bool, ...]
    perf: np.ndarray                     # (levels, nodes), read-only
    accuracies: np.ndarray               # (levels,), read-only
    backlog_s: Mapping[str, float]
    standby: FrozenSet[str] = frozenset()
    # Opaque hashable token identifying the profiling view, set by
    # SnapshotCache as (cache instance, table version) so two tables can
    # never alias. Planner memo caches key on (perf_version, available);
    # None (the from_table default) disables memoization — correct, just
    # cold — so a hand-built snapshot can never hit a stale cache line.
    perf_version: Optional[Tuple[int, int]] = None
    # Batch-curve view: perf_b[m, j, bi] is node j's throughput at
    # approximation m when the engine serves batches of batch_grid[bi]
    # items; ``perf`` is the curve's REF_BATCH column. max_batch is the
    # engine-batch cap the node runtime serves with — 1 (the default)
    # means batching is off and every policy prices with ``perf``
    # exactly as before the batch-aware runtime existed.
    perf_b: Optional[np.ndarray] = None  # (levels, nodes, batches), r/o
    batch_grid: Tuple[int, ...] = BATCH_GRID
    max_batch: int = 1

    def __post_init__(self):
        assert self.perf.shape == (len(self.accuracies), len(self.names))
        assert len(self.available) == len(self.names)
        if self.perf_b is not None:
            assert self.perf_b.shape == self.perf.shape + (
                len(self.batch_grid),)

    @classmethod
    def from_table(cls, table: ProfilingTable, *, now: float = 0.0,
                   backlogs: Optional[Mapping[str, float]] = None,
                   standby: Tuple[str, ...] = (),
                   max_batch: int = 1) -> "ClusterState":
        """Snapshot a live ProfilingTable (+ queue backlogs) at ``now``."""
        return cls(
            now_s=now,
            names=tuple(n.name for n in table.nodes),
            available=tuple(bool(n.available) for n in table.nodes),
            perf=_frozen_array(table.perf),
            accuracies=_frozen_array(table.accuracies),
            backlog_s=types.MappingProxyType(dict(backlogs or {})),
            standby=frozenset(standby),
            perf_b=_frozen_array(table.perf_b),
            batch_grid=table.batch_grid,
            max_batch=max_batch)

    # ---- views --------------------------------------------------------
    @property
    def num_levels(self) -> int:
        return self.perf.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.perf.shape[1]

    @property
    def avail_idx(self) -> np.ndarray:
        """Column indices of the available (serving) nodes. Computed once
        per snapshot (cached on the instance; SnapshotCache pre-seeds it
        so steady-state events share one array across snapshots)."""
        idx = self.__dict__.get("_avail_idx")
        if idx is None:
            idx = np.array([j for j, a in enumerate(self.available) if a],
                           dtype=int)
            idx.flags.writeable = False
            # detlint: ok[DET004] memo-cache fill: value is a pure function of frozen fields, identical on any interleaving
            object.__setattr__(self, "_avail_idx", idx)
        return idx

    @property
    def available_perf(self) -> np.ndarray:
        """Pruned profiling view: perf columns of available nodes only
        (the paper's lines 3-5 prune of disconnected boards)."""
        pruned = self.__dict__.get("_avail_perf")
        if pruned is None:
            pruned = self.perf[:, self.avail_idx]
            # detlint: ok[DET004] memo-cache fill: value is a pure function of frozen fields, identical on any interleaving
            object.__setattr__(self, "_avail_perf", pruned)
        return pruned

    @property
    def plan_key(self) -> Optional[Tuple[object, Tuple[bool, ...], int]]:
        """Memo-key prefix for planner caches: everything a plan reads
        besides the request — the profiling view identity (table version),
        the serving mask, and the engine-batch cap the plan prices at.
        None when the snapshot has no version (hand-built), which
        disables memoization. Cached on the instance: the planners and
        the plan-reuse cache read it once or more per arrival, and the
        tuple build is pure over frozen fields."""
        if self.perf_version is None:
            return None
        key = self.__dict__.get("_plan_key")
        if key is None:
            key = (self.perf_version, self.available, self.max_batch)
            # detlint: ok[DET004] memo-cache fill: value is a pure function of frozen fields, identical on any interleaving
            object.__setattr__(self, "_plan_key", key)
        return key

    @property
    def batched(self) -> bool:
        """Batch-aware pricing active? Requires a batch cap above 1 and
        a batch-curve view to price with."""
        return self.max_batch > 1 and self.perf_b is not None

    @property
    def eff_perf(self) -> np.ndarray:
        """The (levels, nodes) throughput matrix at the engine batch the
        runtime sustains when saturated (``max_batch``); equals ``perf``
        when batching is off. Cached on the instance (SnapshotCache
        pre-seeds it so steady-state events share one array)."""
        if not self.batched:
            return self.perf
        eff = self.__dict__.get("_eff_perf")
        if eff is None:
            eff = np.asarray(interp_throughput(
                self.perf_b, self.batch_grid, self.max_batch))
            eff.flags.writeable = False
            # detlint: ok[DET004] memo-cache fill: value is a pure function of frozen fields, identical on any interleaving
            object.__setattr__(self, "_eff_perf", eff)
        return eff

    @property
    def available_eff_perf(self) -> np.ndarray:
        """``eff_perf`` pruned to the available columns."""
        if not self.batched:
            return self.available_perf
        pruned = self.__dict__.get("_avail_eff_perf")
        if pruned is None:
            pruned = self.eff_perf[:, self.avail_idx]
            # detlint: ok[DET004] memo-cache fill: value is a pure function of frozen fields, identical on any interleaving
            object.__setattr__(self, "_avail_eff_perf", pruned)
        return pruned

    def service_s(self, items: int, level: int, col: int) -> float:
        """Predicted service seconds of an ``items``-item share at
        ``level`` on node column ``col`` — the batch-aware engine-batch
        decomposition when batching is on, the scalar division when off.
        This is the single predictor plans, the admission gate, and the
        node runtime all agree on."""
        if items <= 0:
            return 0.0
        if not self.batched:
            return items / max(float(self.perf[level, col]), 1e-9)
        from repro_torch.core.profiling import batched_service_s
        return batched_service_s(items, self.perf_b[level, col],
                                 self.batch_grid, self.max_batch)

    def capacity(self, level: int = -1) -> float:
        """Cluster items/s over available nodes at ``level`` (default:
        the deepest approximation — the feasibility ceiling). Prices at
        the runtime's sustained engine batch when batching is on."""
        idx = self.avail_idx
        if len(idx) == 0:
            return 0.0
        perf = self.eff_perf if self.batched else self.perf
        return float(perf[level, idx].sum())

    def backlog_of(self, name: str) -> float:
        return float(self.backlog_s.get(name, 0.0))

    def max_backlog_s(self) -> float:
        """Largest backlog among available nodes — the conservative wait
        bound for a request whose shares land on every serving node."""
        waits = [self.backlog_of(n)
                 for n, a in zip(self.names, self.available) if a]
        return max(waits, default=0.0)

    def mean_backlog_s(self) -> float:
        """Mean backlog across available nodes (autoscaler signal);
        +inf when no node serves, so scale-up pressure is maximal."""
        active = [n for n, a in zip(self.names, self.available) if a]
        if not active:
            return float("inf")
        return sum(self.backlog_of(n) for n in active) / len(active)


class SnapshotCache:
    """Incremental ClusterState builder: copy-on-write instead of
    copy-per-event.

    ``ClusterState.from_table`` copies the whole perf matrix on every
    snapshot; at one snapshot per simulator event that copy (plus the
    name/availability rebuilds) dominates the control-plane hot path.
    This cache shares one frozen perf/accuracies copy across snapshots
    and re-copies only when ``ProfilingTable.version`` says the table
    actually mutated (membership, re-profile, straggler EWMA) — the
    copy-on-write discipline: a taken snapshot is still immutable and
    can never see a later table mutation, because mutations bump the
    version and the next snapshot gets a fresh frozen copy.

    Invalidation rules (see repro/sched/README.md §Performance):
      * perf / accuracies / names — refreshed when ``table.version``
        changes (every ProfilingTable mutation bumps it);
      * availability / avail_idx — recomputed when the serving mask
        changes (an O(nodes) tuple compare per snapshot);
      * backlogs / now / standby — per-snapshot values, always fresh.
    """

    _ids = itertools.count()

    def __init__(self):
        self._cache_id = next(SnapshotCache._ids)
        self._table: Optional[ProfilingTable] = None
        self._version: Optional[int] = None
        self._epoch = -1                # bumped on every refresh: the
        #                                 memo token, so a table swap can
        #                                 never reuse the old table's key
        self._perf: Optional[np.ndarray] = None
        self._perf_b: Optional[np.ndarray] = None
        self._acc: Optional[np.ndarray] = None
        self._names: Tuple[str, ...] = ()
        self._avail: Optional[Tuple[bool, ...]] = None
        self._avail_idx: Optional[np.ndarray] = None
        # eff_perf matrices per max_batch, shared across snapshots until
        # the next version refresh (max_batch is constant per run, so
        # this is one interpolation per table mutation, not per event)
        self._eff: dict = {}

    def snapshot(self, table: ProfilingTable, *, now: float = 0.0,
                 backlogs: Optional[Mapping[str, float]] = None,
                 standby: Tuple[str, ...] = (),
                 max_batch: int = 1) -> "ClusterState":
        """Snapshot like ``ClusterState.from_table`` but O(nodes) in the
        steady state (no table mutation between events)."""
        if (self._table is not table or self._version != table.version):
            # table identity is part of the key: one cache pointed at a
            # *different* table (even at an equal version) must refresh,
            # or its snapshots and their memo tokens would alias
            self._perf = _frozen_array(table.perf)
            self._perf_b = _frozen_array(table.perf_b)
            self._acc = _frozen_array(table.accuracies)
            self._names = tuple(n.name for n in table.nodes)
            self._table = table
            self._version = table.version
            self._epoch += 1
            self._avail = None          # node set may have changed shape
            self._eff.clear()
        avail = tuple(bool(n.available) for n in table.nodes)
        if avail != self._avail:
            idx = np.array([j for j, a in enumerate(avail) if a], dtype=int)
            idx.flags.writeable = False
            self._avail = avail
            self._avail_idx = idx
        state = ClusterState(
            now_s=now, names=self._names, available=self._avail,
            perf=self._perf, accuracies=self._acc,
            backlog_s=types.MappingProxyType(dict(backlogs or {})),
            standby=frozenset(standby),
            perf_version=(self._cache_id, self._epoch),
            perf_b=self._perf_b, batch_grid=table.batch_grid,
            max_batch=max_batch)
        # __post_init__-equivalent construction: the fresh state has not
        # escaped yet, so pre-seeding its memo fields here is invisible
        # to every consumer (DET004 allowlists SnapshotCache.snapshot)
        object.__setattr__(state, "_avail_idx", self._avail_idx)
        if max_batch > 1:
            eff = self._eff.get(max_batch)
            if eff is None:
                eff = np.asarray(interp_throughput(
                    self._perf_b, table.batch_grid, max_batch))
                eff.flags.writeable = False
                self._eff[max_batch] = eff
            object.__setattr__(state, "_eff_perf", eff)
        return state
