"""Queue-depth / deadline-violation-driven autoscaler over a standby pool.

The cluster starts with its base worker groups active and a set of
*standby* groups profiled but unavailable (``NodeProfile.available=False``
— think pre-provisioned groups of cards kept powered down). The
autoscaler watches two signals the simulator feeds it:

  * mean per-node queue backlog (seconds of predicted work) across the
    currently active nodes, and
  * the deadline-violation rate over a sliding window of recent
    completions,

and spawns a standby group when either crosses its scale-up threshold, or
retires the most recently spawned group when both are comfortably below
the scale-down thresholds. Spawns take ``warmup_s`` to become serveable
(container start + model load); every action arms a ``cooldown_s`` timer
so the loop cannot flap; and a node joining the serving set re-runs its
PROFILE step (``ProfilingTable.reprofile_node``) so stale straggler-EWMA
decay from a previous life does not skew the dispatch policy.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.core.profiling import ProfilingTable
from repro_torch.sched import ClusterState

SPAWN = "spawn"
RETIRE = "retire"


@dataclasses.dataclass(frozen=True)
class ScalingAction:
    """One scaling decision: ``node`` becomes serveable at ``ready_s``
    (spawn) or leaves the serving set immediately (retire)."""
    kind: str                 # SPAWN | RETIRE
    node: str
    decided_s: float
    ready_s: float
    reason: str


class Autoscaler:
    """Feedback controller spawning/retiring standby worker groups.

    Only nodes it spawned are ever retired (LIFO), so the base cluster
    can never be scaled away. The caller (the simulator) applies each
    returned :class:`ScalingAction`: flip availability on the gateway,
    delay serveability by the warm-up, and call :meth:`on_ready` when a
    spawned node actually joins so the table column is re-profiled.
    """

    def __init__(self, table: ProfilingTable, standby: Sequence[str], *,
                 scale_up_backlog_s: float = 1.0,
                 scale_down_backlog_s: float = 0.1,
                 violation_rate_hi: float = 0.15,
                 violation_rate_lo: float = 0.02,
                 window: int = 32,
                 min_window: int = 8,
                 cooldown_s: float = 5.0,
                 warmup_s: float = 2.0):
        assert scale_down_backlog_s < scale_up_backlog_s
        assert violation_rate_lo <= violation_rate_hi
        assert min_window <= window, (
            "min_window > window would permanently zero the violation "
            "signal (the deque can never reach min_window samples)")
        names = {n.name for n in table.nodes}
        unknown = [s for s in standby if s not in names]
        assert not unknown, f"standby nodes not in table: {unknown}"
        self.table = table
        self.standby: List[str] = list(standby)   # spawn order (pool)
        self.scale_up_backlog_s = scale_up_backlog_s
        self.scale_down_backlog_s = scale_down_backlog_s
        self.violation_rate_hi = violation_rate_hi
        self.violation_rate_lo = violation_rate_lo
        self.cooldown_s = cooldown_s
        self.warmup_s = warmup_s
        self.min_window = min_window
        self._window: Deque[bool] = collections.deque(maxlen=window)
        # SLO samples observed since the last scaling action. A scaling
        # action changes the very capacity the windowed samples measured,
        # so the violation signal stays muted until ``min_window`` *fresh*
        # post-action samples accrue — without this, the stale shed
        # samples sitting in the deque re-trigger a second spawn the
        # moment the cooldown expires even though the first spawn already
        # fixed the backlog (scale-up flapping under low traffic).
        self._fresh_samples = 0
        self._last_action_s = -float("inf")
        self._pending: Dict[str, float] = {}      # spawning: name -> ready_s
        self._spawned: List[str] = []             # active, LIFO retire order
        self.actions: List[ScalingAction] = []

    # ---- signal intake ------------------------------------------------
    def record_outcome(self, slo_honoured: bool):
        """Feed one request's SLO outcome into the sliding window: a
        completion reports whether it met its deadline, and a gateway
        *shed* reports False — from the client's perspective a rejected
        request is a failed SLO, so sustained shedding must drive
        scale-up even while admission keeps the queues short."""
        self._window.append(slo_honoured)
        self._fresh_samples += 1

    def violation_rate(self) -> float:
        """Windowed SLO-failure rate; 0 until ``min_window`` samples have
        accrued so one early shed cannot trigger a spawn by itself, and 0
        again until ``min_window`` samples *after the last scaling
        action* — samples taken before the action measured a capacity
        that no longer exists."""
        if (len(self._window) < self.min_window
                or self._fresh_samples < self.min_window):
            return 0.0
        return sum(not ok for ok in self._window) / len(self._window)

    @property
    def pending(self) -> tuple:
        """Names of nodes currently mid-warm-up (spawn decided, not yet
        serving) — still part of the standby set from a snapshot's view."""
        return tuple(self._pending)

    # ---- control step -------------------------------------------------
    def ready(self, now: float) -> bool:
        """Cheap pre-check: False while cooling down or mid-warm-up, so
        callers can skip building the (O(queued shares)) ClusterState
        snapshot when evaluate() would discard it anyway."""
        return not self._pending and (
            now - self._last_action_s >= self.cooldown_s)

    def evaluate(self, state: ClusterState) -> Optional[ScalingAction]:
        """One control-loop tick over a ClusterState snapshot (the same
        snapshot the admission gate planned from); at most one action per
        call, gated by the cooldown (which also covers in-flight
        warm-ups)."""
        now = state.now_s
        if not self.ready(now):
            return None
        mean_backlog = state.mean_backlog_s()
        viol = self.violation_rate()

        if (mean_backlog > self.scale_up_backlog_s
                or viol > self.violation_rate_hi):
            if not self.standby:
                return None
            node = self.standby.pop(0)
            action = ScalingAction(
                kind=SPAWN, node=node, decided_s=now,
                ready_s=now + self.warmup_s,
                reason=(f"backlog={mean_backlog:.3f}s "
                        f"violation_rate={viol:.3f}"))
            self._pending[node] = action.ready_s
            self._last_action_s = now
            self._fresh_samples = 0
            self.actions.append(action)
            return action

        if (mean_backlog < self.scale_down_backlog_s
                and viol <= self.violation_rate_lo and self._spawned):
            node = self._spawned.pop()
            action = ScalingAction(
                kind=RETIRE, node=node, decided_s=now, ready_s=now,
                reason=(f"backlog={mean_backlog:.3f}s "
                        f"violation_rate={viol:.3f}"))
            self._last_action_s = now
            self._fresh_samples = 0
            self.actions.append(action)
            self.standby.append(node)             # back into the pool
            return action
        return None

    # ---- cross-cell work stealing (sharded control plane) --------------
    def release_standby(self) -> Optional[str]:
        """Give up one *pooled* standby node so another cell's autoscaler
        can adopt it (work stealing between cells). Only un-spawned,
        un-pending pool members are transferable — a node mid-warm-up or
        already serving belongs to this cell until it retires back into
        the pool. Returns the released name, or None when the pool is
        empty. Releases from the pool's tail: the head is this cell's
        own next spawn candidate."""
        if not self.standby:
            return None
        return self.standby.pop()

    def adopt_standby(self, node: str):
        """Adopt a standby node released by another cell's autoscaler.
        The node must be profiled in this cell's table (sharded cell
        tables carry every standby column precisely so adoption needs no
        re-profiling) and not already owned here."""
        names = {n.name for n in self.table.nodes}
        assert node in names, (
            f"cannot adopt {node}: not profiled in this cell's table")
        assert node not in self.standby and node not in self._pending \
            and node not in self._spawned, (
                f"cannot adopt {node}: already owned by this autoscaler")
        self.standby.append(node)

    def on_ready(self, node: str):
        """A spawned node finished warming up: bookkeeping only — it
        leaves the pending set and becomes retireable. The PROFILE-on-join
        step (ProfilingTable.reprofile_node) is owned by the GatewayNode's
        ``spawn`` event handler, which the simulator fires alongside this
        call; keeping a single owner stops the two layers diverging."""
        assert node in self._pending, f"{node} was not spawning"
        del self._pending[node]
        self._spawned.append(node)

    # ---- reporting ----------------------------------------------------
    def summary(self) -> Dict[str, float]:
        spawns = [a for a in self.actions if a.kind == SPAWN]
        retires = [a for a in self.actions if a.kind == RETIRE]
        lat = [a.ready_s - a.decided_s for a in spawns]
        return {
            "scale_ups": float(len(spawns)),
            "scale_downs": float(len(retires)),
            "mean_scale_up_latency_s": (sum(lat) / len(lat)) if lat else 0.0,
        }
