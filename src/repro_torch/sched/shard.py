"""Fleet partitioning + request routing for the sharded control plane.

One gateway planning every request is the scalability ceiling at
fleet-256 and beyond: each Plan is O(levels x nodes) over the *whole*
fleet, every share fans onto every available node, and one snapshot/
admission/autoscaler instance serializes all of it. CoEdge
(arXiv:2012.03257) and DistrEdge (arXiv:2202.01699) both scale
cooperative edge inference by decentralizing scheduling across device
groups; this module is that cut for the repro: the fleet is partitioned
into **cells**, each cell runs the full single-gateway stack (planner +
admission gate + autoscaler) over its own ProfilingTable slice, and a
thin root **router** assigns each arriving request to one cell.

This module is pure decision logic — who owns which node, which cell a
request lands on, when standby capacity should move between cells. The
event-loop mechanics (per-cell queues, the global (time, seq) merge)
live in ``repro_torch.sim.sharded``.

Partition strategies (:func:`partition_fleet`):
  * ``stripe``   — round-robin by fleet index. Cells get statistically
                   identical capacity mixes for the seeded heterogeneous
                   fleets; zero knowledge needed.
  * ``by-class`` — LPT (longest-processing-time) over the node capacity
                   classes ``chips * capability``: heaviest node first,
                   onto the currently lightest cell. Balances total
                   capacity tightly even when the class distribution is
                   skewed (e.g. a fleet where one batch of boards is 6x
                   the rest).

Both preserve the original fleet order *within* a cell, so a 1-cell
partition reproduces the unsharded node table byte-identically — the
property every ``cells=1`` equivalence guarantee builds on.

Router policies (:class:`CellRouter`):
  * ``least-backlog`` — route to the cell with the smallest outstanding
                        work per unit capacity (O(cells) per arrival,
                        maintained by route/settle counters — no cell
                        snapshot is ever taken at the root).
  * ``rendezvous``    — highest-random-weight hash of (rid, cell):
                        stateless, deterministic, and minimally
                        disruptive when the cell count changes.

Rebalancing (:func:`pick_rebalance`): when one cell's normalized
outstanding work diverges from another's by more than a threshold, the
root moves one *pooled* standby node from the calm cell's autoscaler to
the hot cell's (``Autoscaler.release_standby`` / ``adopt_standby``) —
work stealing of reserve capacity, never of live queues.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

STRATEGIES = ("stripe", "by-class")
ROUTERS = ("least-backlog", "rendezvous")

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a deterministic 64-bit mixer. Python's
    built-in ``hash`` is salted per process, so rendezvous weights must
    come from an explicit mixer or routing would differ run to run."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One cell's membership: which fleet nodes it serves with and which
    standby nodes its autoscaler pool starts out owning. ``nodes`` keeps
    the original fleet order, so a cell's ProfilingTable columns line up
    with the unsharded table's for the same names."""
    cell_id: int
    nodes: Tuple[str, ...]
    standby: Tuple[str, ...] = ()


def partition_fleet(profiles: Sequence, num_cells: int,
                    strategy: str = "stripe") -> List[CellSpec]:
    """Partition a fleet's NodeProfiles into ``num_cells`` cell specs.

    ``profiles`` is the full fleet in table order; entries with
    ``available=False`` are the standby pool and are dealt round-robin
    across cells regardless of strategy (reserve capacity is fungible —
    rebalancing moves it anyway). Serving nodes split by ``strategy``
    (see module docstring). Every cell gets at least one serving node.
    """
    assert num_cells >= 1, "need at least one cell"
    assert strategy in STRATEGIES, (
        f"unknown partition strategy {strategy!r}; have {STRATEGIES}")
    base = [(j, p) for j, p in enumerate(profiles) if p.available]
    standby = [(j, p) for j, p in enumerate(profiles) if not p.available]
    assert base, "fleet has no serving nodes to partition"
    assert num_cells <= len(base), (
        f"{num_cells} cells over {len(base)} serving nodes would leave "
        "empty cells")
    if strategy == "stripe":
        assign = {j: i % num_cells for i, (j, _) in enumerate(base)}
    else:       # by-class: LPT greedy over chips * capability
        loads = [0.0] * num_cells
        assign = {}
        order = sorted(base, key=lambda jp: (-jp[1].chips
                                             * jp[1].capability, jp[0]))
        for j, p in order:
            c = min(range(num_cells), key=lambda k: (loads[k], k))
            assign[j] = c
            loads[c] += p.chips * p.capability
    standby_assign = {j: i % num_cells
                      for i, (j, _) in enumerate(standby)}
    return [CellSpec(
        cell_id=c,
        nodes=tuple(p.name for j, p in base if assign[j] == c),
        standby=tuple(p.name for j, p in standby
                      if standby_assign[j] == c))
        for c in range(num_cells)]


class CellRouter:
    """Assigns each arriving request to a cell and tracks per-cell
    outstanding work for the least-backlog policy and the rebalancer.

    The router never snapshots a cell: it maintains one counter per cell
    — items routed in minus items settled (completed or shed) — and
    normalizes by the cell's capacity proxy, giving an O(cells)
    seconds-of-work estimate per arrival. ``capacities`` defaults to
    ``sum(chips * capability)`` over each cell's serving nodes, which is
    exactly proportional to level-0 throughput under the roofline model
    (both cost terms scale linearly in ``chips * capability``)."""

    def __init__(self, specs: Sequence[CellSpec],
                 policy: str = "least-backlog",
                 capacities: Optional[Sequence[float]] = None):
        assert policy in ROUTERS, (
            f"unknown router policy {policy!r}; have {ROUTERS}")
        self.specs = list(specs)
        self.policy = policy
        if capacities is None:
            capacities = [float(len(s.nodes)) for s in self.specs]
        assert len(capacities) == len(self.specs)
        self._cap = [max(float(c), 1e-9) for c in capacities]
        self.outstanding = [0.0] * len(self.specs)
        # tenant-keyed mirror of the outstanding counters: who the
        # in-flight work belongs to, per cell. Purely observational —
        # the routing decision below never reads it (fairness is the
        # per-cell DRR scheduler's job; the router must not double-
        # penalize a tenant) — but the rebalancer and the per-tenant
        # reports need to see *whose* backlog a hot cell is carrying.
        self.outstanding_by_tenant: List[dict] = [
            {} for _ in self.specs]

    def route(self, request) -> int:
        """Pick the cell for one arrival and record its items as
        outstanding there. Deterministic: ties break to the lowest
        cell id."""
        n = len(self.specs)
        if n == 1:
            c = 0
        elif self.policy == "rendezvous":
            c = max(range(n),
                    key=lambda k: (_mix64(_mix64(request.rid)
                                          ^ _mix64(k + 1)), -k))
        else:
            c = min(range(n),
                    key=lambda k: (self.outstanding[k] / self._cap[k], k))
        self.outstanding[c] += request.num_items
        tenant = getattr(request, "tenant", None)
        if tenant is not None:
            per = self.outstanding_by_tenant[c]
            per[tenant] = per.get(tenant, 0.0) + request.num_items
        return c

    def settle(self, cell_id: int, num_items: int,
               tenant: Optional[str] = None):
        """A routed request reached a terminal outcome (finished or shed)
        in ``cell_id``: release its outstanding items. ``tenant`` keys
        the release against the per-tenant mirror (None skips it — the
        pre-tenancy call shape)."""
        self.outstanding[cell_id] = max(
            0.0, self.outstanding[cell_id] - num_items)
        if tenant is not None:
            per = self.outstanding_by_tenant[cell_id]
            if tenant in per:
                per[tenant] = max(0.0, per[tenant] - num_items)

    def loads(self) -> List[float]:
        """Per-cell outstanding work normalized by capacity (comparable
        seconds-of-backlog estimates — the rebalance signal)."""
        return [o / c for o, c in zip(self.outstanding, self._cap)]

    def loads_by_tenant(self) -> List[dict]:
        """Per-cell, per-tenant outstanding work normalized by the
        cell's capacity — ``loads()`` decomposed by who queued it."""
        return [{t: o / c for t, o in per.items()}
                for per, c in zip(self.outstanding_by_tenant, self._cap)]


def pick_rebalance(loads: Sequence[float], *,
                   min_gap: float = 1.0) -> Optional[Tuple[int, int]]:
    """Work-stealing decision over the router's normalized loads:
    returns ``(src, dst)`` — move one pooled standby node from the
    least-loaded cell ``src`` to the most-loaded cell ``dst`` — when
    they diverge by more than ``min_gap`` seconds of normalized backlog;
    None while the cells are balanced. Ties break to the lowest cell id
    on both ends, so the decision is deterministic."""
    if len(loads) < 2:
        return None
    src = min(range(len(loads)), key=lambda c: (loads[c], c))
    dst = max(range(len(loads)), key=lambda c: (loads[c], -c))
    if loads[dst] - loads[src] > min_gap:
        return src, dst
    return None
