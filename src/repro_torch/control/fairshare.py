"""Deficit-round-robin fair scheduler for multi-tenant gateways.

The plan-aware gate (:mod:`repro_torch.control.admission`) decides *whether*
an arrival can be served; it says nothing about *whose* arrival gets to
the gate first. Under a noisy neighbor that ordering is the whole game:
a tenant pushing 3x its share of traffic reaches the gate 3x as often,
drains the shared token bucket, and fills the node queues so victims'
plans miss their deadlines — every rejection is "correct" and the
outcome is still starvation.

:class:`FairShareScheduler` sits between arrivals and the gate. Each
tenant gets its own FIFO; a deficit-round-robin ring (Shreedhar &
Varghese) releases requests to the gate in weighted max-min order over
per-tenant backlog, measured in *items* (the unit the fleet actually
serves), not request counts. With ``quantum_items`` at least the
largest request size the scheduler is work-conserving: whenever any
tenant has pending work and the outstanding-items cap has room, a
request is released — total work served equals a single shared FIFO on
the same trace; only the interleaving changes.

An optional ``max_outstanding_items`` cap turns the ring into a
closed-loop: while the fleet is saturated, newly released work per
tenant is bounded by its weighted max-min share of the cap (water-
filling over live demand), so one tenant's flash crowd queues behind
its own share instead of in front of everyone else's.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional

from repro_torch.analysis import sanitize
from repro_torch.core.requests import InferenceRequest

# REPRO_SANITIZE=1 arms the DRR deficit-bound and outstanding-ledger
# invariants at every release/settle; no-op closures otherwise
_check_drr_release = sanitize.hook(sanitize.check_drr_release)
_check_outstanding = sanitize.hook(sanitize.check_outstanding)


def weighted_max_min(demands: Dict[str, float], weights: Dict[str, float],
                     capacity: float) -> Dict[str, float]:
    """Water-filling weighted max-min allocation of ``capacity`` over
    per-tenant ``demands``. Tenants whose demand sits below their
    weighted fill level are satisfied exactly and drop out; the freed
    capacity is re-filled over the rest. Allocations never exceed
    demand and sum to at most ``capacity``."""
    alloc = {t: 0.0 for t in demands}
    remaining = {t: float(d) for t, d in demands.items() if d > 0}
    cap = float(capacity)
    while remaining and cap > 1e-12:
        wsum = sum(weights.get(t, 1.0) for t in remaining)
        fill = cap / wsum
        satisfied = [t for t, d in remaining.items()
                     if d <= fill * weights.get(t, 1.0) + 1e-12]
        if not satisfied:
            for t in remaining:
                alloc[t] += fill * weights.get(t, 1.0)
            break
        for t in satisfied:
            alloc[t] += remaining[t]
            cap -= remaining.pop(t)
    return alloc


class FairShareScheduler:
    """Per-tenant FIFOs behind a deficit-round-robin release ring.

    ``weights`` maps tenant name -> relative share (default 1.0 for
    unknown tenants). ``quantum_items`` is the deficit top-up per DRR
    visit, scaled by the tenant's weight; keep it >= the largest
    request's ``num_items`` so every visited tenant can release its
    head (work conservation). ``max_outstanding_items`` optionally caps
    items released-but-not-settled across all tenants; None leaves the
    ring purely ordering (every pending request is released as soon as
    the caller drains).
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None, *,
                 quantum_items: int = 1024,
                 max_outstanding_items: Optional[int] = None):
        assert quantum_items > 0, "quantum must be positive"
        self.weights: Dict[str, float] = dict(weights or {})
        self.quantum_items = int(quantum_items)
        self.max_outstanding_items = max_outstanding_items
        self._pending: Dict[str, Deque[InferenceRequest]] = {}
        self._ring: List[str] = []          # tenants with pending work
        self._cursor = 0
        self._deficit: Dict[str, float] = {}
        self._outstanding: Dict[str, int] = {}
        self._outstanding_total = 0

    # ---- introspection ------------------------------------------------
    def _weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    @property
    def pending_total(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def pending_items(self, tenant: str) -> int:
        return sum(r.num_items for r in self._pending.get(tenant, ()))

    def backlog(self) -> Dict[str, int]:
        """Pending items per tenant (queued here, not yet released)."""
        return {t: self.pending_items(t) for t in self._pending
                if self._pending[t]}

    # ---- producer side ------------------------------------------------
    def enqueue(self, request: InferenceRequest):
        q = self._pending.get(request.tenant)
        if q is None:
            q = self._pending[request.tenant] = collections.deque()
        if not q and request.tenant not in self._ring:
            self._ring.append(request.tenant)
            self._deficit.setdefault(request.tenant, 0.0)
        q.append(request)

    # ---- feedback from the serving side -------------------------------
    def on_admitted(self, tenant: str, items: int):
        """The gate admitted ``items`` for ``tenant``: count them as
        outstanding until :meth:`on_done` settles them."""
        self._outstanding[tenant] = self._outstanding.get(tenant, 0) + items
        self._outstanding_total += items

    def on_done(self, tenant: str, items: int):
        have = self._outstanding.get(tenant, 0)
        take = min(have, items)
        self._outstanding[tenant] = have - take
        self._outstanding_total -= take
        _check_outstanding(self._outstanding, self._outstanding_total)

    # ---- consumer side ------------------------------------------------
    def _eligible(self) -> Dict[str, bool]:
        """Which tenants may release right now. Without a cap everyone
        with pending work is eligible (the ring is pure ordering). With
        a cap, a tenant is eligible while its outstanding items sit
        below its weighted max-min share of the cap — falling back to
        everyone when shares are all exhausted but the global cap still
        has room (work-conserving fill)."""
        has_work = {t: bool(self._pending.get(t)) for t in self._ring}
        cap = self.max_outstanding_items
        if cap is None:
            return has_work
        demands = {t: self._outstanding.get(t, 0) + self.pending_items(t)
                   for t in self._ring}
        shares = weighted_max_min(demands, self.weights, float(cap))
        eligible = {t: has_work[t]
                    and self._outstanding.get(t, 0) < shares.get(t, 0.0) - 1e-9
                    for t in self._ring}
        if not any(eligible.values()) and any(has_work.values()):
            return has_work
        return eligible

    def next_request(self) -> Optional[InferenceRequest]:
        """Release the next request in DRR order, or None when nothing
        is pending / the outstanding cap is full. The caller is expected
        to drain in a loop until None."""
        if (self.max_outstanding_items is not None
                and self._outstanding_total >= self.max_outstanding_items):
            return None
        if not any(self._pending.get(t) for t in self._ring):
            return None
        eligible = self._eligible()
        if not any(eligible.values()):
            return None
        # Deficits grow by quantum*weight on every visit, so some
        # eligible tenant's head is reachable in bounded passes even if
        # the quantum is (mis)configured below the largest request.
        while True:
            if self._cursor >= len(self._ring):
                self._cursor = 0
            tenant = self._ring[self._cursor]
            q = self._pending.get(tenant)
            if not q:
                # drained tenant leaves the ring; its deficit resets so
                # idle time never banks future priority
                self._ring.pop(self._cursor)
                self._deficit[tenant] = 0.0
                continue
            if not eligible.get(tenant, False):
                self._cursor += 1
                continue
            cost = q[0].num_items
            if self._deficit[tenant] >= cost:
                req = q.popleft()
                self._deficit[tenant] -= cost
                # post-release bound (Shreedhar & Varghese): the residual
                # deficit is below one weighted quantum, or the ring is
                # banking unearned priority
                _check_drr_release(self._deficit[tenant],
                                   self.quantum_items,
                                   self._weight(tenant), tenant)
                if not q:
                    self._ring.pop(self._cursor)
                    self._deficit[tenant] = 0.0
                return req
            self._deficit[tenant] += self.quantum_items * self._weight(tenant)
            self._cursor += 1
