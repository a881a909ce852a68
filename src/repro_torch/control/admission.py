"""Gateway-side admission control: token bucket + plan-aware SLO gate.

The paper's gateway admits every request; under sustained overload every
dispatch policy then degrades the same way (queues grow without bound and
p99 explodes). CoEdge/QPART-style feedback closes the loop at the *front
door* instead: an arrival is admitted only if (a) the token bucket — a
classic rate shaper refilled on the sim clock — has capacity, and (b) the
scheduling policy's own backlog-aware :class:`~repro_torch.sched.plan.Plan`
is predicted to complete within the request's ``latency_budget_s``.

The gate no longer re-derives feasibility with a parallel heuristic: it
asks the policy for a Plan over the current :class:`ClusterState`
snapshot, decides admit/degrade/reject from that plan's predicted
completion vs. the deadline, and the decision *carries the plan* — the
simulator dispatches exactly it, so there is never a second planning
pass between gate and queues.

When the budget is reachable only with more approximation than the
request's own ``perf_req`` implies, the controller can *degrade* the
admission instead of rejecting: it rewrites the request with the higher
effective throughput requirement (forcing the policy onto coarser apx
levels), relaxes ``acc_req`` to the deepest variant's accuracy, and
re-plans once for the renegotiated contract. SLO-``strict`` requests
(``InferenceRequest.slo_class``) opt out of that renegotiation and are
shed instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from repro_torch.analysis import sanitize
from repro_torch.core.profiling import ProfilingTable
from repro_torch.core.requests import SLO_DEGRADABLE, InferenceRequest
from repro_torch.sched import ClusterState, Plan, Policy, resolve_policy

ADMIT = "admit"
DEGRADE = "degrade"
REJECT = "reject"


class TokenBucket:
    """Classic token bucket on the *simulated* clock.

    ``rate`` tokens/s accrue up to ``burst``; one token admits one
    request. ``rate=None`` disables shaping (the bucket always grants).
    Refill happens lazily inside :meth:`try_take`, so the bucket never
    needs a timer — it just needs monotone ``now`` values.
    """

    def __init__(self, rate: Optional[float], burst: float = 8.0):
        assert rate is None or rate > 0, "rate must be positive or None"
        assert burst >= 1.0, "burst must allow at least one token"
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last_s = 0.0

    # REPRO_SANITIZE=1 asserts 0 <= tokens <= burst at every refill/take
    _check_bounds = staticmethod(sanitize.hook(sanitize.check_bucket))

    def _refill(self, now: float):
        if now > self._last_s:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last_s) * self.rate)
            self._last_s = now
        self._check_bounds(self.tokens, self.burst)

    def try_take(self, now: float) -> bool:
        if self.rate is None:
            return True
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self._check_bounds(self.tokens, self.burst)
            return True
        return False

    def peek(self, now: float) -> float:
        """Current token count after a clock-driven refill (no take)."""
        if self.rate is None:
            return float("inf")
        self._refill(now)
        return self.tokens


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one gate check.

    ``request`` is the request to actually dispatch: the original on
    ADMIT, a rewritten (higher perf_req, relaxed acc_req) copy on
    DEGRADE, and the original (undispatched) on REJECT. ``plan`` is the
    policy's Plan backing the decision — the simulator dispatches it
    verbatim on ADMIT/DEGRADE (None on REJECT).
    """
    outcome: str                  # ADMIT | DEGRADE | REJECT
    reason: str
    request: InferenceRequest
    plan: Optional[Plan] = None
    est_wait_s: float = 0.0       # max available-node backlog at decision
    needed_perf: float = 0.0      # items/s required to make the deadline


class AdmissionController:
    """Rate-shaping + plan-aware SLO gate in front of the queues.

    ``policy`` may be a registry name, a Policy instance, or None — the
    OnlineSimulator wires a None up to the GatewayNode's own policy
    object so gate and dispatch always plan identically; standalone use
    without a simulator falls back to the paper's ``proportional``.

    The fast-reject paths keep their closed-form shape (they need no
    plan): a backlog already past the budget, or a needed throughput
    beyond even the deepest approximation row, are shed before planning.
    Everything else is decided from the policy's own Plan.
    """

    def __init__(self, table: ProfilingTable, *,
                 policy: Union[str, Policy, None] = None,
                 rate: Optional[float] = None, burst: float = 8.0,
                 degrade: bool = True, feasibility_margin: float = 0.02,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: float = 8.0,
                 tenant_rates: Optional[Dict[str, float]] = None,
                 plan_cache: bool = True):
        # ``table`` is accepted for constructor compatibility only: since
        # the plan-aware rewrite the gate reads capacity/accuracies/
        # backlogs exclusively from the ClusterState snapshot, never from
        # the live (mutable) table — that side channel is gone.
        del table
        self.policy: Optional[Policy] = (
            resolve_policy(policy) if policy is not None else None)
        self.bucket = TokenBucket(rate, burst)
        self.degrade = degrade
        self.feasibility_margin = feasibility_margin
        # multi-tenant shaping: ``tenant_rates`` pins per-tenant rates by
        # name; ``tenant_rate`` is the default for tenants not listed. A
        # tenant whose resolved rate is None gets no bucket at all, so
        # single-tenant runs never even allocate one.
        self.tenant_rate = tenant_rate
        self.tenant_burst = float(tenant_burst)
        self.tenant_rates: Dict[str, float] = dict(tenant_rates or {})
        self.tenant_buckets: Dict[str, TokenBucket] = {}
        self.counts: Dict[str, int] = {ADMIT: 0, DEGRADE: 0, REJECT: 0}
        # plan-reuse admission: every ``decide`` routes its planning
        # through the policy's selection/assembly split, so recurring
        # (plan_key, level-vector, size) lines replay their cached
        # assembly bit-identically instead of rebuilding it. False
        # disables the reuse cache on the planner (the pre-reuse cold
        # path, retained for ShardedSimulator's reference stack).
        self.plan_cache = plan_cache

    def _planner(self) -> Policy:
        if self.policy is None:
            self.policy = resolve_policy("proportional")
        if not self.plan_cache:
            reuse = getattr(self.policy, "_reuse", None)
            if reuse is not None:
                reuse.enabled = False
        return self.policy

    # hit/miss counters of the planner's reuse cache (0/0 before the
    # first plan or for a reuse-less policy); surfaced via
    # ``SimReport.summary`` so every sweep artifact carries the rate
    @property
    def plan_cache_hits(self) -> int:
        reuse = getattr(self.policy, "_reuse", None)
        return reuse.hits if reuse is not None else 0

    @property
    def plan_cache_misses(self) -> int:
        reuse = getattr(self.policy, "_reuse", None)
        return reuse.misses if reuse is not None else 0

    def _tenant_bucket(self, tenant: str) -> Optional[TokenBucket]:
        """Lazily build the tenant's bucket; None when that tenant is
        unshaped. Buckets are strictly per-name — draining one tenant's
        tokens can never touch another's."""
        bucket = self.tenant_buckets.get(tenant)
        if bucket is None:
            rate = self.tenant_rates.get(tenant, self.tenant_rate)
            if rate is None:
                return None
            bucket = TokenBucket(rate, self.tenant_burst)
            self.tenant_buckets[tenant] = bucket
        return bucket

    # ---- the gate -----------------------------------------------------
    def decide(self, request: InferenceRequest,
               state: ClusterState) -> AdmissionDecision:
        """Gate one arrival against a ClusterState snapshot (taken at the
        arrival instant, so ``state.now_s`` is the request's arrival)."""
        now = state.now_s
        est_wait = state.max_backlog_s()
        budget = request.latency_budget_s
        # Budget already burned waiting upstream (e.g. in a fair-share
        # queue). In the arrival-instant path now == arrival, elapsed is
        # exactly 0.0, and every comparison below is bit-identical to the
        # pre-tenancy gate.
        elapsed = max(0.0, now - request.arrival_s)
        remaining = budget - elapsed - est_wait

        def _done(outcome: str, reason: str, req: InferenceRequest,
                  needed: float,
                  plan: Optional[Plan] = None) -> AdmissionDecision:
            self.counts[outcome] += 1
            return AdmissionDecision(outcome=outcome, reason=reason,
                                     request=req, plan=plan,
                                     est_wait_s=est_wait,
                                     needed_perf=needed)

        if remaining <= 0.0:
            # queue wait alone blows the deadline; no apx level can help
            return _done(REJECT, "queue_wait_exceeds_budget", request, 0.0)

        needed = request.num_items / remaining
        capacity = state.capacity(level=-1)
        if needed > capacity * (1.0 - self.feasibility_margin):
            return _done(REJECT, "infeasible_at_max_approximation",
                         request, needed)

        try:
            plan = self._planner().plan(state, request)
        except RuntimeError:
            return _done(REJECT, "no_available_nodes", request, needed)

        # elapsed-aware deadline test: slack_s is measured from arrival,
        # so a gate running ``elapsed`` seconds later needs that much
        # extra slack (>= -1e-9 when elapsed == 0, i.e. meets_deadline)
        if plan.slack_s >= elapsed - 1e-9:
            taken = self._take_tokens(request.tenant, now)
            if taken is not None:
                return _done(REJECT, taken, request, needed)
            return _done(ADMIT, "feasible", request, needed, plan)

        # the policy's own plan misses the deadline: feasible only with
        # coarser approximation than the request's perf target implies
        if not self.degrade or request.slo_class != SLO_DEGRADABLE:
            return _done(REJECT, "slo_needs_degraded_service",
                         request, needed)
        degraded = request.degraded(
            needed, float(state.accuracies[-1]))
        dplan = self._planner().plan(state, degraded)
        if not dplan.slack_s >= elapsed - 1e-9:
            return _done(REJECT, "degraded_plan_misses_deadline",
                         request, needed)
        taken = self._take_tokens(request.tenant, now)
        if taken is not None:
            return _done(REJECT, taken, request, needed)
        return _done(DEGRADE, "degraded_to_meet_deadline",
                     degraded, needed, dplan)

    def _take_tokens(self, tenant: str, now: float) -> Optional[str]:
        """Charge the global and per-tenant buckets atomically: peek the
        tenant bucket first, take from the global, then take from the
        tenant (the lazy refill is idempotent at the same ``now``, so the
        peeked token is still there). Returns the REJECT reason on
        shortage, None on success — and on shortage *neither* bucket is
        debited."""
        tb = self._tenant_bucket(tenant)
        if tb is not None and tb.peek(now) < 1.0:
            return "tenant_rate_limited"
        if not self.bucket.try_take(now):
            return "rate_limited"
        if tb is not None:
            tb.try_take(now)
        return None
