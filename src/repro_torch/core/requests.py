"""Inference request / result / violation accounting (paper §III-A, §IV-B).

A request R is a batch of inputs (the paper: images; here: sequences) with a
performance requirement ``perf_req`` (inferences/s) and an accuracy
requirement ``acc_req`` (%). The queue at the gateway node is a vector of
(R, P|A) tuples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


SLO_STRICT = "strict"          # accuracy contract is non-negotiable
SLO_DEGRADABLE = "degradable"  # client opted into degraded service

# tenant of every request that never opted into multi-tenancy: single-
# tenant traffic stays on this one name, so tenancy is zero-cost when off
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class InferenceRequest:
    rid: int
    num_items: int              # batch size R (images / sequences)
    perf_req: float             # required throughput, items/s
    acc_req: float              # required output accuracy, %
    seq_len: int = 128          # per-item sequence length (LM serving)
    arrival_s: float = 0.0      # sim-clock arrival time (online serving)
    deadline_s: float = 0.0     # latency budget from arrival; 0 => derive
    slo_class: str = SLO_DEGRADABLE   # strict => gate may reject, not degrade
    tenant: str = DEFAULT_TENANT      # multi-tenant serving: SLO/fairness key

    def __post_init__(self):
        assert self.slo_class in (SLO_STRICT, SLO_DEGRADABLE), (
            f"unknown slo_class {self.slo_class!r}")
        assert self.tenant, "tenant must be a non-empty name"

    @property
    def latency_budget_s(self) -> float:
        """Deadline budget: explicit ``deadline_s`` or the service time the
        request's own perf_req implies (num_items / perf_req)."""
        if self.deadline_s > 0:
            return self.deadline_s
        if self.perf_req > 0:
            return self.num_items / self.perf_req
        return float("inf")

    def degraded(self, perf_req: float, acc_floor: float) -> "InferenceRequest":
        """Renegotiated copy for a degraded admission: the gateway raises
        the effective throughput requirement (forcing the dispatch policy
        onto coarser apx levels) and relaxes ``acc_req`` down to what the
        deepest variant can deliver. The deadline budget is *frozen* at
        the original value — raising perf_req must not silently shrink a
        derived budget; degraded service still aims at the original
        latency target."""
        assert self.slo_class == SLO_DEGRADABLE, (
            f"rid={self.rid} is SLO-strict; the gate must reject, "
            "not degrade")
        budget = self.latency_budget_s
        return dataclasses.replace(
            self, perf_req=max(self.perf_req, perf_req),
            acc_req=min(self.acc_req, acc_floor),
            deadline_s=budget if budget != float("inf") else self.deadline_s)


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Per-node share of one dispatch: workload w_i and approximation l_i."""
    node: str
    items: int                  # w_i
    apx_level: int              # model variant index (0 = most accurate)
    perf_alloc: float           # table throughput backing this share


@dataclasses.dataclass(frozen=True)
class Dispatch:
    request: InferenceRequest
    assignments: Tuple[Assignment, ...]
    policy: str

    @property
    def total_items(self) -> int:
        return sum(a.items for a in self.assignments)


@dataclasses.dataclass
class ExecutionResult:
    """Achieved performance/accuracy of one executed dispatch.

    Timing fields are on the simulator clock; in the timeless (offline)
    path they default to a dispatch at t=0, so ``latency_s == makespan_s``
    and ``queue_wait_s == 0``.
    """
    request: InferenceRequest
    policy: str
    achieved_perf: float        # items/s (R / makespan)
    achieved_acc: float         # workload-weighted accuracy %
    makespan_s: float
    per_node_time: Dict[str, float]   # pure service time per node
    arrival_s: float = 0.0      # request arrival on the sim clock
    start_s: float = 0.0        # dispatch (DISTRIBUTE) time
    finish_s: float = 0.0       # last share completion; 0 => start+makespan
    queue_wait_s: float = 0.0   # max per-node wait between dispatch and start

    @property
    def latency_s(self) -> float:
        """End-to-end latency: arrival -> last share completion."""
        finish = self.finish_s if self.finish_s > 0 else (
            self.start_s + self.makespan_s)
        return finish - self.arrival_s

    @property
    def meets_deadline(self) -> bool:
        return self.latency_s <= self.request.latency_budget_s + 1e-9

    @property
    def perf_violation(self) -> float:
        if self.request.perf_req <= 0:
            return 0.0
        return max(0.0, (self.request.perf_req - self.achieved_perf)
                   / self.request.perf_req)

    @property
    def acc_violation(self) -> float:
        return max(0.0, self.request.acc_req - self.achieved_acc)

    @property
    def meets_perf(self) -> bool:
        return self.achieved_perf >= self.request.perf_req * (1 - 1e-9)

    @property
    def meets_acc(self) -> bool:
        return self.achieved_acc >= self.request.acc_req - 1e-9


def _percentile(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (no numpy dependency)."""
    if not sorted_xs:
        return 0.0
    k = min(len(sorted_xs) - 1, max(0, int(round(q * (len(sorted_xs) - 1)))))
    return sorted_xs[k]


def violation_summary(results: Sequence[ExecutionResult]) -> Dict[str, float]:
    n = max(len(results), 1)
    lat = sorted(r.latency_s for r in results)
    return {
        "perf_violation_rate": sum(not r.meets_perf for r in results) / n,
        "acc_violation_rate": sum(not r.meets_acc for r in results) / n,
        "mean_perf_violation": sum(r.perf_violation for r in results) / n,
        "mean_acc_violation": sum(r.acc_violation for r in results) / n,
        "mean_perf": sum(r.achieved_perf for r in results) / n,
        "mean_acc": sum(r.achieved_acc for r in results) / n,
        "deadline_violation_rate":
            sum(not r.meets_deadline for r in results) / n,
        "p50_latency_s": _percentile(lat, 0.50),
        "p99_latency_s": _percentile(lat, 0.99),
        "mean_queue_wait_s": sum(r.queue_wait_s for r in results) / n,
    }
