"""Heterogeneous cluster execution model (paper §IV testbed, scaled up).

The paper's testbed is {Odroid XU4 x2, Jetson Nano, Raspberry Pi4}. Here a
*node* is a worker group of accelerator cards with a card count and a
capability derate (thermal throttle / older generation — the DVFS-under-TDP
analogue). One backend executes a Dispatch here:

  * ``SimBackend``   — analytic makespan from the profiling table (+ optional
    noise / straggler events). Used by benchmarks reproducing the paper's
    figures, where ground truth == table entries, as in the paper's own
    model-based evaluation.

Real execution of the shares goes through ``repro_torch.launch.serve.run_shares``
(one serving engine per accuracy level).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiling import (NodeProfile, ProfilingTable,
                                        batched_service_s, interp_throughput)
from repro_torch.core.requests import Dispatch, ExecutionResult


# The paper's default 4-node testbed, scaled up: four unequal groups
# (sum = 256 cards; ``chips`` counts cards) with heterogeneous capability. The skew
# (~2.1x between strongest and weakest) mirrors the paper's XU4/Pi4/Nano
# spread: approximating the weakest node can still compensate an equal
# split, which is the regime where the four strategies differentiate.
DEFAULT_NODES = (
    NodeProfile("slice-a", chips=80, capability=1.00),    # 5x16
    NodeProfile("slice-b", chips=64, capability=0.90),    # 4x16, throttled
    NodeProfile("slice-c", chips=64, capability=1.00),    # 4x16
    NodeProfile("slice-d", chips=48, capability=0.80),    # 3x16, old gen
)

# Standby pool for the autoscaler: pre-provisioned slices kept out of the
# serving set (available=False) until queue-depth / deadline-violation
# signals spawn them. Profiled at table build like everyone else, so a
# spawn only pays the warm-up, not a cold profile.
STANDBY_NODES = (
    NodeProfile("standby-a", chips=64, capability=1.00, available=False),
    NodeProfile("standby-b", chips=48, capability=0.90, available=False),
)


def cluster_nodes(num_standby: int = 0) -> List[NodeProfile]:
    """Fresh copies of the default cluster + the first ``num_standby``
    standby slices (callers mutate NodeProfile, so never share instances)."""
    assert 0 <= num_standby <= len(STANDBY_NODES), (
        f"at most {len(STANDBY_NODES)} standby nodes available")
    base = [NodeProfile(n.name, n.chips, n.capability, n.available)
            for n in DEFAULT_NODES]
    base += [NodeProfile(n.name, n.chips, n.capability, n.available)
             for n in STANDBY_NODES[:num_standby]]
    return base


# chip-count menu for synthetic fleets: sub-mesh slice sizes from a 1x16
# row up to a 6x16 block, the same granularity partition_pod carves
_FLEET_CHIP_CHOICES = (16, 32, 48, 64, 80, 96)


def synthetic_fleet(num_nodes: int, *, seed: int = 0,
                    num_standby: int = 0) -> List[NodeProfile]:
    """Deterministic heterogeneous fleet far beyond the paper's 3-4 boards.

    Node j gets a seeded random slice size and a capability derate in
    [0.6, 1.0] (thermal throttle / generation spread), mirroring the
    paper's XU4/Pi4/Nano skew at 64- and 256-node scale. The trailing
    ``num_standby`` nodes start unavailable (the autoscaler's pool),
    like ``STANDBY_NODES`` in the default cluster.
    """
    assert num_nodes >= 1 and num_standby >= 0
    rng = np.random.default_rng(seed)
    nodes = [NodeProfile(f"fleet-{j:03d}",
                         chips=int(rng.choice(_FLEET_CHIP_CHOICES)),
                         capability=float(np.round(rng.uniform(0.6, 1.0), 3)))
             for j in range(num_nodes)]
    nodes += [NodeProfile(f"fleet-standby-{k:02d}", chips=64,
                          capability=1.0, available=False)
              for k in range(num_standby)]
    return nodes


@dataclasses.dataclass
class StragglerEvent:
    node: str
    slowdown: float          # achieved perf = table perf * slowdown


class SimBackend:
    """Analytic execution: per-node time = w_i / perf(level_i, node_i)."""

    def __init__(self, table: ProfilingTable, *,
                 noise_std: float = 0.0, seed: int = 0):
        self.table = table
        self.noise_std = noise_std
        self.rng = np.random.default_rng(seed)
        self.stragglers: Dict[str, float] = {}
        # node membership/order is fixed for a table's lifetime (only perf
        # values and availability mutate), so the index map is cacheable
        self._node_idx = {n.name: j for j, n in enumerate(table.nodes)}
        self._straggler_rev = 0

    @property
    def pred_version(self) -> Tuple[int, int]:
        """Monotone key over everything ``predicted_time`` reads (table
        perf + straggler derates). Queue-backlog caches revalidate their
        per-share predictions exactly when this changes."""
        return (self.table.version, self._straggler_rev)

    def set_straggler(self, node: str, slowdown: float):
        self.stragglers[node] = slowdown
        self._straggler_rev += 1

    def clear_stragglers(self):
        self.stragglers.clear()
        self._straggler_rev += 1

    def predicted_time(self, a: "Assignment") -> float:
        """Deterministic service-time *prediction* for one share: table
        throughput with the current straggler derate, but no noise draw.
        Used by queue-backlog estimation (admission / autoscaling signals)
        so reading the signal never perturbs the RNG stream that the
        actual executions consume."""
        j = self._node_idx[a.node]
        perf = self.table.perf[a.apx_level, j]
        perf *= self.stragglers.get(a.node, 1.0)
        return a.items / max(perf, 1e-9)

    def batched_predicted_time(self, a: "Assignment", max_batch: int,
                               items: Optional[int] = None) -> float:
        """Deterministic service-time prediction for ``items`` (default:
        the whole share) of one share under continuous batching at
        ``max_batch``: full engine batches at the cap's throughput plus
        the partial tail at its own. The batch-aware planners price
        shares with the same decomposition, so gate predictions match
        the runtime exactly under the noise-free backend."""
        if max_batch <= 1:
            t = self.predicted_time(a)
            if items is None:
                return t
            return t * items / max(a.items, 1)
        j = self._node_idx[a.node]
        curve = self.table.perf_b[a.apx_level, j] * self.stragglers.get(
            a.node, 1.0)
        return batched_service_s(a.items if items is None else items,
                                 curve, self.table.batch_grid, max_batch)

    def engine_batch_time(self, node: str, level: int, n_items: int,
                          batch_size: int) -> float:
        """Service time of one runtime op: ``n_items`` items executed in
        engine batches of ``batch_size`` (a full-run op coalesces
        ``n_items / batch_size`` identical full batches; a partial/mixed
        batch has ``n_items == batch_size``). Straggler derate and the
        noise draw apply to the whole op, mirroring
        :meth:`assignment_time`'s one-draw-per-share discipline."""
        j = self._node_idx[node]
        perf = float(interp_throughput(self.table.perf_b[level, j],
                                       self.table.batch_grid, batch_size))
        perf *= self.stragglers.get(node, 1.0)
        if self.noise_std > 0:
            perf *= max(0.05, 1.0 + self.rng.normal(0, self.noise_std))
        return n_items / max(perf, 1e-9)

    def assignment_time(self, a: "Assignment") -> float:
        """Service time of one node's share (straggler + noise applied).

        The online simulator schedules each share onto its node's FIFO
        queue with this duration; ``execute`` below is the timeless
        all-nodes-start-together path built from the same quantity.
        """
        j = self._node_idx[a.node]
        perf = self.table.perf[a.apx_level, j]
        perf *= self.stragglers.get(a.node, 1.0)
        if self.noise_std > 0:
            perf *= max(0.05, 1.0 + self.rng.normal(0, self.noise_std))
        return a.items / max(perf, 1e-9)

    def dispatch_accuracy(self, d: Dispatch) -> float:
        """Workload-weighted accuracy of a dispatch (table proxy)."""
        total = sum(a.items for a in d.assignments)
        acc = sum(a.items * self.table.accuracies[a.apx_level]
                  for a in d.assignments)
        return acc / max(total, 1)

    def execute(self, d: Dispatch, *, now: float = 0.0) -> ExecutionResult:
        """Run all shares starting together at sim-time ``now``.

        ``now`` defaults to the request's own arrival so the offline path
        stays timeless (queue_wait_s == 0, latency_s == makespan_s).
        """
        per_node_time: Dict[str, float] = {}
        for a in d.assignments:
            if a.items == 0:
                continue
            per_node_time[a.node] = self.assignment_time(a)
        makespan = max(per_node_time.values()) if per_node_time else 0.0
        total = sum(a.items for a in d.assignments)
        start = max(now, d.request.arrival_s)
        return ExecutionResult(
            request=d.request, policy=d.policy,
            achieved_perf=total / makespan if makespan > 0 else 0.0,
            achieved_acc=self.dispatch_accuracy(d),
            makespan_s=makespan, per_node_time=per_node_time,
            arrival_s=d.request.arrival_s, start_s=start,
            finish_s=start + makespan,
            queue_wait_s=max(0.0, start - d.request.arrival_s))


def partition_pod(mesh_shape: Tuple[int, int] = (16, 16),
                  splits: Sequence[int] = (5, 4, 4, 3)) -> List[Tuple[int, int]]:
    """Carve a (data, model) pod into row-slices for the worker groups:
    returns [(rows, cols)] per node. sum(splits) must equal mesh rows."""
    assert sum(splits) == mesh_shape[0]
    return [(s, mesh_shape[1]) for s in splits]
