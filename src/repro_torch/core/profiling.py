"""Profiling table (paper §III-C, Fig. 5): per-node throughput at each
approximation level, now resolved per serving batch size.

Rows = approximation levels (0 = most accurate), columns = nodes. The
``Profile`` FSM state fills a column per node; entries come from either

  * the analytic roofline model — items/s predicted from the variant's
    FLOPs/bytes per item and the node's (derated) hardware constants; or
  * measurement — the engine times the variant on the node (the
    ``measured`` argument).

This is the single data structure the Dispatch Policy reads.

Batch dimension: the pre-batching table folded "a standard serving
batch of 8" into the weight-streaming bytes and reported one scalar
throughput per (level, node). That constant is gone from the cost
model: :func:`variant_item_cost` takes the engine batch explicitly, and
the table carries *batch-curve columns* ``perf_b[level, node, batch]``
over a small geometric grid (:data:`BATCH_GRID`), interpolated by
:meth:`ProfilingTable.throughput` for off-grid batches. The scalar
``perf`` matrix is retained as the curve's :data:`REF_BATCH` column —
numerically identical to the pre-batching table, so every consumer that
does not opt into batching sees exactly the old numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.core.variants import VariantPool

# The serving batch the pre-batching cost model silently assumed; the
# scalar ``ProfilingTable.perf`` matrix is the batch curve evaluated
# here, which keeps every batching-unaware consumer bit-identical.
REF_BATCH = 8

# Geometric batch grid the table profiles. Real profiling runs measure a
# handful of batch points and interpolate, exactly this shape; REF_BATCH
# must be a grid point so ``perf`` is a column of the curve, not an
# interpolation.
BATCH_GRID: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card peak rates the analytic roofline model divides by."""
    peak_flops: float               # dense FLOP/s in the serving dtype
    hbm_bw: float                   # device-memory bytes/s


# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth.
H100_SXM = HardwareSpec(peak_flops=989e12, hbm_bw=3.35e12)


@dataclasses.dataclass
class NodeProfile:
    """A worker group: ``chips`` accelerator cards with a capability derate.

    ``capability`` < 1 models thermal/power throttling (the paper's
    DVFS-under-TDP) or an older chip generation; the Dispatch Policy only
    ever sees the resulting throughput numbers, exactly as in the paper.
    """
    name: str
    chips: int
    capability: float = 1.0
    available: bool = True


def variant_item_cost(cfg: ModelConfig, seq_len: int,
                      batch: int = REF_BATCH) -> Dict[str, float]:
    """Analytic per-item (one sequence) cost of an inference: FLOPs and HBM
    bytes. Inference = prefill of seq_len tokens (paper counts one image =
    one inference; here one sequence = one inference).

    ``batch`` is the engine batch the item is served in: the weights are
    streamed once per *batch*, so the per-item weight bytes divide by it
    (the paper's edge boards amortize exactly this way). ``batch=1`` is
    the un-amortized cost; the old hard-coded "standard serving batch of
    8" is ``batch=REF_BATCH`` (bit-identical arithmetic).
    """
    assert batch >= 1, "engine batch must be >= 1"
    n_active = cfg.param_count(active_only=True)
    flops = 2.0 * n_active * seq_len
    # attention extra: 4*S^2*H*D per layer (causal halves it)
    s = seq_len
    attn = 0.0
    for i in range(cfg.num_layers):
        if not cfg.layer_is_attn(i):
            continue
        eff_s = min(s, cfg.sliding_window) if (
            cfg.attention_kind == "sliding"
            or (cfg.attention_kind == "local_global"
                and not cfg.layer_is_global_attn(i))) else s
        attn += 2.0 * s * eff_s * cfg.num_heads * cfg.head_dim
    flops += attn
    bytes_ = 2.0 * n_active  # weights streamed once per engine batch,
    # amortised across the batch's items; KV/activation traffic is per item
    bytes_ = bytes_ / batch + 2.0 * 2 * s * cfg.num_layers * cfg.kv_dim
    return {"flops": flops, "bytes": bytes_}


def throughput_from_cost(cost: Dict[str, float], chips: int,
                         capability: float,
                         hw: HardwareSpec = H100_SXM) -> float:
    """Roofline items/s from a precomputed per-item cost — the cost is
    per *variant*, so table builds hoist it out of the per-node loop.
    ``chips`` is the node's card count; ``hw`` the per-card peaks."""
    t_compute = cost["flops"] / (hw.peak_flops * chips * capability)
    t_memory = cost["bytes"] / (hw.hbm_bw * chips * capability)
    return 1.0 / max(t_compute, t_memory)


def analytic_throughput(cfg: ModelConfig, seq_len: int, chips: int,
                        capability: float,
                        batch: int = REF_BATCH,
                        hw: HardwareSpec = H100_SXM) -> float:
    """Roofline-model items/s for one node running this variant at one
    engine batch size."""
    return throughput_from_cost(variant_item_cost(cfg, seq_len, batch),
                                chips, capability, hw)


def interp_throughput(curve: np.ndarray, grid: Sequence[int],
                      batch: int) -> np.ndarray:
    """Throughput at ``batch`` from batch-curve columns.

    ``curve[..., i]`` is the throughput at ``grid[i]``; off-grid batches
    interpolate the *per-item time* linearly in 1/batch between the
    bracketing grid points — exact for the memory-bound roofline segment
    (per-item bytes are affine in 1/batch) and monotonicity-preserving
    everywhere. Batches beyond the grid clamp to the end points.
    """
    grid = tuple(grid)
    assert curve.shape[-1] == len(grid)
    if batch <= grid[0]:
        return curve[..., 0]
    if batch >= grid[-1]:
        return curve[..., -1]
    for i, g in enumerate(grid):
        if g == batch:
            return curve[..., i]
        if g > batch:
            b0, b1 = grid[i - 1], g
            w = (1.0 / b0 - 1.0 / batch) / (1.0 / b0 - 1.0 / b1)
            tau = (1.0 - w) / curve[..., i - 1] + w / curve[..., i]
            return 1.0 / tau
    raise AssertionError("unreachable")


def batched_service_s(items: int, curve_row: np.ndarray,
                      grid: Sequence[int], max_batch: int) -> float:
    """Service seconds for ``items`` items through one (level, node)
    batch curve at engine-batch cap ``max_batch``: full engine batches
    run at the cap's throughput, the tail (items % max_batch) runs as a
    partial batch at its own (smaller) batch's throughput. This is the
    exact decomposition the batch-aware node runtime realizes, so plans
    priced with it predict the runtime's timings."""
    if items <= 0:
        return 0.0
    if max_batch <= 1:
        # batching disabled: the scalar REF_BATCH column, i.e. the
        # pre-batching model — byte-identical to the legacy path
        ref = grid.index(REF_BATCH) if isinstance(grid, (list, tuple)) \
            else list(grid).index(REF_BATCH)
        return items / max(float(curve_row[ref]), 1e-9)
    full, rem = divmod(int(items), int(max_batch))
    t = 0.0
    if full:
        t += full * max_batch / max(
            float(interp_throughput(curve_row, grid, max_batch)), 1e-9)
    if rem:
        t += rem / max(
            float(interp_throughput(curve_row, grid, rem)), 1e-9)
    return t


class ProfilingTable:
    """profiling_table[m][n] — throughput of node n at approximation m.

    ``perf`` is the scalar (levels, nodes) matrix every pre-batching
    consumer reads: the batch curve at :data:`REF_BATCH`. ``perf_b`` is
    the full (levels, nodes, batches) curve over ``batch_grid``; the
    batch-aware runtime and planners read it through
    :meth:`throughput` / :meth:`batch_curve`. Every mutation keeps the
    two views consistent and bumps ``version`` exactly once.
    """

    def __init__(self, pool: VariantPool, nodes: Sequence[NodeProfile],
                 seq_len: int = 128,
                 measured: Optional[np.ndarray] = None,
                 batch_grid: Sequence[int] = BATCH_GRID,
                 hw: HardwareSpec = H100_SXM):
        self.pool = pool
        self.hw = hw
        self.nodes = list(nodes)
        self.seq_len = seq_len
        self.batch_grid: Tuple[int, ...] = tuple(batch_grid)
        assert REF_BATCH in self.batch_grid, (
            f"batch_grid must contain REF_BATCH={REF_BATCH}: the scalar "
            "perf matrix is that column of the curve")
        assert all(b2 > b1 for b1, b2 in zip(self.batch_grid,
                                             self.batch_grid[1:])), (
            "batch_grid must be strictly increasing")
        self._ref_idx = self.batch_grid.index(REF_BATCH)
        m, n = len(pool), len(self.nodes)
        # per-(level, batch) unit curve (chips=1, capability=1): node
        # constants scale compute and memory terms identically, so one
        # unit curve per level serves every node (and calibrates the
        # curve shape of measured columns, which profile REF_BATCH only)
        unit = np.zeros((m, len(self.batch_grid)))
        for i, v in enumerate(pool.variants):
            for bi, b in enumerate(self.batch_grid):
                unit[i, bi] = throughput_from_cost(
                    variant_item_cost(v.config, seq_len, b), 1, 1.0, hw)
        self._unit_ratio = unit / unit[:, self._ref_idx][:, None]
        if measured is not None:
            assert measured.shape == (m, n)
            self.perf = np.asarray(measured, dtype=np.float64)
            # measured columns profile the REF_BATCH throughput; the
            # curve shape comes from the analytic amortization ratio
            self.perf_b = (self.perf[:, :, None]
                           * self._unit_ratio[:, None, :])
        else:
            self.perf = np.zeros((m, n))
            self.perf_b = np.zeros((m, n, len(self.batch_grid)))
            for i, v in enumerate(pool.variants):
                cost = variant_item_cost(v.config, seq_len)
                costs_b = [variant_item_cost(v.config, seq_len, b)
                           for b in self.batch_grid]
                for j, node in enumerate(self.nodes):
                    self.perf[i, j] = throughput_from_cost(
                        cost, node.chips, node.capability, hw)
                    for bi, cb in enumerate(costs_b):
                        self.perf_b[i, j, bi] = throughput_from_cost(
                            cb, node.chips, node.capability, hw)
        self.accuracies = np.asarray(pool.accuracies)
        # pristine copy: what a fresh PROFILE of each node would measure.
        # reprofile_node restores from it when a node (re)joins the serving
        # set, erasing stale runtime decay (straggler EWMA) from a past life.
        self._pristine = self.perf.copy()
        self._pristine_b = self.perf_b.copy()
        # monotone counter bumped on every perf mutation; snapshot and
        # planner caches key on it so they refresh exactly when the table
        # actually changed (every mutation goes through the methods below)
        self.version = 0

    @property
    def num_levels(self) -> int:
        return self.perf.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.perf.shape[1]

    def update_node(self, j: int, column: np.ndarray):
        """NetCom state: merge a (re-)profiled column from node j. A
        profiled column is ground truth, so the pristine copy tracks it.
        The column profiles REF_BATCH throughput; the batch curve
        rescales level-wise (a same-valued column — the startup NETCOM
        gather — multiplies by exactly 1.0 and leaves the curve bits
        untouched), falling back to the analytic curve shape for levels
        profiled from zero."""
        column = np.asarray(column, dtype=np.float64)
        old = self.perf[:, j].copy()
        self.perf[:, j] = column
        self._pristine[:, j] = column
        ratio = np.divide(column, old, out=np.zeros_like(column),
                          where=old > 0)
        self.perf_b[:, j, :] *= ratio[:, None]
        fresh = (old <= 0) & (column > 0)
        if fresh.any():
            self.perf_b[fresh, j, :] = (column[fresh, None]
                                        * self._unit_ratio[fresh, :])
        self._pristine_b[:, j, :] = self.perf_b[:, j, :]
        self.version += 1

    def scale_node(self, j: int, factor: float):
        """Straggler mitigation: EWMA capability decay observed at runtime.
        A capability derate scales every batch point identically."""
        self.perf[:, j] *= factor
        self.perf_b[:, j, :] *= factor
        self.version += 1

    def reprofile_node(self, j: int):
        """Re-run node j's PROFILE step on (re)join: restore the pristine
        measured/analytic column so stale EWMA decay does not outlive the
        node's previous membership."""
        self.perf[:, j] = self._pristine[:, j]
        self.perf_b[:, j, :] = self._pristine_b[:, j, :]
        self.version += 1

    def available_columns(self, avail: Sequence[bool]) -> np.ndarray:
        return self.perf[:, np.asarray(avail, dtype=bool)]

    # ---- batch-curve views -------------------------------------------
    def throughput(self, level: int, j: int, batch: int) -> float:
        """Items/s of node j at approximation ``level`` when the engine
        serves batches of ``batch`` items (interpolated off-grid)."""
        return float(interp_throughput(self.perf_b[level, j],
                                       self.batch_grid, batch))

    def batch_curve(self, level: int, j: int) -> np.ndarray:
        """The (batches,) throughput curve of one (level, node) cell."""
        return self.perf_b[level, j]

    def perf_at_batch(self, batch: int) -> np.ndarray:
        """The (levels, nodes) throughput matrix at one engine batch."""
        return np.asarray(interp_throughput(self.perf_b, self.batch_grid,
                                            batch))
