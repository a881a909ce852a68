"""Request arrival processes for the online serving simulator.

All processes are materialised up-front from a seeded ``numpy`` generator,
so a (process, seed) pair always yields the identical timed request trace —
the property the determinism tests pin down.

The request *contents* (num_items, perf_req, acc_req, deadline) come from a
``RequestSampler`` calibrated against a ProfilingTable, mirroring how the
offline benchmarks draw their traces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiling import ProfilingTable
from repro_torch.core.requests import (DEFAULT_TENANT, SLO_DEGRADABLE, SLO_STRICT,
                                 InferenceRequest)

Arrival = Tuple[float, InferenceRequest]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of a multi-tenant arrival mix.

    ``weight`` is the tenant's share of the *offered arrival stream*
    (relative to the other specs' weights) — how much it sends, not how
    much it deserves. ``share`` is its fair-share entitlement for the
    gateway's DRR scheduler; None means equal entitlement (1.0)
    regardless of arrival mix, which is exactly how a noisy neighbor is
    contained: it may offer 75% of the traffic but is still owed one
    equal slice. The optional overrides replace the sampler's defaults
    for this tenant's requests only: ``strict_frac`` marks that
    fraction SLO-strict, ``deadline_slack`` tightens/loosens the
    derived latency budget, and ``rate_limit`` is a per-tenant
    token-bucket refill rate for the admission gate (None = no
    per-tenant shaping). ``abusive`` is *scenario metadata* — it tags
    which tenant a noisy-neighbor benchmark treats as the aggressor so
    reports can single out the victims; the serving stack itself never
    reads it (the gateway must protect victims without being told who
    the abuser is).
    """
    name: str
    weight: float = 1.0
    share: Optional[float] = None
    strict_frac: Optional[float] = None
    deadline_slack: Optional[float] = None
    rate_limit: Optional[float] = None
    abusive: bool = False

    def __post_init__(self):
        assert self.name, "tenant name must be non-empty"
        assert self.weight > 0, "tenant weight must be positive"
        assert self.share is None or self.share > 0, (
            "fair-share entitlement must be positive (or None = equal)")

    @property
    def fair_share(self) -> float:
        """DRR weight: explicit ``share`` or equal entitlement."""
        return self.share if self.share is not None else 1.0


@dataclasses.dataclass
class RequestSampler:
    """Draws paper-style requests scaled to a cluster's capacity.

    ``perf_req`` is drawn between the full-accuracy cluster capacity (so
    some approximation is always required) and ~the max-approximation
    capacity, exactly like benchmarks/run.py's fig-8 trace; the deadline is
    the request's own implied service time times ``deadline_slack``.
    """
    table: ProfilingTable
    item_choices: Sequence[int] = (260, 390, 520, 650)
    perf_lo_frac: float = 1.02    # x full-accuracy capacity
    perf_hi_frac: float = 0.95    # x max-approximation per-node-min capacity
    acc_range: Tuple[float, float] = (87.0, 90.0)
    deadline_slack: float = 1.5
    # fraction of requests carrying the SLO-``strict`` class (the gate may
    # shed but never degrade them). 0 draws nothing from the RNG, so the
    # default keeps every pre-existing seeded trace bit-identical.
    strict_frac: float = 0.0
    # scales the capacity the perf_req draw is calibrated against. The
    # default sizes every request for the *whole* serving set — right for
    # one gateway planning fleet-wide, infeasible under a sharded control
    # plane where each request lands on one cell's slice. The fleet-1024+
    # scenarios set this to ~cell_size/fleet_size so requests are sized
    # for the group that actually serves them. 1.0 multiplies exactly
    # (IEEE), keeping all pre-existing seeded traces bit-identical.
    capacity_frac: float = 1.0
    # multi-tenant arrival mix: each request draws its tenant from these
    # specs' weights, then applies that tenant's strict_frac /
    # deadline_slack overrides. With zero or one spec *no extra RNG is
    # consumed* — the stream (and therefore every pre-existing seeded
    # trace) stays bit-identical; a single spec just renames the tenant.
    tenants: Tuple["TenantSpec", ...] = ()

    def _perf_bounds(self):
        """(lo, hi) perf_req draw bounds, cached on (availability, table
        version) — trace generation samples thousands of requests against
        one static cluster, so the numpy reductions run once, not per
        request. Identical values to computing them inline."""
        key = (tuple(n.available for n in self.table.nodes),
               getattr(self.table, "version", None))
        cached = getattr(self, "_bounds_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        # calibrate against the *serving* (available) nodes only: standby
        # slices waiting on the autoscaler must not inflate the implied
        # capacity of the cluster the request actually lands on
        cols = [j for j, n in enumerate(self.table.nodes) if n.available]
        cols = cols or list(range(self.table.num_nodes))
        lo = self.table.perf[0, cols].sum() * self.capacity_frac
        cap = self.table.perf[-1, cols].min() * len(cols) \
            * self.capacity_frac
        hi = max(cap * self.perf_hi_frac, lo * self.perf_lo_frac * 1.01)
        self._bounds_cache = (key, lo, hi)
        return lo, hi

    def _draw_tenant(self, rng: np.random.Generator) -> "TenantSpec":
        """Pick this request's tenant by mix weight. Only called with
        >= 2 specs, so single-tenant streams never consume the draw."""
        weights = [t.weight for t in self.tenants]
        total = sum(weights)
        # detlint: ok[DET005] guarded: only reached with >= 2 TenantSpecs, so 0/1-spec streams never consume this draw
        u = float(rng.uniform()) * total
        acc = 0.0
        for spec in self.tenants:
            acc += spec.weight
            if u < acc:
                return spec
        return self.tenants[-1]

    def sample(self, rng: np.random.Generator, rid: int,
               arrival_s: float) -> InferenceRequest:
        lo, hi = self._perf_bounds()
        # detlint: ok[DET005] pre-tenancy draw #1; order and count pinned by tests/golden/sim_digest.json
        num_items = int(rng.choice(self.item_choices))
        # detlint: ok[DET005] pre-tenancy draw #2; order and count pinned by tests/golden/sim_digest.json
        perf_req = float(rng.uniform(lo * self.perf_lo_frac, hi))
        # detlint: ok[DET005] pre-tenancy draw #3; order and count pinned by tests/golden/sim_digest.json
        acc_req = float(rng.uniform(*self.acc_range))
        tenant = DEFAULT_TENANT
        strict_frac = self.strict_frac
        slack = self.deadline_slack
        if len(self.tenants) == 1:
            spec = self.tenants[0]          # rename only: no extra draw
        elif self.tenants:
            spec = self._draw_tenant(rng)
        else:
            spec = None
        if spec is not None:
            tenant = spec.name
            if spec.strict_frac is not None:
                strict_frac = spec.strict_frac
            if spec.deadline_slack is not None:
                slack = spec.deadline_slack
        slo_class = SLO_DEGRADABLE
        # detlint: ok[DET005] pre-tenancy draw #4, conditionally skipped exactly as before tenancy (strict_frac > 0 is spec-independent for 0/1 specs)
        if strict_frac > 0 and rng.uniform() < strict_frac:
            slo_class = SLO_STRICT
        return InferenceRequest(
            rid=rid, num_items=num_items, perf_req=perf_req,
            acc_req=acc_req, arrival_s=arrival_s,
            deadline_s=slack * num_items / perf_req,
            slo_class=slo_class, tenant=tenant)


class ArrivalProcess:
    """Base: generate() returns the full (time, request) trace."""

    def generate(self) -> List[Arrival]:
        raise NotImplementedError


class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process at ``rate`` req/s until ``horizon_s``."""

    def __init__(self, rate: float, horizon_s: float,
                 sampler: RequestSampler, seed: int = 0):
        assert rate > 0 and horizon_s > 0
        self.rate = rate
        self.horizon_s = horizon_s
        self.sampler = sampler
        self.seed = seed

    def generate(self) -> List[Arrival]:
        rng = np.random.default_rng(self.seed)
        out: List[Arrival] = []
        t, rid = 0.0, 0
        while True:
            # detlint: ok[DET005] inter-arrival draw is tenant-independent; pinned by the golden digests
            t += float(rng.exponential(1.0 / self.rate))
            if t >= self.horizon_s:
                break
            out.append((t, self.sampler.sample(rng, rid, t)))
            rid += 1
        return out


class DiurnalArrivals(ArrivalProcess):
    """Non-homogeneous Poisson: rate(t) = base * (1 + amp*sin(2πt/period)),
    generated by Lewis thinning against the peak rate."""

    def __init__(self, base_rate: float, horizon_s: float,
                 sampler: RequestSampler, seed: int = 0,
                 amplitude: float = 0.8, period_s: Optional[float] = None):
        assert 0 <= amplitude < 1.0001
        self.base_rate = base_rate
        self.horizon_s = horizon_s
        self.sampler = sampler
        self.seed = seed
        self.amplitude = amplitude
        self.period_s = period_s if period_s is not None else horizon_s

    def rate_at(self, t: float) -> float:
        return self.base_rate * (
            1.0 + self.amplitude * math.sin(2 * math.pi * t / self.period_s))

    def generate(self) -> List[Arrival]:
        rng = np.random.default_rng(self.seed)
        peak = self.base_rate * (1.0 + self.amplitude)
        out: List[Arrival] = []
        t, rid = 0.0, 0
        while True:
            # detlint: ok[DET005] inter-arrival draw is tenant-independent; pinned by the golden digests
            t += float(rng.exponential(1.0 / peak))
            if t >= self.horizon_s:
                break
            # detlint: ok[DET005] thinning draw is tenant-independent; pinned by the golden digests
            if rng.uniform() * peak <= self.rate_at(t):   # thinning accept
                out.append((t, self.sampler.sample(rng, rid, t)))
                rid += 1
        return out


class BurstArrivals(ArrivalProcess):
    """Flash crowd: homogeneous base rate with a rectangular burst window
    at ``peak_rate`` between ``burst_start_s`` and ``burst_end_s``,
    generated by thinning against the peak (same machinery as the diurnal
    process, so a (process, seed) pair stays deterministic)."""

    def __init__(self, base_rate: float, peak_rate: float,
                 burst_start_s: float, burst_end_s: float,
                 horizon_s: float, sampler: RequestSampler, seed: int = 0):
        assert 0 < base_rate <= peak_rate
        assert 0 <= burst_start_s < burst_end_s <= horizon_s
        self.base_rate = base_rate
        self.peak_rate = peak_rate
        self.burst_start_s = burst_start_s
        self.burst_end_s = burst_end_s
        self.horizon_s = horizon_s
        self.sampler = sampler
        self.seed = seed

    def rate_at(self, t: float) -> float:
        if self.burst_start_s <= t < self.burst_end_s:
            return self.peak_rate
        return self.base_rate

    def generate(self) -> List[Arrival]:
        rng = np.random.default_rng(self.seed)
        out: List[Arrival] = []
        t, rid = 0.0, 0
        while True:
            # detlint: ok[DET005] inter-arrival draw is tenant-independent; pinned by the golden digests
            t += float(rng.exponential(1.0 / self.peak_rate))
            if t >= self.horizon_s:
                break
            # detlint: ok[DET005] thinning draw is tenant-independent; pinned by the golden digests
            if rng.uniform() * self.peak_rate <= self.rate_at(t):
                out.append((t, self.sampler.sample(rng, rid, t)))
                rid += 1
        return out


class TraceArrivals(ArrivalProcess):
    """Replay an explicit (time, request) trace — tests and real logs."""

    def __init__(self, arrivals: Sequence[Arrival]):
        self.arrivals = sorted(arrivals, key=lambda a: a[0])
        for t, r in self.arrivals:
            assert abs(r.arrival_s - t) < 1e-9, (
                f"request {r.rid}: arrival_s={r.arrival_s} != trace time {t}")

    def generate(self) -> List[Arrival]:
        return list(self.arrivals)

    # serving-log fields -> InferenceRequest; everything but the arrival
    # time and the item count is optional with serving-shaped defaults
    _FIELDS = ("arrival_s", "num_items", "seq_len", "slo_class",
               "perf_req", "acc_req", "deadline_s", "rid")

    @classmethod
    def from_file(cls, path: str, *, deadline_slack: float = 1.5,
                  default_perf_req: float = 0.0,
                  default_acc_req: float = 0.0) -> "TraceArrivals":
        """Load a serving log as a replayable trace.

        Accepts CSV (with a header row) or JSONL (one object per line),
        chosen by extension (``.jsonl``/``.ndjson`` vs anything else).
        Required fields per record: ``arrival_s`` and ``num_items``.
        Optional: ``seq_len`` (default 128), ``slo_class``
        (``strict``/``degradable``, default degradable), ``perf_req``,
        ``acc_req``, ``deadline_s``, ``rid`` (default: line order).
        When ``deadline_s`` is absent but ``perf_req`` is given, the
        deadline derives like the synthetic samplers':
        ``deadline_slack * num_items / perf_req``.
        """
        rows: List[dict] = []
        lower = path.lower()
        if lower.endswith((".jsonl", ".ndjson")):
            import json
            with open(path) as f:
                for ln, line in enumerate(f):
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    assert isinstance(rec, dict), (
                        f"{path}:{ln + 1}: expected a JSON object")
                    rows.append(rec)
        else:
            import csv
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                assert reader.fieldnames, f"{path}: missing CSV header"
                unknown = set(reader.fieldnames) - set(cls._FIELDS)
                assert not unknown, (
                    f"{path}: unknown column(s) {sorted(unknown)}; "
                    f"have {cls._FIELDS}")
                rows.extend(reader)
        def field(rec, key, default):
            v = rec.get(key)
            return default if v is None or v == "" else v

        arrivals: List[Arrival] = []
        for i, rec in enumerate(rows):
            assert field(rec, "arrival_s", None) is not None \
                and field(rec, "num_items", None) is not None, (
                    f"{path}: record {i} needs arrival_s and num_items")
            t = float(rec["arrival_s"])
            num_items = int(rec["num_items"])
            perf_req = float(field(rec, "perf_req", default_perf_req))
            deadline = float(field(rec, "deadline_s", 0.0))
            if deadline <= 0.0 and perf_req > 0:
                deadline = deadline_slack * num_items / perf_req
            req = InferenceRequest(
                rid=int(field(rec, "rid", i)),
                num_items=num_items,
                perf_req=perf_req,
                acc_req=float(field(rec, "acc_req", default_acc_req)),
                seq_len=int(field(rec, "seq_len", 128)),
                arrival_s=t,
                deadline_s=deadline,
                slo_class=str(field(rec, "slo_class", SLO_DEGRADABLE)))
            arrivals.append((t, req))
        return cls(arrivals)
