"""The port's control plane against the JAX package's: the admission gate
(global and per-tenant token buckets, degrade / reject), the autoscaler's
actions and the fair-share scheduler, each driven by the same request
sequence in both packages, with every decision compared exactly."""
import numpy as np
import pytest

from _torch_host_util import PACKAGES, canon, pkg, table

TENANTS = ("acme", "bolt", "cargo")


def _requests(ns, n, seed, *, spread_s=4.0):
    """``n`` arrivals in time order: sizes, targets, deadlines, SLO classes
    and tenants drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, spread_s, n))
    out = []
    for i in range(n):
        items = int(rng.integers(20, 650))
        perf = float(rng.uniform(500.0, 16000.0))
        out.append(ns.requests.InferenceRequest(
            rid=i, num_items=items, perf_req=perf,
            acc_req=float(rng.uniform(80.0, 96.0)),
            arrival_s=float(times[i]),
            deadline_s=float(rng.uniform(0.5, 2.0)) * items / perf,
            slo_class=("strict" if rng.random() < 0.25 else "degradable"),
            tenant=TENANTS[int(rng.integers(0, len(TENANTS)))]))
    return out


def _backlogs(rng, names):
    return {n: float(rng.choice([0.0, rng.exponential(0.05),
                                 rng.exponential(0.5)])) for n in names}


# ---- token bucket ------------------------------------------------------
@pytest.mark.parametrize("rate,burst", [(None, 8.0), (1.0, 1.0),
                                        (3.5, 2.0), (1000.0, 4.0)])
def test_token_bucket(rate, burst):
    def drive(ns):
        rng = np.random.default_rng(11)
        b = ns.admission.TokenBucket(rate, burst)
        now, out = float(rng.uniform(0.0, 50.0)), []
        for _ in range(200):
            now += float(rng.choice([0.0, 0.01, rng.exponential(0.4)]))
            out.append((b.try_take(now), repr(b.peek(now))))
        return out
    assert drive(pkg("repro_torch")) == drive(pkg("repro"))


# ---- admission ---------------------------------------------------------
ADMISSION_CASES = {
    "gate-only": dict(),
    "global-bucket": dict(rate=6.0, burst=2.0),
    "tenant-buckets": dict(tenant_rates={"acme": 2.0, "bolt": 9.0},
                           tenant_rate=4.0, tenant_burst=1.0),
    "global-and-tenant": dict(rate=12.0, burst=3.0,
                              tenant_rates={"cargo": 1.5}),
    "no-degrade": dict(degrade=False),
    "uniform-apx-margin": dict(policy="uniform_apx",
                               feasibility_margin=0.1),
    "asymmetric-uncached": dict(policy="asymmetric", plan_cache=False),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_decisions(case):
    kw = ADMISSION_CASES[case]

    def drive(ns):
        tb = table(ns)
        gate = ns.admission.AdmissionController(tb, **kw)
        rng = np.random.default_rng(5)
        names = [n.name for n in tb.nodes]
        out = []
        for req in _requests(ns, 160, seed=7):
            # the gate sometimes runs after the arrival (a fair queue's wait)
            now = req.arrival_s + float(rng.choice([0.0, 0.0, 0.05]))
            state = ns.sched.ClusterState.from_table(
                tb, now=now, backlogs=_backlogs(rng, names))
            d = gate.decide(req, state)
            out.append(canon(d))
        tenant_tokens = {t: repr(b.peek(5.0))
                         for t, b in gate.tenant_buckets.items()}
        return out, dict(gate.counts), tenant_tokens, (
            gate.plan_cache_hits, gate.plan_cache_misses)

    got, want = drive(pkg("repro_torch")), drive(pkg("repro"))
    outcomes = {d[1][1] for d in want[0]}
    assert len(outcomes) >= 2, outcomes       # the case exercises the gate
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert a == b, f"decision {i} differs"
    assert got == want


def test_admission_paths_all_reached():
    """Across the cases every outcome and every reason of the gate shows,
    so the comparisons above cover each branch of ``decide``."""
    reasons = set()
    ns = pkg("repro_torch")
    for kw in ADMISSION_CASES.values():
        tb = table(ns)
        gate = ns.admission.AdmissionController(tb, **kw)
        rng = np.random.default_rng(5)
        for req in _requests(ns, 160, seed=7):
            state = ns.sched.ClusterState.from_table(
                tb, now=req.arrival_s,
                backlogs=_backlogs(rng, [n.name for n in tb.nodes]))
            d = gate.decide(req, state)
            reasons.add((d.outcome, d.reason))
    assert {o for o, _ in reasons} == {"admit", "degrade", "reject"}
    assert {"queue_wait_exceeds_budget", "infeasible_at_max_approximation",
            "slo_needs_degraded_service", "rate_limited",
            "tenant_rate_limited"} <= {r for _, r in reasons}


# ---- autoscaler --------------------------------------------------------
AUTOSCALER_CASES = {
    "defaults": dict(),
    "fast": dict(scale_up_backlog_s=0.3, scale_down_backlog_s=0.05,
                 cooldown_s=0.5, warmup_s=0.25, min_window=4, window=8),
    "violation-driven": dict(scale_up_backlog_s=5.0, violation_rate_hi=0.2,
                             violation_rate_lo=0.1, cooldown_s=1.0,
                             warmup_s=0.5, min_window=4, window=16),
}


@pytest.mark.parametrize("case", sorted(AUTOSCALER_CASES))
def test_autoscaler_actions(case):
    kw = AUTOSCALER_CASES[case]

    def drive(ns):
        tb = table(ns, ns.cluster.synthetic_fleet(8, seed=2, num_standby=3))
        standby = [n.name for n in tb.nodes if not n.available]
        asc = ns.autoscaler.Autoscaler(tb, standby, **kw)
        rng = np.random.default_rng(13)
        names = [n.name for n in tb.nodes]
        warming, out, now, released = {}, [], 0.0, None
        for step in range(300):
            now += float(rng.exponential(0.1))
            for node, ready in sorted(warming.items()):
                if ready <= now:
                    del warming[node]
                    asc.on_ready(node)
            # load comes in waves so both scale-up and scale-down fire
            hot = (step // 60) % 2 == 0
            for _ in range(int(rng.integers(0, 4))):
                asc.record_outcome(bool(rng.random() < (0.6 if hot
                                                        else 0.995)))
            scale = 2.0 if hot else 0.02
            backlogs = {n: float(rng.exponential(scale)) for n in names}
            # a cell gives a pooled node away and takes it back
            if step == 150:
                released = asc.release_standby()
                out.append(("released", released))
            if step == 170 and released is not None:
                asc.adopt_standby(released)
            a = asc.evaluate(ns.sched.ClusterState.from_table(
                tb, now=now, backlogs=backlogs))
            if a is not None:
                out.append(canon(a))
                if a.kind == "spawn":
                    warming[a.node] = a.ready_s
            out.append((asc.ready(now), repr(asc.violation_rate()),
                        asc.pending, tuple(asc.standby)))
        return out, canon(asc.summary())

    got, want = drive(pkg("repro_torch")), drive(pkg("repro"))
    kinds = [x[1][1] for x in want[0]
             if isinstance(x, tuple) and x and x[0] == "ScalingAction"]
    assert {"spawn", "retire"} <= set(kinds)
    assert got == want


# ---- fair share --------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_weighted_max_min(seed):
    rng = np.random.default_rng(seed)
    tenants = [f"t{i}" for i in range(int(rng.integers(1, 7)))]
    demands = {t: float(rng.choice([0.0, rng.uniform(0, 900)]))
               for t in tenants}
    weights = {t: float(rng.uniform(0.2, 4.0)) for t in tenants[1:]}
    cap = float(rng.uniform(10.0, 2000.0))
    got = pkg("repro_torch").fairshare.weighted_max_min(demands, weights, cap)
    want = pkg("repro").fairshare.weighted_max_min(demands, weights, cap)
    assert list(got) == list(want)
    for t in want:
        assert got[t] == pytest.approx(want[t], rel=1e-9, abs=0.0)
        assert repr(got[t]) == repr(want[t])


FAIRSHARE_CASES = {
    "ordering-only": dict(weights={"acme": 1.0, "bolt": 2.0}),
    "capped": dict(weights={"acme": 3.0, "bolt": 1.0, "cargo": 1.0},
                   max_outstanding_items=650),
    "small-quantum": dict(weights={"cargo": 0.5}, quantum_items=64,
                          max_outstanding_items=900),
}


@pytest.mark.parametrize("case", sorted(FAIRSHARE_CASES))
def test_fairshare_release_order(case):
    kw = FAIRSHARE_CASES[case]

    def drive(ns):
        fs = ns.fairshare.FairShareScheduler(**kw)
        reqs = _requests(ns, 200, seed=21)
        rng = np.random.default_rng(3)
        inflight, out, k = [], [], 0
        while k < len(reqs) or fs.pending_total:
            for _ in range(int(rng.integers(0, 5))):
                if k < len(reqs):
                    fs.enqueue(reqs[k])
                    k += 1
            while True:
                r = fs.next_request()
                if r is None:
                    break
                out.append((r.rid, r.tenant))
                if rng.random() < 0.8:          # the gate admitted it
                    fs.on_admitted(r.tenant, r.num_items)
                    inflight.append(r)
            for _ in range(int(rng.integers(0, 3))):
                if inflight:
                    r = inflight.pop(int(rng.integers(0, len(inflight))))
                    fs.on_done(r.tenant, r.num_items)
            out.append(("backlog", canon(fs.backlog())))
            if k >= len(reqs) and not inflight and fs.pending_total \
                    and fs.next_request() is None:
                break
        return out

    got, want = drive(pkg("repro_torch")), drive(pkg("repro"))
    assert sum(1 for x in want if x[0] != "backlog") > 100
    assert got == want


def test_packages_are_distinct():
    """The comparisons above really hold two implementations side by side."""
    a, b = (pkg(name) for name in PACKAGES)
    assert a.admission.AdmissionController is not \
        b.admission.AdmissionController
    assert b.admission.__name__.startswith("repro_torch.")
