"""The port's sharded-control-plane cell logic (``sched.shard``) and the
legacy dispatch shim (``core.dispatch``) against the JAX package's, on the
same fleets, tables and requests: assignments exact, floats within 1e-9
relative."""
import numpy as np
import pytest

from _torch_host_util import canon, pkg, table

PORT, REF = pkg("repro_torch"), pkg("repro")
FLEETS = {"fleet-9/standby-3": (9, 3), "fleet-16": (16, 0),
          "fleet-40/standby-5": (40, 5)}


def _fleet(ns, name, seed=4):
    n, standby = FLEETS[name]
    return ns.cluster.synthetic_fleet(n, seed=seed, num_standby=standby)


# ---- partition_fleet ---------------------------------------------------
@pytest.mark.parametrize("strategy", ["stripe", "by-class"])
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_partition_fleet(fleet, strategy):
    for cells in (1, 2, 3, 5, 9):
        got = PORT.shard.partition_fleet(_fleet(PORT, fleet), cells, strategy)
        want = REF.shard.partition_fleet(_fleet(REF, fleet), cells, strategy)
        assert canon(got) == canon(want)
        assert sum(len(s.nodes) for s in got) == sum(
            p.available for p in _fleet(PORT, fleet))


def test_partition_fleet_rejects_what_the_reference_rejects():
    profiles = _fleet(PORT, "fleet-16")
    for bad in ((0, "stripe"), (17, "stripe"), (2, "hash")):
        with pytest.raises(AssertionError):
            PORT.shard.partition_fleet(profiles, *bad)
        with pytest.raises(AssertionError):
            REF.shard.partition_fleet(_fleet(REF, "fleet-16"), *bad)


# ---- CellRouter --------------------------------------------------------
@pytest.mark.parametrize("policy", ["least-backlog", "rendezvous"])
@pytest.mark.parametrize("cells", [1, 3, 6])
def test_cell_router(policy, cells):
    def drive(ns):
        specs = ns.shard.partition_fleet(_fleet(ns, "fleet-40/standby-5"),
                                         cells, "by-class")
        rng = np.random.default_rng(cells)
        caps = (None if cells == 3
                else [float(rng.uniform(1.0, 20.0)) for _ in specs])
        router = ns.shard.CellRouter(specs, policy=policy, capacities=caps)
        routed, out = [], []
        for rid in range(400):
            req = ns.requests.InferenceRequest(
                rid=rid, num_items=int(rng.integers(10, 650)),
                perf_req=100.0, acc_req=0.0,
                tenant=("acme", "bolt", "cargo")[rid % 3])
            c = router.route(req)
            routed.append((c, req))
            out.append(c)
            while routed and rng.random() < 0.45:
                cell, r = routed.pop(int(rng.integers(0, len(routed))))
                router.settle(cell, r.num_items,
                              r.tenant if rng.random() < 0.7 else None)
            out.append(canon(router.loads()))
            out.append(canon(router.loads_by_tenant()))
        return out, canon(router.outstanding)

    got, want = drive(PORT), drive(REF)
    assert got == want
    assert len(set(got[0][::3])) == cells


@pytest.mark.parametrize("seed", range(8))
def test_pick_rebalance(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 7))
        # coarse values so ties between cells are common
        loads = [float(rng.integers(0, 6)) / 2.0 for _ in range(n)]
        gap = float(rng.choice([0.0, 0.5, 1.0, 2.5]))
        assert PORT.shard.pick_rebalance(loads, min_gap=gap) == \
            REF.shard.pick_rebalance(loads, min_gap=gap)


# ---- core.dispatch -----------------------------------------------------
def _dispatch_requests(ns, tb, n=24, seed=0):
    """Requests spanning the table's span from full accuracy to the
    deepest approximation, with accuracy floors across the ladder."""
    rng = np.random.default_rng(seed)
    lo, hi = tb.perf[0].sum(), tb.perf[-1].sum()
    return [ns.requests.InferenceRequest(
        rid=i, num_items=int(rng.integers(1, 1200)),
        perf_req=float(lo + rng.uniform(-0.3, 1.2) * (hi - lo)),
        acc_req=float(rng.uniform(70.0, 100.0)),
        deadline_s=float(rng.choice([0.0, rng.uniform(0.05, 1.0)])))
        for i in range(n)]


def _assert_dispatch_equal(got, want):
    assert got.policy == want.policy
    assert canon(got.request) == canon(want.request)
    assert [(a.node, a.items, a.apx_level) for a in got.assignments] == \
        [(a.node, a.items, a.apx_level) for a in want.assignments]
    for a, b in zip(got.assignments, want.assignments):
        assert a.perf_alloc == pytest.approx(b.perf_alloc, rel=1e-9)


TABLES = {
    "paper-cluster": lambda ns: table(ns),
    "fleet-9": lambda ns: table(ns, ns.cluster.synthetic_fleet(9, seed=1)),
    "short-seq": lambda ns: table(ns, seq_len=8),
}


@pytest.mark.parametrize("tables", sorted(TABLES))
@pytest.mark.parametrize("policy", sorted(REF.dispatch.POLICIES))
def test_dispatch_functions(policy, tables):
    tp, tr = TABLES[tables](PORT), TABLES[tables](REF)
    assert np.array_equal(tp.perf, tr.perf)
    for rp, rr in zip(_dispatch_requests(PORT, tp),
                      _dispatch_requests(REF, tr)):
        got = getattr(PORT.dispatch, policy)(tp, rp)
        want = getattr(REF.dispatch, policy)(tr, rr)
        _assert_dispatch_equal(got, want)
        _assert_dispatch_equal(PORT.dispatch.dispatch(policy, tp, rp), want)
        assert got.total_items == rp.num_items


def test_dispatch_keyword_variants():
    """``margin`` and ``max_enum_nodes`` reach the policies as in the
    reference (``max_enum_nodes`` below the fleet size falls back)."""
    tp, tr = TABLES["fleet-9"](PORT), TABLES["fleet-9"](REF)
    for rp, rr in zip(_dispatch_requests(PORT, tp, seed=3),
                      _dispatch_requests(REF, tr, seed=3)):
        for fn, kw in (("uniform_apx", {"margin": 0.2}),
                       ("proportional", {"margin": 0.0}),
                       ("exact_oracle", {"max_enum_nodes": 4})):
            _assert_dispatch_equal(getattr(PORT.dispatch, fn)(tp, rp, **kw),
                                   getattr(REF.dispatch, fn)(tr, rr, **kw))


def test_dispatch_registry_shim():
    assert sorted(PORT.dispatch.POLICIES) == sorted(REF.dispatch.POLICIES)
    assert set(PORT.dispatch.POLICIES) == set(
        PORT.sched.registered_policies())
    assert PORT.dispatch.__name__ == "repro_torch.core.dispatch"
