"""Quickstart: the paper's pipeline in ~40 lines, on the port's host stack.

Builds a heterogeneous 4-group cluster model over the H100's analytic
peaks, profiles it, then dispatches one accuracy/performance-constrained
inference request with each strategy and prints what the paper's Fig. 2
shows: only the Proportional policy meets BOTH constraints. Host code only:
it imports no torch and touches no device.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""
from repro_torch.configs import get_config
from repro_torch.core.cluster import DEFAULT_NODES, SimBackend
from repro_torch.core.profiling import (H100_SXM, HardwareSpec, NodeProfile,
                                        ProfilingTable)
from repro_torch.core.requests import InferenceRequest
from repro_torch.core.variants import VariantPool
from repro_torch.sched import ClusterState, get_policy, registered_policies


def plans(hw: HardwareSpec = H100_SXM, out=print):
    """Profiles the cluster over ``hw``'s peaks and plans one request with
    every registered policy. Returns ``[(policy, result, dispatch)]``;
    ``out`` receives the lines the run prints."""
    # 1. the model + its accuracy ladder (the MobileNet-alpha analogue)
    cfg = get_config("phi4-mini-3.8b")
    pool = VariantPool(cfg)
    out(f"arch={cfg.name}; variant ladder:")
    for v in pool.variants:
        out(f"  level {v.level}: alpha={v.alpha:<4} d_ff={v.config.d_ff:<6}"
            f" layers={v.config.num_layers:<3} acc~{v.accuracy:.1f}%")

    # 2. profile the heterogeneous cluster (Profile FSM state)
    nodes = [NodeProfile(n.name, n.chips, n.capability) for n in DEFAULT_NODES]
    table = ProfilingTable(pool, nodes, seq_len=512, hw=hw)
    out("\nprofiling table (sequences/s):")
    for m in range(table.num_levels):
        row = " ".join(f"{table.perf[m, j]:8.0f}" for j in range(len(nodes)))
        out(f"  level {m}: {row}")

    # 3. a request beyond full-accuracy capacity -> approximation needed
    full_cap = table.perf[0].sum()
    req = InferenceRequest(rid=0, num_items=650, perf_req=full_cap * 1.12,
                           acc_req=89.0)
    out(f"\nrequest: {req.num_items} items, perf>={req.perf_req:.0f}/s, "
        f"acc>={req.acc_req}%  (cluster full-acc capacity {full_cap:.0f})")

    # 4. plan with every registered strategy over one frozen snapshot
    backend = SimBackend(table)
    state = ClusterState.from_table(table)
    out(f"\n{'policy':14} {'perf':>9} {'acc':>7}  ok  levels/items")
    rows = []
    for name in registered_policies():
        d = get_policy(name).plan(state, req).dispatch
        r = backend.execute(d)
        ok = "YES" if (r.meets_perf and r.meets_acc) else " no"
        detail = " ".join(f"{a.node.split('-')[1]}:L{a.apx_level}x{a.items}"
                          for a in d.assignments)
        out(f"{name:14} {r.achieved_perf:9.0f} {r.achieved_acc:7.2f} {ok}  {detail}")
        rows.append((name, r, d))
    return rows


def main():
    plans()


if __name__ == "__main__":
    main()
