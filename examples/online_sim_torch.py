"""Online serving demo: the paper's cluster under a sustained request
stream with a mid-stream node disconnect, on the discrete-event simulator.

Where a serving run feeds the GatewayNode one request at a time
(timeless), this drives it with a Poisson arrival process on a sim
clock: requests queue per node, a disconnect at 1/3 horizon aborts the
victim's in-flight shares and re-DISTRIBUTEs them over the survivors, and
the report shows the resulting latency/deadline/accuracy profile.

The second half turns the closed-loop gateway on: the same overload
stream is run with and without admission control + autoscaling, showing
shed/degraded counts, standby spawns, and the admitted-request p99
staying flat while the uncontrolled baseline melts down.

The simulator is pure host code: it touches no device, and its service
times come from the analytic profiling table over the H100 SXM peaks.

Run:  PYTHONPATH=src python examples/online_sim_torch.py
"""
from repro_torch.configs import get_config
from repro_torch.control import AdmissionController, Autoscaler
from repro_torch.core.cluster import (DEFAULT_NODES, STANDBY_NODES,
                                      SimBackend, cluster_nodes)
from repro_torch.core.profiling import NodeProfile, ProfilingTable
from repro_torch.core.resource_manager import GatewayNode
from repro_torch.core.variants import VariantPool
from repro_torch.sim import OnlineSimulator, build_scenario


def main():
    arch = "phi4-mini-3.8b"
    pool = VariantPool(get_config(arch))

    for policy in ("uniform", "proportional"):
        nodes = [NodeProfile(n.name, n.chips, n.capability)
                 for n in DEFAULT_NODES]
        table = ProfilingTable(pool, nodes, seq_len=512)
        scenario = build_scenario("node-churn", table, seed=0,
                                  horizon_s=30.0)
        gn = GatewayNode(table, SimBackend(table), policy=policy)
        sim = OnlineSimulator(gn, scenario.arrivals, scenario.faults,
                              scenario=scenario.name,
                              horizon_s=scenario.horizon_s)
        report = sim.run()

        s = report.summary()
        print(f"\n=== policy={policy} scenario={scenario.name} "
              f"({scenario.description}) ===")
        print(f"  offered={s['offered']:.0f} completed={s['completed']:.0f}"
              f"  p50={s['p50_latency_s']*1e3:.1f}ms"
              f"  p99={s['p99_latency_s']*1e3:.1f}ms")
        print(f"  deadline_violation_rate={s['deadline_violation_rate']:.3f}"
              f"  mean_acc={s['mean_acc']:.2f}"
              f"  re-distributes={s['redistributes']:.0f}")
        fault_lines = [line for line in report.log
                       if "disconnect" in line or "re-DISTRIBUTE" in line
                       or "reconnect" in line]
        print("  fault log (first 6):")
        for line in fault_lines[:6]:
            print("   ", line)

    # ---- closed-loop gateway under sustained overload ----------------
    for control in (False, True):
        table = ProfilingTable(pool, cluster_nodes(num_standby=2),
                               seq_len=512)
        scenario = build_scenario("overload", table, seed=0, horizon_s=20.0)
        gn = GatewayNode(table, SimBackend(table), policy="proportional")
        admission = AdmissionController(table) if control else None
        autoscaler = (Autoscaler(table, [n.name for n in STANDBY_NODES])
                      if control else None)
        report = OnlineSimulator(gn, scenario.arrivals, scenario.faults,
                                 scenario=scenario.name,
                                 horizon_s=scenario.horizon_s,
                                 admission=admission,
                                 autoscaler=autoscaler).run()
        s = report.summary()
        label = "admission+autoscaling" if control else "no control"
        print(f"\n=== overload ({scenario.description}) — {label} ===")
        print(f"  offered={s['offered']:.0f} admitted={s['admitted']:.0f}"
              f" shed_rate={s['shed_rate']:.0%}"
              f" degraded={s['degraded']:.0f}")
        print(f"  admitted p99={s['p99_latency_s']*1e3:.1f}ms"
              f"  deadline_violation_rate="
              f"{s['deadline_violation_rate']:.3f}"
              f"  goodput={s['goodput_rps']:.1f} req/s")
        print(f"  scale_ups={s['scale_ups']:.0f}"
              f" (mean latency {s['mean_scale_up_latency_s']:.1f}s)"
              f" scale_downs={s['scale_downs']:.0f}")
        ctl_lines = [line for line in report.log
                     if "REJECTED" in line or "DEGRADED" in line
                     or "scale-" in line or "node_up" in line]
        print("  control log (first 6):")
        for line in ctl_lines[:6]:
            print("   ", line)


if __name__ == "__main__":
    main()
