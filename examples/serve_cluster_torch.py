"""End-to-end serving example: the full paper system with real inference on
the GPU, through ``repro_torch.launch.serve``'s gateway and engines.

The Gateway Node profiles a heterogeneous cluster over the H100's analytic
peaks, receives a request trace with per-request (perf | accuracy)
constraints and runs Algorithm 1; each Local Node share executes real
batched prefill + decode through the serving engine of its dispatched
accuracy level. A node disconnect mid-trace exercises the fault path (paper
Fig. 9). Dispatch uses the full config's profiling table; the engines run
the full-width variants in bf16 on the card, or with ``--smoke`` the
reduced variants.

Run:  PYTHONPATH=src python examples/serve_cluster_torch.py
      PYTHONPATH=src python examples/serve_cluster_torch.py --device cpu --smoke
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.requests import InferenceRequest
from repro_torch.core.resource_manager import Event
from repro_torch.launch.serve import EnginePool, build_gateway, run_shares


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (fails without one); 'cpu' to run on the CPU")
    ap.add_argument("--smoke", action="store_true", help="run the reduced variants")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--decode-steps", type=int, default=6)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    gn = build_gateway(cfg, policy="proportional")
    engines = EnginePool(get_smoke_config(args.arch) if args.smoke else cfg,
                         device=args.device, dtype="float32" if args.smoke else "bfloat16",
                         max_len=48 if args.smoke else 1024)
    print(f"gateway profiled {gn.table.num_nodes} worker groups; policy=proportional; "
          f"engines on {engines.device}")

    trace_rng = np.random.default_rng(7)
    lo = gn.table.perf[0].sum()
    cap = gn.table.perf[-1].min() * gn.table.num_nodes
    runs = []
    for i in range(args.requests):
        if i == 3:
            gn.handle(Event(kind="disconnect", node="slice-d"))
            print("\n!! slice-d disconnected — GN re-enters Distribute")
        req = InferenceRequest(
            rid=i, num_items=int(trace_rng.choice([260, 390, 520])),
            perf_req=trace_rng.uniform(lo * 1.02, cap * 0.95),
            acc_req=trace_rng.uniform(87.5, 90.0))
        res = gn.handle(Event(kind="workload", request=req))
        print(f"\nR{i}: {req.num_items} seqs, perf>={req.perf_req:.0f}, "
              f"acc>={req.acc_req:.1f} -> perf={res.achieved_perf:.0f} "
              f"acc={res.achieved_acc:.2f} "
              f"{'OK' if res.meets_perf and res.meets_acc else 'VIOLATION'}")
        # Local Node Inference state: the first engine batch of each share
        t0 = time.time()
        shares = run_shares(engines, gn, req, batch=4, prompt_len=8 if args.smoke else 512,
                            decode_steps=args.decode_steps)
        for s in shares:
            print(f"   {s['node']}: level {s['level']} {s['items']} seqs -> sample "
                  f"tokens {s['tokens'][0][:4].tolist()} (prefill {s['prefill_ms']:.1f} ms)")
        print(f"   ({(time.time() - t0) * 1e3:.0f} ms for {len(shares)} shares)")
        runs.extend(shares)
    summary = gn.summary()
    print("\nsummary:", {k: round(v, 4) for k, v in summary.items()})
    return {"gateway": gn, "runs": runs, "summary": summary}


if __name__ == "__main__":
    main()
