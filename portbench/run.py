"""Runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--device cpu`` rehearses on the CPU, which
only a small configuration fits (see README.md); it never stands for the
card. Exits with 2, printing no result, without the CUDA devices the cell
asks for, and with 3 if a module of jax, jaxlib, flax or repro is loaded.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="'cpu' rehearses on the CPU")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose BENCHMARK.json and portbench/ files run")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if p != here]
    # one process with few threads: no idle pool of CPU workers beside the
    # host-bound serving loop
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # every cache of the program, of torch and of the CUDA driver stays inside the checkout
    cache = ROOT / "build" / "portbench"
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(cache / sub))
    from portbench import harness
    result = harness.run(args.root, args.workload, args.seed, args.seconds,
                         bool(args.trace), device=args.device)
    if result is None:
        return 3 if harness.forbidden_modules() else 2
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
