"""The readings that a cell's correctness limit is set from, at the cell's
own size: for each seed, the program's widest gap (what a run compares) and
the control's: the reference in float8 put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds N]

Per seed it builds the cell as a run does, serves one pass of the deck
through the window's own loop (``harness.serve`` with no time left: every
batch of the mix, its longest requests included), frees the engines, and
judges the batches that a run's check draws twice through ``harness.check``:
the served tokens (the program), and in their place the tokens that the
reference in float8 puts first at the same positions (the control), which
the same rules and limit must find not correct. The control is read on the
first ``--control-seeds`` seeds (all by default). One JSON line a seed, then
one with the largest program gap (the lower reading) and the smallest
control gap (the upper reading). Exits 1 unless every program reading is
correct and every control reading is not.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _summary(verdict: dict) -> dict:
    return {"correct": verdict["correct"], "failed": verdict["failed"],
            "max_gap": verdict["checks"]["max_gap"]["value"],
            "tokens": verdict["tokens"], "counted": verdict["counted"]}


def readings(root: Path, workload: str, seed: int, device: str = "cuda",
             control: bool = True) -> dict:
    import torch
    from portbench import harness
    cell = harness.load_cell(root, workload)
    dev = torch.device(device)
    sut = harness.build(cell, seed, dev)
    win = harness.serve(cell, sut, seed, 0)
    sut.engines.clear()
    sut.gn = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = harness.compare_sample(cell, sut, win, seed, dev, control=control)
    row = {"workload": workload, "seed": seed, "batches": len(compared),
           "program": _summary(harness.check(cell, win, compared))}
    if control:
        row["control"] = _summary(harness.check(cell, win, compared, judge="control_token_gap"))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first N seeds only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if p != here]
    import torch
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    rows = []
    for k, s in enumerate(args.seeds):
        rows.append(readings(args.root, args.workload, s, args.device, control=k < n_control))
        print(json.dumps(rows[-1]), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    controls = [r["control"] for r in rows if "control" in r]
    summary = {"workload": args.workload, "seeds": len(rows),
               "lower": max(r["program"]["max_gap"] for r in rows),
               "upper": min((c["max_gap"] for c in controls), default=None),
               "program_correct": sum(r["program"]["correct"] for r in rows),
               "control_not_correct": sum(not c["correct"] for c in controls),
               "control_seeds": len(controls)}
    print(json.dumps(summary), flush=True)
    ok = (summary["program_correct"] == len(rows)
          and summary["control_not_correct"] == len(controls))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
