"""detlint CLI — the repro's determinism & invariant static analysis.

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.detlint src/repro_torch
  PYTHONPATH=src python -m repro_torch.analysis.detlint src/repro_torch \\
      --baseline detlint_baseline.txt
  PYTHONPATH=src python -m repro_torch.analysis.detlint --list-rules

Exit status: 0 when the tree is clean (no findings outside the
baseline, no stale baseline entries), 1 otherwise. ``--update-baseline``
rewrites the baseline to the current findings — for ratchet *shrinking*
only; CI runs without it, so a freshly introduced violation can never
self-bless.

Stdlib-only on purpose: the lint gate must run before (and without)
the scientific stack.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.baseline import read_baseline, write_baseline
from repro_torch.analysis.checkers import ALL_CHECKERS
from repro_torch.analysis.runner import analyze_paths, partition_against_baseline


def list_rules() -> str:
    lines = ["detlint rules (see docs/DETERMINISM.md):"]
    for c in ALL_CHECKERS:
        scope = "/".join(c.scope) if c.scope else "everywhere"
        lines.append(f"  {c.code}  {c.name:22s} scope: {scope}")
        lines.append(f"          fix: {c.hint}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.detlint",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--baseline", default="",
                    help="ratchet file of accepted findings; without "
                         "it any finding fails (the port's tree keeps "
                         "none)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline to the current findings "
                         "instead of failing")
    ap.add_argument("--jobs", type=int, default=0,
                    help="worker processes (0 = one per CPU, 1 = serial)")
    ap.add_argument("--no-hints", action="store_true",
                    help="one line per finding (no fix hints)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(list_rules())
        return 0

    paths = args.paths or ["src/repro_torch"]
    findings = analyze_paths(paths, jobs=args.jobs)

    if args.baseline and args.update_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}",
              file=sys.stderr)
        return 0

    baseline_keys = read_baseline(args.baseline) if args.baseline else []
    new, stale = partition_against_baseline(findings, baseline_keys)

    status = 0
    if new:
        print(f"detlint: {len(new)} finding(s) not in the baseline:")
        for f in new:
            print(f.format(show_hint=not args.no_hints))
        status = 1
    if stale:
        print(f"detlint: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (fixed or moved — "
              "delete from the baseline):")
        for k in stale:
            print(f"  {k}")
        status = 1
    if status == 0:
        known = len(findings)
        extra = f" ({known} baselined)" if known else ""
        print(f"detlint: clean over {', '.join(paths)}{extra}",
              file=sys.stderr)
    else:
        print("\nre-run with --baseline <file> "
              "--update-baseline only to *shrink* the ratchet; new "
              "findings need a fix or an inline "
              "'# detlint: ok[CODE] reason'", file=sys.stderr)
    return status


if __name__ == "__main__":
    sys.exit(main())
