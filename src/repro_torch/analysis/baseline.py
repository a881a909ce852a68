"""detlint baseline ratchet — same spirit as scripts/check_seed_baseline.py.

``tests/detlint_baseline.txt`` holds the findings the tree is *allowed*
to have (one ``path::CODE::line`` key per line; blanks and ``#``
comments ignored). The gate fails on any finding not in the baseline
(new violation) AND on any baseline entry with no matching finding
(stale entry — the violation was fixed or moved, so the entry must be
deleted or re-recorded). The intended end state is an empty file: every
rule violation either fixed or justified with an inline suppression at
the source.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.analysis.core import Finding


def read_baseline(path: str) -> List[str]:
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return []
    return [ln.strip() for ln in lines
            if ln.strip() and not ln.lstrip().startswith("#")]


def write_baseline(path: str, findings: Sequence[Finding]):
    keys = sorted(f.baseline_key for f in findings)
    with open(path, "w", encoding="utf-8") as f:
        f.write("# detlint baseline — accepted findings (path::CODE::line"
                ").\n# Burn this down: fix the code or add an inline\n"
                "# '# detlint: ok[CODE] reason' suppression, then remove "
                "the entry.\n")
        for k in keys:
            f.write(k + "\n")
