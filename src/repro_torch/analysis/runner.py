"""detlint runner: per-file parallel analysis with deterministic output.

``analyze_file`` is the unit of work (parse once, run every in-scope
checker, apply inline suppressions); ``analyze_paths`` fans files out
over a process pool — the analysis is CPU-bound pure Python, so
processes, not threads — and merges the findings into one list sorted
by (path, line, col, code). The runner itself must obey the rules it
enforces: output order is independent of worker scheduling.
"""
from __future__ import annotations

import ast
import concurrent.futures
import os
from typing import Iterable, List, Sequence, Tuple

from repro_torch.analysis.checkers import ALL_CHECKERS
from repro_torch.analysis.core import Finding, SuppressionIndex


def discover(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, names in os.walk(path):
                dirs.sort()
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        elif path.endswith(".py"):
            files.append(path)
    # normalize to forward slashes so baselines are OS-portable
    return sorted(dict.fromkeys(f.replace(os.sep, "/") for f in files))


def analyze_file(path: str) -> List[Finding]:
    """All findings for one file: run every checker whose scope matches,
    then drop findings covered by a justified inline suppression (and
    surface malformed suppressions as DET000)."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path=path, line=e.lineno or 1, col=1,
                        code="DET000",
                        message=f"syntax error: {e.msg}",
                        hint="detlint only analyzes parseable files")]
    suppressions = SuppressionIndex(source, path)
    findings: List[Finding] = list(suppressions.malformed)
    for checker_cls in ALL_CHECKERS:
        if not checker_cls.in_scope(path):
            continue
        for finding in checker_cls(path, tree, source).run():
            if not suppressions.covers(finding.line, finding.code):
                findings.append(finding)
    return sorted(findings)


def analyze_paths(paths: Sequence[str], jobs: int = 0) -> List[Finding]:
    """Analyze every file under ``paths``; ``jobs`` = worker processes
    (0 = one per CPU, 1 = in-process serial)."""
    files = discover(paths)
    if jobs == 0:
        jobs = min(len(files), os.cpu_count() or 1) or 1
    if jobs <= 1 or len(files) <= 1:
        results: Iterable[List[Finding]] = map(analyze_file, files)
    else:
        try:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=jobs) as pool:
                results = list(pool.map(analyze_file, files,
                                        chunksize=4))
        except (OSError, concurrent.futures.process.BrokenProcessPool):
            # sandboxed environments may forbid fork; fall back serial
            results = map(analyze_file, files)
    merged: List[Finding] = []
    for file_findings in results:
        merged.extend(file_findings)
    return sorted(merged)


def partition_against_baseline(
        findings: Sequence[Finding],
        baseline_keys: Sequence[str]) -> Tuple[List[Finding], List[str]]:
    """(new findings not in the baseline, stale baseline entries with no
    matching finding) — both must be empty for the ratchet to pass."""
    known = set(baseline_keys)
    current = {f.baseline_key for f in findings}
    new = [f for f in findings if f.baseline_key not in known]
    stale = sorted(k for k in known if k not in current)
    return new, stale
