"""The port's determinism linter against the JAX package's: the same
findings on every fixture, the same suppression and baseline-ratchet
behaviour, and a clean port tree with no baseline."""
import glob
import os
import subprocess
import sys

import pytest

from repro.analysis.baseline import read_baseline as ref_read_baseline
from repro.analysis.detlint import main as ref_main
from repro.analysis.runner import analyze_file as ref_analyze_file
from repro_torch.analysis import Finding, analyze_file, analyze_paths
from repro_torch.analysis.baseline import read_baseline, write_baseline
from repro_torch.analysis.checkers import ALL_CHECKERS
from repro_torch.analysis.core import SuppressionIndex
from repro_torch.analysis.detlint import main as port_main
from repro_torch.analysis.runner import partition_against_baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "detlint_fixtures",
                                         "**", "*.py"), recursive=True))


def _key(findings):
    return [(f.code, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("path", FIXTURES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_fixture_findings_match_reference(path):
    got, want = analyze_file(path), ref_analyze_file(path)
    assert _key(got) == _key(want)
    assert [f.hint for f in got] == [f.hint for f in want]
    if path.endswith("_good.py"):
        assert got == []
    else:
        code = os.path.basename(path).split("_")[0].upper()
        assert got and {f.code for f in got} == {code}


def test_rule_catalogue_matches_reference():
    from repro.analysis.checkers import ALL_CHECKERS as REF_CHECKERS
    assert [(c.code, c.name, c.scope, c.hint) for c in ALL_CHECKERS] == \
        [(c.code, c.name, c.scope, c.hint) for c in REF_CHECKERS]


SNIPPETS = {
    "inline-reason": "    return time.time()  "
                     "# detlint: ok[DET001] telemetry, excluded from digests\n",
    "standalone-reason": "    # detlint: ok[DET001] telemetry only\n"
                         "    return time.time()\n",
    "wrong-code": "    return time.time()  # detlint: ok[DET003] wrong code\n",
    "no-reason": "    return time.time()  # detlint: ok[DET001]\n",
    "unsuppressed": "    return time.time()\n",
}


@pytest.mark.parametrize("case", sorted(SNIPPETS))
@pytest.mark.parametrize("scope", ["sim", "kernels"])
def test_suppressions_match_reference(tmp_path, case, scope):
    d = tmp_path / scope
    d.mkdir()
    path = d / "mod.py"
    path.write_text("import time\n\ndef t():\n" + SNIPPETS[case])
    got, want = analyze_file(str(path)), ref_analyze_file(str(path))
    assert _key(got) == _key(want)
    if scope == "kernels":          # the rules bind under sim/sched/control
        assert "DET001" not in {f.code for f in got}


def test_suppression_index():
    idx = SuppressionIndex(
        "x = 1  # detlint: ok[DET002] hash order is fine here\n", "sim/x.py")
    assert idx.covers(1, "DET002") and not idx.covers(1, "DET001")
    assert idx.malformed == []


def test_baseline_ratchet_matches_reference(tmp_path, capsys):
    bad = next(p for p in FIXTURES if p.endswith("det001_bad.py"))
    good = next(p for p in FIXTURES if p.endswith("det001_good.py"))
    runs = []
    for main, read in ((port_main, read_baseline),
                       (ref_main, ref_read_baseline)):
        baseline = str(tmp_path / f"{main.__module__}.txt")
        codes = [main([good, "--jobs", "1"]), main([bad, "--jobs", "1"]),
                 main([bad, "--jobs", "1", "--baseline", baseline,
                       "--update-baseline"]),
                 main([bad, "--jobs", "1", "--baseline", baseline]),
                 main([good, "--jobs", "1", "--baseline", baseline])]
        out = capsys.readouterr().out
        runs.append((codes, read(baseline), "stale" in out, "DET001" in out))
    assert runs[0] == runs[1]
    assert runs[0][0] == [0, 1, 0, 0, 1]


def test_baseline_partition(tmp_path):
    findings = [Finding(path="src/repro_torch/sim/x.py", line=3, col=1,
                        code="DET001", message="m"),
                Finding(path="src/repro_torch/sim/x.py", line=9, col=1,
                        code="DET002", message="m")]
    path = str(tmp_path / "baseline.txt")
    write_baseline(path, findings[:1])
    new, stale = partition_against_baseline(
        findings, read_baseline(path) + ["src/repro_torch/sim/gone.py::DET004::1"])
    assert [f.code for f in new] == ["DET002"]
    assert stale == ["src/repro_torch/sim/gone.py::DET004::1"]


def _twins():
    """Every module of the port that has a namesake in the JAX package."""
    port = os.path.join(ROOT, "src", "repro_torch")
    for base, _, names in os.walk(port):
        for n in sorted(names):
            rel = os.path.relpath(os.path.join(base, n), port)
            ref = os.path.join(ROOT, "src", "repro", rel)
            if n.endswith(".py") and os.path.exists(ref):
                yield rel, os.path.join(base, n), ref


def test_suppressions_kept():
    """Each inline ``# detlint: ok[CODE] reason`` of a module the port
    copies is kept in the port's copy, with its code and reason."""
    from repro_torch.analysis import iter_suppressions
    seen = 0
    for rel, port, ref in sorted(_twins()):
        with open(port) as fp, open(ref) as fr:
            got = [(c, r) for _, c, r in iter_suppressions(fp.read())]
            want = [(c, r) for _, c, r in iter_suppressions(fr.read())]
        assert got == want, rel
        seen += len(want)
    assert seen >= 25


def test_port_tree_is_clean():
    findings = analyze_paths([os.path.join(ROOT, "src", "repro_torch")],
                             jobs=1)
    assert findings == [], [f.format(show_hint=False) for f in findings]


def test_cli_on_port_tree_exits_zero():
    """``python -m repro_torch.analysis.detlint src/repro_torch`` with no
    baseline: zero findings, exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.detlint",
         "src/repro_torch", "--jobs", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    assert "clean over src/repro_torch" in proc.stderr
