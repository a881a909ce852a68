"""Static analysis + runtime sanitizer for the repro's determinism rules.

Two halves, one contract:

  * :mod:`repro_torch.analysis.detlint` — an AST-based linter
    (``python -m repro_torch.analysis.detlint``) whose checkers encode the
    determinism invariants this codebase's golden digests rely on
    (wall-clock sources, unordered iteration, raw heap pushes, frozen-
    dataclass mutation, RNG-stream drift, identity tie-breaks). Findings
    are ratchet-gated by ``tests/detlint_baseline.txt``.
  * :mod:`repro_torch.analysis.sanitize` — cheap runtime assertions for the
    invariants a linter cannot see (clock monotonicity, event-seq
    uniqueness, item conservation, DRR deficit bounds, token-bucket
    bounds), enabled by ``REPRO_SANITIZE=1`` and on by default in the
    tier-1 test suite.

See docs/DETERMINISM.md for the rule catalogue and the history
behind each rule.
"""
from repro_torch.analysis.core import Finding, iter_suppressions  # noqa: F401
from repro_torch.analysis.runner import analyze_file, analyze_paths  # noqa: F401
