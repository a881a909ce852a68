"""detlint checker registry: one module per rule, DET001..DET006.

Import order is the display order; ``ALL_CHECKERS`` is what the runner
instantiates per file. Adding a rule = adding a module here, a fixture
pair under ``tests/detlint_fixtures/``, and a row in
``docs/DETERMINISM.md``.
"""
from repro_torch.analysis.checkers.det001_wallclock import WallClockChecker
from repro_torch.analysis.checkers.det002_unordered import UnorderedIterChecker
from repro_torch.analysis.checkers.det003_heappush import RawHeapPushChecker
from repro_torch.analysis.checkers.det004_frozen import FrozenMutationChecker
from repro_torch.analysis.checkers.det005_rng import RngStreamChecker
from repro_torch.analysis.checkers.det006_tiebreak import IdentityTieBreakChecker

ALL_CHECKERS = (
    WallClockChecker,
    UnorderedIterChecker,
    RawHeapPushChecker,
    FrozenMutationChecker,
    RngStreamChecker,
    IdentityTieBreakChecker,
)

CODES = {c.code: c for c in ALL_CHECKERS}
