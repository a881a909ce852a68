"""DET001 — wall-clock / ambient-nondeterminism sources in the control
plane.

Everything under ``sim/``, ``sched/``, ``control/`` must be a pure
function of the seeded inputs and the *simulated* clock: the golden
digests (tests/golden/sim_digest.json) hash records, log lines, and
summaries, so a single ``time.time()`` or unseeded ``np.random.*`` call
that leaks into behaviour breaks byte-identity across runs and hosts.
Host-clock telemetry that is provably excluded from the digests (e.g.
``SimReport.wall_s``) is the legitimate suppression case.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Checker, call_name

# dotted suffixes that read the host clock or ambient entropy
WALL_CLOCK = (
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.today", "date.today",
    "os.urandom", "os.getrandom", "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.token_hex", "secrets.randbits",
)

# ``random`` module functions that mutate/read the hidden global state;
# a local variable named ``random`` would false-positive, but the repro
# bans that name in the control plane anyway (use an explicit rng)
GLOBAL_RANDOM_PREFIX = "random."

# np.random module-level calls draw from numpy's hidden global
# RandomState; only explicit generator construction is allowed
NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox", "RandomState"}


class WallClockChecker(Checker):
    code = "DET001"
    name = "wall-clock"
    hint = ("control-plane code must run on the SimClock and explicit "
            "seeded rngs; host-clock telemetry excluded from digests "
            "may be suppressed with a reason")

    def visit_Call(self, node: ast.Call):
        name = call_name(node)
        if name:
            if any(name == w or name.endswith("." + w) for w in WALL_CLOCK):
                self.report(node, f"call to wall-clock/entropy source "
                                  f"'{name}'")
            elif name.startswith(GLOBAL_RANDOM_PREFIX) and \
                    name.count(".") == 1:
                self.report(node, f"'{name}' uses the global random-module "
                                  "state (unseeded, process-wide)")
            else:
                root, _, rest = name.partition(".")
                if root in ("np", "numpy") and rest.startswith("random.") \
                        and rest.split(".")[1] not in NP_RANDOM_OK:
                    self.report(
                        node, f"'{name}' draws from numpy's global "
                              "RandomState; use np.random.default_rng(seed)")
        self.generic_visit(node)
