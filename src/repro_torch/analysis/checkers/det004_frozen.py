"""DET004 — mutation of frozen dataclasses.

``ClusterState`` and ``Plan`` are frozen because every consumer (gate,
policy, autoscaler, the sharded router) assumes a snapshot can never
change under it. ``object.__setattr__`` is the escape hatch — legal
only inside ``__post_init__`` or in an allowlisted constructor-
equivalent (a builder that mutates an instance *before* it escapes,
like ``SnapshotCache.snapshot`` pre-seeding memo fields on a freshly
built state). Everything else must go through
``dataclasses.replace(...)`` or be suppressed with a reason (e.g. a
value-deterministic memo-cache fill inside a property).

Also flagged: plain attribute assignment on a local known to hold a
``ClusterState``/``Plan`` instance — it would raise FrozenInstanceError
at runtime, but the point of detlint is to catch it in review.
"""
from __future__ import annotations

import ast
from typing import Set

from repro_torch.analysis.core import ScopedVisitor, call_name

FROZEN_TYPES = ("ClusterState", "Plan", "SimEvent", "AdmissionDecision")

#: Class.method qualnames allowed to call object.__setattr__ outside
#: __post_init__: builders that finish constructing an instance before
#: any other code can observe it.
CONSTRUCTOR_ALLOWLIST = frozenset({
    "SnapshotCache.snapshot",
})


class FrozenMutationChecker(ScopedVisitor):
    code = "DET004"
    name = "frozen-mutation"
    hint = ("use dataclasses.replace(...) to derive a new instance, or "
            "move the write into __post_init__ / an allowlisted "
            "constructor")

    def __init__(self, path, tree, source):
        super().__init__(path, tree, source)
        self._frozen_names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                name = call_name(node.value)
                ctor = name.rsplit(".", 1)[-1]
                if ctor in FROZEN_TYPES or (
                        ctor == "replace"
                        and name in ("dataclasses.replace", "replace")):
                    self._frozen_names.update(
                        t.id for t in node.targets
                        if isinstance(t, ast.Name))

    def visit_Call(self, node: ast.Call):
        if call_name(node) == "object.__setattr__":
            if self.enclosing_func != "__post_init__" and \
                    self.qualname not in CONSTRUCTOR_ALLOWLIST:
                self.report(node, "object.__setattr__ outside "
                                  "__post_init__/allowlisted constructor "
                                  f"(in {self.qualname or '<module>'})")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id in self._frozen_names:
                self.report(t, f"write to field '{t.attr}' of frozen "
                               f"instance '{t.value.id}'")
        self.generic_visit(node)
