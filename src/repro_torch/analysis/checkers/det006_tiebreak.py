"""DET006 — identity / insertion-order tie-breaks in policies.

The stable-sort rule: when a policy ranks nodes or plans and two
candidates score equal, the winner must be decided by a *semantic* key
(lowest node index, lexicographic name) — never by ``id(...)`` (varies
per process) or by whichever element a hash-ordered container happened
to yield first. ``min``/``max``/``sorted`` over a set with a key
function is exactly that bug: equal keys resolve to hash order.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Checker, call_name
from repro_torch.analysis.checkers.det002_unordered import UnorderedIterChecker


class IdentityTieBreakChecker(Checker):
    code = "DET006"
    name = "identity-tiebreak"
    hint = ("break ties on a semantic key (node index, name) — never on "
            "id() or on hash/insertion order of a set")

    def __init__(self, path, tree, source):
        super().__init__(path, tree, source)
        # reuse DET002's set-expression tracker for the min/max-over-set
        # half of the rule
        self._sets = UnorderedIterChecker(path, tree, source)

    def visit_Call(self, node: ast.Call):
        name = call_name(node)
        if name == "id" and node.args:
            self.report(node, "id() is process-dependent and must not "
                              "influence scheduling order")
        elif name in ("min", "max", "sorted") and node.args:
            has_key = any(k.arg == "key" for k in node.keywords)
            if has_key and self._sets._is_set_expr(node.args[0]):
                self.report(node, f"{name}(set, key=...) resolves key "
                                  "ties in hash order")
        self.generic_visit(node)
