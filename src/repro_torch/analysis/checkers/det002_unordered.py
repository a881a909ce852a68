"""DET002 — iteration over hash-ordered contents feeding ordered output.

``set`` iteration order depends on element hashes — for strings, on the
per-process hash seed — so a set that leaks into any *ordered* surface
(event pushes, float accumulation, plan assembly, log lines) makes the
run irreproducible across processes. Membership tests, ``len``, ``any``
/ ``all`` / ``min`` / ``max`` are order-insensitive and stay legal; an
iteration wrapped in ``sorted(...)`` is the sanctioned fix.

Python dicts iterate in insertion order and are treated as
deterministic; the exception is a dict *built from a set* (a dict
comprehension over a set expression), whose insertion order is the
set's hash order — iterating its views is flagged too.
"""
from __future__ import annotations

import ast
from typing import Set

from repro_torch.analysis.core import Checker, call_name

# calls whose result is order-insensitive, so a set argument is fine
ORDER_FREE_CALLS = {"len", "any", "all", "min", "max", "bool", "set",
                    "frozenset", "sorted"}
# calls that materialize their argument's order into an ordered output
ORDER_SINK_CALLS = {"list", "tuple", "enumerate", "sum", "map", "filter",
                    "zip", "reversed", "iter", "next"}

SET_BINOPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)


class UnorderedIterChecker(Checker):
    code = "DET002"
    name = "unordered-iteration"
    hint = ("wrap the iterable in sorted(...) (with an explicit key for "
            "non-comparable elements) before it feeds ordered output")

    def __init__(self, path, tree, source):
        super().__init__(path, tree, source)
        self._set_names: Set[str] = set()
        self._hash_dict_names: Set[str] = set()
        self._collect_bindings(tree)

    # ---- set-typed name tracking (scope-insensitive, assignment only)
    def _collect_bindings(self, tree: ast.AST):
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = node.value
                if value is None:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = [t.id for t in targets if isinstance(t, ast.Name)]
                if not names:
                    continue
                if self._is_set_expr(value, _resolve_names=False):
                    self._set_names.update(names)
                elif isinstance(value, ast.DictComp) and \
                        self._is_set_expr(value.generators[0].iter,
                                          _resolve_names=False):
                    self._hash_dict_names.update(names)

    def _is_set_expr(self, node: ast.AST, _resolve_names: bool = True) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and \
                call_name(node) in ("set", "frozenset"):
            return True
        if isinstance(node, ast.BinOp) and isinstance(node.op, SET_BINOPS):
            return (self._is_set_expr(node.left, _resolve_names)
                    or self._is_set_expr(node.right, _resolve_names))
        if _resolve_names and isinstance(node, ast.Name):
            return node.id in self._set_names
        return False

    def _is_hash_dict_view(self, node: ast.AST) -> bool:
        """``d.values()`` / ``d.keys()`` / ``d.items()`` where ``d`` was
        built from a set (hash-ordered insertion)."""
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("values", "keys", "items") \
                and isinstance(node.func.value, ast.Name):
            return node.func.value.id in self._hash_dict_names
        return False

    def _flag_if_unordered(self, iterable: ast.AST, context: str):
        if self._is_set_expr(iterable):
            self.report(iterable, f"{context} iterates a set in hash "
                                  "order (feeds ordered output)")
        elif self._is_hash_dict_view(iterable):
            self.report(iterable, f"{context} iterates a dict view whose "
                                  "insertion order came from a set")

    # ---- order-leaking contexts --------------------------------------
    def visit_For(self, node: ast.For):
        self._flag_if_unordered(node.iter, "for loop")
        self.generic_visit(node)

    def _visit_comp(self, node):
        # set/dict comprehensions over a set rebuild an unordered (or
        # hash-inserted, tracked separately) container — no order leaks;
        # list/generator comprehensions materialize the order
        for gen in node.generators:
            self._flag_if_unordered(gen.iter, "comprehension")
        self.generic_visit(node)

    visit_ListComp = visit_GeneratorExp = _visit_comp

    def visit_Starred(self, node: ast.Starred):
        self._flag_if_unordered(node.value, "unpacking")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        name = call_name(node)
        if name in ORDER_SINK_CALLS:
            for arg in node.args:
                self._flag_if_unordered(arg, f"{name}()")
        elif name.endswith(".join") and node.args:
            self._flag_if_unordered(node.args[0], "str.join()")
        self.generic_visit(node)
