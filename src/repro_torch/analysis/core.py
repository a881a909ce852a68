"""detlint core: findings, the checker base class, inline suppressions.

A checker is an :class:`ast.NodeVisitor` subclass with a stable error
``code`` (``DET001``...), a one-line ``hint`` telling the author how to
fix the class of bug, and a ``scope`` — the directory names the rule
applies under (the determinism rules only bind inside the simulator /
scheduler / control plane; kernel or launch code may use wall clocks
freely). Checkers are pure syntax: they never import the module under
analysis, so analyzing a file can never execute it.

Suppressions are inline comments::

    something_nondeterministic()   # detlint: ok[DET001] <why it is fine>

A suppression covers its own line and, when written on a line of its
own, the next non-blank line. The justification is mandatory — a bare
``ok[DET001]`` is itself reported (``DET000``), so the ratchet can
never be silenced without a written reason.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*detlint:\s*ok\[(DET\d{3})\]\s*(.*?)\s*$")

#: codes every checker may assume; DET000 is reserved for detlint's own
#: diagnostics (malformed suppressions), never for a checker.
META_CODE = "DET000"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""
    path: str
    line: int
    col: int
    code: str
    message: str
    hint: str = ""

    def format(self, show_hint: bool = True) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"
        if show_hint and self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    @property
    def baseline_key(self) -> str:
        """Stable-ish identity for the baseline ratchet. Line numbers are
        part of the key on purpose: a finding that *moved* is a finding
        the author touched, and touched findings must be re-justified."""
        return f"{self.path}::{self.code}::{self.line}"


def iter_suppressions(source: str) -> Iterator[Tuple[int, str, str]]:
    """Yield ``(line_no, code, reason)`` for every suppression comment
    (1-based line numbers; ``reason`` may be empty — the caller decides
    whether that is an error)."""
    for i, line in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            yield i, m.group(1), m.group(2)


class SuppressionIndex:
    """Maps (line, code) -> justified?  Built once per file."""

    def __init__(self, source: str, path: str):
        self.path = path
        self._by_line: Dict[int, Dict[str, str]] = {}
        self.malformed: List[Finding] = []
        lines = source.splitlines()
        for line_no, code, reason in iter_suppressions(source):
            if not reason:
                self.malformed.append(Finding(
                    path=path, line=line_no, col=1, code=META_CODE,
                    message=f"suppression ok[{code}] has no justification",
                    hint="every detlint suppression must say why the "
                         "finding is safe: # detlint: ok[CODE] <reason>"))
                continue
            self._by_line.setdefault(line_no, {})[code] = reason
            stripped = lines[line_no - 1].lstrip()
            if stripped.startswith("#"):
                # a standalone comment suppresses the next non-blank line
                nxt = line_no + 1
                while nxt <= len(lines) and not lines[nxt - 1].strip():
                    nxt += 1
                if nxt <= len(lines):
                    self._by_line.setdefault(nxt, {})[code] = reason

    def covers(self, line: int, code: str) -> bool:
        return code in self._by_line.get(line, {})


class Checker(ast.NodeVisitor):
    """Base class for one detlint rule.

    Subclasses set ``code``, ``name``, ``hint``, and optionally
    ``scope`` (directory names the rule binds under — a file is in
    scope when any of its path components matches). ``report(node,
    message)`` records a finding at the node's location.
    """

    code: str = META_CODE
    name: str = "abstract"
    hint: str = ""
    #: directory components the rule applies under; () = everywhere
    scope: Tuple[str, ...] = ("sim", "sched", "control")

    def __init__(self, path: str, tree: ast.AST, source: str):
        self.path = path
        self.tree = tree
        self.source = source
        self.findings: List[Finding] = []

    @classmethod
    def in_scope(cls, path: str) -> bool:
        if not cls.scope:
            return True
        parts = re.split(r"[\\/]", path)
        return any(p in cls.scope for p in parts)

    def run(self) -> List[Finding]:
        self.visit(self.tree)
        return self.findings

    def report(self, node: ast.AST, message: str,
               hint: Optional[str] = None):
        self.findings.append(Finding(
            path=self.path, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1, code=self.code,
            message=message, hint=self.hint if hint is None else hint))


# ---- shared AST helpers ----------------------------------------------
def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for an Attribute/Name chain, '' when not a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)


class ScopedVisitor(Checker):
    """Checker that tracks the enclosing class / function names, so a
    rule can allowlist ``Class.method`` qualnames (DET004) or restrict
    itself to specific classes (DET005)."""

    def __init__(self, path: str, tree: ast.AST, source: str):
        super().__init__(path, tree, source)
        self._class_stack: List[str] = []
        self._func_stack: List[str] = []

    @property
    def enclosing_class(self) -> str:
        return self._class_stack[-1] if self._class_stack else ""

    @property
    def enclosing_func(self) -> str:
        return self._func_stack[-1] if self._func_stack else ""

    @property
    def qualname(self) -> str:
        name = self.enclosing_func
        if self._class_stack:
            return f"{self._class_stack[-1]}.{name}" if name else \
                self._class_stack[-1]
        return name

    def visit_ClassDef(self, node: ast.ClassDef):
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_func(self, node):
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._visit_func(node)
