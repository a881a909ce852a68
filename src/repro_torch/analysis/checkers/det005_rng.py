"""DET005 — unguarded RNG draws in the request-sampling / arrival paths.

The tenancy pin: a run with zero or one ``TenantSpec`` must consume
the *identical* RNG stream the pre-tenancy sampler consumed — every
draw added to ``RequestSampler`` or an arrival process shifts the
stream and silently re-rolls every golden digest and benchmark anchor.

The rule: every ``rng.<draw>()`` site inside ``RequestSampler`` /
``*Sampler`` / ``*Arrivals`` classes must carry an explicit
stream-compatibility guard — a ``# detlint: ok[DET005] <reason>``
suppression whose reason states why the 0/1-spec stream is unaffected
(the draw predates the pin and is itself pinned by the golden digests,
or it is conditionally skipped unless >= 2 tenant specs are present,
...). A new draw without that written justification is flagged, which
is the point: you cannot extend the stream without saying why the pins
survive.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ScopedVisitor

RNG_METHODS = frozenset({
    "random", "uniform", "integers", "choice", "normal", "standard_normal",
    "exponential", "poisson", "shuffle", "permutation", "randint", "rand",
    "randn", "gamma", "beta", "lognormal", "binomial",
})

CLASS_SUFFIXES = ("Sampler", "Arrivals")


def _is_rng_receiver(node: ast.AST) -> bool:
    """``rng.x`` / ``self.rng.x`` / ``self._rng.x`` receivers."""
    if isinstance(node, ast.Name):
        return node.id in ("rng", "_rng")
    if isinstance(node, ast.Attribute):
        return node.attr in ("rng", "_rng")
    return False


class RngStreamChecker(ScopedVisitor):
    code = "DET005"
    name = "rng-stream"
    hint = ("annotate the draw with '# detlint: ok[DET005] <why the "
            "0/1-spec stream is bit-identical>' — e.g. pinned by the "
            "golden digests, or guarded behind a >=2-tenant branch")

    def visit_Call(self, node: ast.Call):
        cls = self.enclosing_class
        if cls and (cls == "RequestSampler"
                    or cls.endswith(CLASS_SUFFIXES)):
            func = node.func
            if isinstance(func, ast.Attribute) and \
                    func.attr in RNG_METHODS and \
                    _is_rng_receiver(func.value):
                self.report(node, f"rng draw '{func.attr}' in "
                                  f"{cls}.{self.enclosing_func} without a "
                                  "stream-compatibility guard")
        self.generic_visit(node)
