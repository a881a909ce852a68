"""DET003 — raw ``heapq`` pushes of ``(time, ...)`` tuples.

The event queue's total order is ``(time, seq)`` with ``seq`` drawn
from :class:`repro_torch.sim.events.SeqCounter`. A direct
``heapq.heappush(heap, (t, payload))`` bypasses the counter: two events
at the same timestamp then tie-break on the payload (or crash on an
uncomparable one), and the sharded merge loop — which relies on every
cell drawing seqs from one shared counter — silently loses its
cells=1 byte-identity (the exact bug class the sharded merge is designed around).
Push through ``EventQueue.push`` instead; heaps of plain scalars or of
tuples with an explicit integer tie-break in slot 1 may be suppressed
with a reason.

The sanctioned wrappers themselves — the slab queue's
``SlabEventQueue.push``/``push_chunk`` and the retained reference
twin's ``EventQueue.push``/``push_chunk`` — are allowlisted
structurally (by enclosing ``Class.method`` qualname), so the queue
implementations need no suppression comments and the baseline stays
empty.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ScopedVisitor, call_name

PUSH_FNS = ("heappush", "heapreplace", "heappushpop")

# the event-queue classes whose push/push_chunk bodies ARE the
# sanctioned wrapper: seq comes from SeqCounter (or a caller-side
# pre-assignment) one line above the heap operation
ALLOWED_CLASSES = ("EventQueue", "SlabEventQueue")
ALLOWED_FUNCS = ("push", "push_chunk")


class RawHeapPushChecker(ScopedVisitor):
    code = "DET003"
    name = "raw-heappush"
    hint = ("schedule through events.EventQueue.push (SeqCounter "
            "tie-break) instead of pushing (time, ...) tuples directly")

    def visit_Call(self, node: ast.Call):
        name = call_name(node)
        fn = name.rsplit(".", 1)[-1]
        if fn in PUSH_FNS and (name == fn or name == f"heapq.{fn}"):
            item = node.args[1] if len(node.args) >= 2 else None
            if isinstance(item, ast.Tuple) and not (
                    self.enclosing_class in ALLOWED_CLASSES
                    and self.enclosing_func in ALLOWED_FUNCS):
                self.report(node, f"{fn}() of a tuple bypasses "
                                  "events.SeqCounter ordering")
        self.generic_visit(node)
