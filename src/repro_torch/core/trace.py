"""Profiler ranges and counted host synchronisations.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler is
recording, and one shared null context otherwise: with no profiler a range
costs one check. Under the profiler the ranges land in the trace beside the
device's kernel records, on the profiler's clock, so every idle gap of the
device can be put down to what the host was doing.

``host_sync(name)`` goes around a statement that makes the host wait for
the device (a copy to or from pageable host memory, an ``.item()``, a
boolean index): it counts the statement under ``name``, adds the host's
wait to ``waits_s[name]`` and opens ``span(name)``. The totals are plain
module state that only grows, like the kernels' ``launches`` counters; a
caller reads what one piece of work added from a snapshot before it
(``counts_since``, ``wait_s``).

This module imports no torch: the host-only control plane opens spans too,
and a profiler can only be recording once torch is loaded.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

NULL = contextlib.nullcontext()

counts: Dict[str, int] = {}       # name -> host syncs counted
waits_s: Dict[str, float] = {}    # name -> host seconds spent in them


def span(name: str):
    """A named profiler range while a profiler records, else ``NULL``."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NULL


class host_sync:
    """``with host_sync(name):`` around one statement that waits for the
    device: one count and its wait under ``name``, inside ``span(name)``."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        counts[self.name] = counts.get(self.name, 0) + 1
        self.range = span(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        waits_s[self.name] = waits_s.get(self.name, 0.0) + time.perf_counter() - self.t0
        return self.range.__exit__(*exc)


def wait_s() -> float:
    """Host seconds waited in every counted sync so far."""
    return sum(waits_s.values())


def counts_since(before: Dict[str, int]) -> Dict[str, int]:
    """The syncs counted since ``before`` (a copy of ``counts``), by name."""
    return {k: n - before.get(k, 0) for k, n in counts.items() if n != before.get(k, 0)}
