"""Reference event queue: the retained pre-slab tuple-heap twin.

This is the event queue exactly as it shipped before the slab-backed
rewrite in ``events.py``: every ``push`` allocates a ``SimEvent`` and
heap-pushes a ``(time, seq, SimEvent)`` tuple. It is kept verbatim as
the property-twin baseline — ``tests/test_torch_sim.py`` drives the
slab queue and this queue through identical op sequences and asserts
byte-identical event streams, and builds the reference stack of
``ShardedSimulator(reference_stack=True)`` on it; the same retained-twin
pattern as ``sched/reference.py``.

Events are ordered by (time, seq); ``seq`` is a monotonically increasing
tie-breaker so same-timestamp events fire in push order (FIFO), which keeps
runs deterministic under seeded arrival processes.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, Iterable, Optional, Tuple

from repro_torch.sim.events import SeqCounter, SimEvent


class EventQueue:
    """Min-heap of SimEvents keyed on (time, seq)."""

    def __init__(self, counter: Optional[SeqCounter] = None):
        self._heap: list[Tuple[float, int, SimEvent]] = []
        self._counter = counter if counter is not None else SeqCounter()

    def push(self, time: float, kind: str, _seq: Optional[int] = None,
             **payload: Any) -> None:
        """Schedule an event. ``_seq`` overrides the counter with a
        pre-assigned sequence number — the sharded root router uses this
        to give arrivals/faults the exact seq numbers the unsharded
        constructor would have assigned, regardless of which cell's
        queue they land in."""
        seq = self._counter.next() if _seq is None else _seq
        ev = SimEvent(time=time, seq=seq, kind=kind, payload=payload)
        heapq.heappush(self._heap, (time, seq, ev))

    def push_chunk(self,
                   items: Iterable[Tuple[float, int, str, Dict[str, Any]]]
                   ) -> None:
        """Bulk-schedule pre-sequenced events: each item is ``(time, seq,
        kind, payload)`` with the seq assigned by the caller (the sharded
        root's pre-assigned arrival/fault numbering). One heapify over
        the extended heap replaces per-item sift-downs, and the given
        seqs are preserved exactly — a chunk push is byte-equivalent to
        pushing the items one at a time with ``_seq=``, which is what
        keeps the (time, seq) total order (and therefore ``cells=1``
        byte-identity) independent of push granularity."""
        heap = self._heap
        for t, seq, kind, payload in items:
            heap.append((t, seq,
                         SimEvent(time=t, seq=seq, kind=kind,
                                  payload=payload)))
        heapq.heapify(heap)

    def pop(self) -> SimEvent:
        return heapq.heappop(self._heap)[2]

    def pop_parts(self) -> Tuple[float, int, str, Dict[str, Any]]:
        """Pop the head as raw ``(time, seq, kind, payload)`` parts —
        same protocol as the slab queue's fast path, so the fused event
        loop can drain either queue through one code path."""
        t, seq, ev = heapq.heappop(self._heap)
        return (t, seq, ev.kind, ev.payload)

    def peek(self) -> SimEvent:
        """The next event without removing it (raises IndexError when
        empty) — the sharded root's merge loop reads every cell's head
        to pick the global (time, seq) minimum."""
        return self._heap[0][2]

    def peek_key(self) -> Tuple[float, int]:
        """The head's ``(time, seq)`` key without materializing the
        event (raises IndexError when empty). The sharded root's merge
        loop and the run-draining inner loop compare head keys far more
        often than they handle events, so the key read must not touch
        the SimEvent payload at all."""
        head = self._heap[0]
        return (head[0], head[1])

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
