"""Discrete-event machinery: simulated clock + slab-backed event queue.

Events are ordered by (time, seq); ``seq`` is a monotonically increasing
tie-breaker so same-timestamp events fire in push order (FIFO), which keeps
runs deterministic under seeded arrival processes.

The queue is *slab-backed*: the heap itself holds only scalar
``(time, seq, slot)`` triples, and the event's kind/payload live in
parallel slab arrays indexed by ``slot``, recycled through a freelist.
No ``SimEvent`` object is ever built on the hot path — ``pop_parts``
hands the raw parts straight to the fused dispatch loop, and the frozen
dataclass is materialized only by the compatibility accessors
(``pop``/``peek``) that tests and the per-event reference merge still
use. The pre-slab tuple-heap queue is retained verbatim in
``events_reference.py`` as the property-twin baseline.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, Iterable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One timed occurrence in the simulation.

    Kinds used by the online simulator:
      * ``arrival``         — payload["request"]: InferenceRequest
      * ``share_done``      — payload["node"], payload["share_id"]
      * ``batch_done``      — payload["node"], payload["op_id"]
                              (continuous-batching service op completed)
      * ``batch_launch``    — payload["node"], payload["token"]
                              (formation-window expiry on a held batch)
      * ``disconnect`` / ``reconnect``      — payload["node"]
      * ``straggler`` / ``straggler_clear`` — payload["node"], ["slowdown"]
    """
    time: float
    seq: int
    kind: str
    payload: Dict[str, Any]


class SeqCounter:
    """Monotone event-sequence source. One counter per EventQueue by
    default; the sharded control plane hands one *shared* counter to
    every cell's queue so dynamic events across cells draw from a single
    (time, seq) total order — with one cell that order is bit-identical
    to a standalone queue's, which is what keeps ``cells=1`` runs
    byte-identical to the unsharded simulator."""

    __slots__ = ("value",)

    def __init__(self, start: int = 0):
        self.value = start

    def next(self) -> int:
        v = self.value
        self.value += 1
        return v


class SlabEventQueue:
    """Min-heap keyed on (time, seq) over slab-allocated event storage.

    Layout: ``_heap`` is a heapq-managed list of ``(time, seq, slot)``
    scalar triples; ``_kind[slot]`` / ``_payload[slot]`` are parallel
    slab arrays carrying the event body; ``_free`` is a LIFO freelist of
    recycled slots. The slabs grow geometrically and never shrink, so a
    steady-state run allocates no per-event storage at all: a pop
    returns its slot to the freelist and the next push reuses it.

    Ordering is decided entirely by the ``(time, seq)`` prefix of the
    heap triples — ``slot`` is an arbitrary storage index that can never
    participate in a comparison because ``seq`` values are unique (the
    SeqCounter protocol), so slot recycling cannot perturb the event
    order. The (time, seq) contract, the ``_seq`` pre-assignment
    protocol, and ``push_chunk``'s byte-equivalence to per-item pushes
    are identical to the reference queue's.
    """

    #: initial slab capacity; grown geometrically (×2) when exhausted
    _INITIAL_CAPACITY = 256

    def __init__(self, counter: Optional[SeqCounter] = None):
        self._heap: list[Tuple[float, int, int]] = []
        self._counter = counter if counter is not None else SeqCounter()
        cap = self._INITIAL_CAPACITY
        self._kind: list[Optional[str]] = [None] * cap
        self._payload: list[Optional[Dict[str, Any]]] = [None] * cap
        # LIFO freelist: pop from the end (hottest slot first)
        self._free: list[int] = list(range(cap - 1, -1, -1))

    def _grow(self) -> None:
        """Double the slab; the new slots join the freelist back-first so
        lower indices keep getting reused first (cache-friendlier)."""
        cap = len(self._kind)
        self._kind.extend([None] * cap)
        self._payload.extend([None] * cap)
        self._free.extend(range(2 * cap - 1, cap - 1, -1))

    def push(self, time: float, kind: str, _seq: Optional[int] = None,
             **payload: Any) -> None:
        """Schedule an event. ``_seq`` overrides the counter with a
        pre-assigned sequence number — the sharded root router uses this
        to give arrivals/faults the exact seq numbers the unsharded
        constructor would have assigned, regardless of which cell's
        queue they land in."""
        seq = self._counter.next() if _seq is None else _seq
        free = self._free
        if not free:
            self._grow()
        slot = free.pop()
        self._kind[slot] = kind
        self._payload[slot] = payload
        heapq.heappush(self._heap, (time, seq, slot))

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
        free = self._free
        for t, seq, kind, payload in items:
            if not free:
                self._grow()
            slot = free.pop()
            self._kind[slot] = kind
            self._payload[slot] = payload
            heap.append((t, seq, slot))
        heapq.heapify(heap)

    def pop_parts(self) -> Tuple[float, int, str, Dict[str, Any]]:
        """Pop the head as raw ``(time, seq, kind, payload)`` parts and
        recycle its slot — the fused event loop's fast path; no SimEvent
        is built."""
        t, seq, slot = heapq.heappop(self._heap)
        kind = self._kind[slot]
        payload = self._payload[slot]
        self._kind[slot] = None
        self._payload[slot] = None
        self._free.append(slot)
        return (t, seq, kind, payload)  # type: ignore[return-value]

    def pop(self) -> SimEvent:
        """Compatibility pop: materialize the head as a SimEvent (slot
        recycled). Off the hot path — ``process_next`` and tests."""
        t, seq, kind, payload = self.pop_parts()
        return SimEvent(time=t, seq=seq, kind=kind, payload=payload)

    def peek(self) -> SimEvent:
        """The next event without removing it (raises IndexError when
        empty) — the per-event reference merge reads every cell's head
        to pick the global (time, seq) minimum. Materializes a SimEvent;
        the slot stays allocated until the matching pop."""
        t, seq, slot = self._heap[0]
        return SimEvent(time=t, seq=seq, kind=self._kind[slot],
                        payload=self._payload[slot])

    def peek_key(self) -> Tuple[float, int]:
        """The head's ``(time, seq)`` key without materializing the
        event (raises IndexError when empty). The sharded root's merge
        loop and the run-draining inner loop compare head keys far more
        often than they handle events, so the key read must not touch
        the slab at all."""
        head = self._heap[0]
        return (head[0], head[1])

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


# The slab queue IS the event queue; the name every consumer imports.
# The pre-slab twin lives in events_reference.py for the twin tests.
EventQueue = SlabEventQueue


class SimClock:
    """Monotone simulated time; advanced only by the event loop."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def advance_to(self, t: float):
        assert t >= self.now - 1e-12, f"clock moved backwards: {self.now} -> {t}"
        self.now = max(self.now, t)
