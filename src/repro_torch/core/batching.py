"""Continuous-batching formation policy, shared by the simulator's
batch-aware node runtime and the serving engine's ``BatchScheduler``.

The policy answers one question — *launch the forming batch now, or
keep holding it for joiners?* — identically in both worlds:

  * a **full** batch (``max_batch`` items) launches immediately;
  * a **partial** batch launches once its oldest item has waited the
    formation window (``window_s``); with ``window_s == 0`` partial
    batches launch as soon as the server is free (no added latency —
    amortization then comes purely from queue depth, which is exactly
    when it matters);
  * an empty queue never launches.

Join-on-arrival falls out of the same rule: items that arrive while a
batch is being held join it (up to ``max_batch``), and a join that
fills the batch launches it at once.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BatchFormation:
    """Formation knobs: engine-batch cap and partial-batch hold window.

    ``tenant_cap`` bounds how many items a single tenant contributes to
    one *mixed* batch when other tenants' shares are waiting at the
    same level — a flooding tenant then shares each engine batch
    instead of monopolizing the whole formation prefix. 0 (the
    default) disables the cap entirely: formation is tenant-blind and
    byte-identical to the pre-tenancy scheduler. Leftover capacity no
    other tenant can fill always goes back to the capped tenant
    (work-conserving), so the cap never idles batch slots.
    """
    max_batch: int = 1
    window_s: float = 0.0
    tenant_cap: int = 0

    def __post_init__(self):
        assert self.max_batch >= 1, "max_batch must be >= 1"
        assert self.window_s >= 0.0, "window_s must be >= 0"
        assert self.tenant_cap >= 0, "tenant_cap must be >= 0 (0 = off)"

    @property
    def enabled(self) -> bool:
        """Batching on? ``max_batch == 1`` is the sequential model."""
        return self.max_batch > 1

    def take(self, queued: int) -> int:
        """Items the next batch takes from a queue of ``queued``."""
        return min(queued, self.max_batch)

    def ready(self, queued: int, oldest_wait_s: float) -> bool:
        """Launch now? Full batch, or window expired on a partial one."""
        if queued <= 0:
            return False
        if queued >= self.max_batch:
            return True
        return oldest_wait_s >= self.window_s

    def hold_until(self, enqueue_s: float) -> float:
        """Launch deadline for a partial batch whose oldest item was
        enqueued at ``enqueue_s``."""
        return enqueue_s + self.window_s
