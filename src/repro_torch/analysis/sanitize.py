"""Runtime sanitizer: the invariants detlint cannot prove statically.

``REPRO_SANITIZE=1`` (read once at import) arms cheap assertion hooks
at the control plane's trust boundaries:

  * sim-clock monotonicity + event-seq uniqueness — every event popped
    by a simulator must strictly follow the previous one in the
    (time, seq) total order;
  * item conservation — ``quantized_batch_split`` returns counts that
    sum to the request and an engine-batch op claims exactly the items
    its takes list says;
  * DRR deficit bounds — a released tenant's deficit stays in
    ``[0, quantum * weight)`` (Shreedhar & Varghese's fairness proof
    rests on exactly this bound);
  * token-bucket bounds — a bucket never goes negative and never
    exceeds its burst.

When the flag is off every hook is the shared no-op closure, so the
production path pays one dead call per checkpoint and nothing else.
The checks are pure asserts over values already computed — they can
never perturb control flow, RNG streams, or float results, which is
what lets the tier-1 suite run fully sanitized against byte-identical
golden digests. ``OnlineSimulator(sanitize=...)`` can force the
simulator-side checks on/off per instance regardless of the env.
"""
from __future__ import annotations

import os

_EPS = 1e-9

ENABLED = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def _noop(*args, **kwargs):
    return None


def hook(check_fn):
    """``check_fn`` when the sanitizer is armed, the no-op otherwise.
    Bind the result at module import: ``_check = sanitize.hook(_impl)``."""
    return check_fn if ENABLED else _noop


# ---- invariant implementations (bound via hook() by their consumers) --
def check_split_conservation(counts, num_items: int, q: int):
    """quantized_batch_split postcondition: non-negative counts summing
    to the request, with at most one non-multiple-of-q tail chunk."""
    assert sum(counts) == num_items, \
        f"split lost items: {sum(counts)} != {num_items} (counts={counts})"
    assert all(c >= 0 for c in counts), f"negative share: {counts}"
    tails = sum(1 for c in counts if c % q)
    assert tails <= 1, \
        f"{tails} partial engine batches in one split (counts={counts}, q={q})"


def check_op_conservation(op, max_batch: int):
    """A formed batch op claims exactly what its takes list says, every
    take within its share's unclaimed items, priced batch <= the cap."""
    total = sum(take for _, take in op.takes)
    assert total == op.n_items, \
        f"op {op.op_id} claims {op.n_items} items but takes sum to {total}"
    assert all(0 < take <= share.unclaimed + take
               for share, take in op.takes), \
        f"op {op.op_id} has a non-positive or over-claimed take"
    assert 0 < op.batch_size <= max_batch, \
        f"op {op.op_id} priced batch {op.batch_size} outside (0, {max_batch}]"


def check_drr_release(deficit: float, quantum: float, weight: float,
                      tenant: str):
    """Post-release deficit bound: 0 <= deficit < quantum * weight."""
    bound = quantum * max(weight, 0.0)
    assert -_EPS <= deficit < bound + _EPS, \
        (f"DRR deficit for {tenant!r} out of bounds after release: "
         f"{deficit} not in [0, {bound})")


def check_outstanding(outstanding, total: int):
    """Per-tenant outstanding items stay non-negative and sum to the
    scheduler's running total."""
    assert all(v >= 0 for v in outstanding.values()), \
        f"negative outstanding items: {dict(outstanding)}"
    s = sum(outstanding.values())
    assert s == total, \
        f"outstanding total drifted: cached {total} != summed {s}"


def check_bucket(tokens: float, burst: float):
    """Token bucket bound: 0 <= tokens <= burst."""
    assert -_EPS <= tokens <= burst + _EPS, \
        f"token bucket out of bounds: {tokens} not in [0, {burst}]"
