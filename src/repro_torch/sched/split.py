"""Batch-quantized workload split for batch-aware plans.

The paper's proportional split hands every node ``num_items * share_j``
items. Under continuous batching that is wasteful: a share's tail
(``items % max_batch``) runs as a partial engine batch that streams the
full weights for a handful of items, so a weak node given a small share
can spend half its time on one tail. The quantizer keeps the
proportional *intent* but rounds every share down to a multiple of the
engine batch and places the leftover greedily, chunk by chunk, on the
node whose predicted finish (queue backlog + service so far + the
chunk) is earliest — so exactly one partial batch per request remains,
and it lands where it hurts least.

Shared verbatim by the optimized planners and their ``reference:``
twins: it is pure integer/float arithmetic with a deterministic
tie-break (lowest node index wins), so there is no vectorized/loop
implementation pair to prove equivalent.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.analysis import sanitize

# REPRO_SANITIZE=1 arms the conservation postcondition; otherwise this
# is the shared no-op and the hot path pays one dead call
_check_conservation = sanitize.hook(sanitize.check_split_conservation)


def quantized_batch_split(state, avail_idx: np.ndarray,
                          levels: np.ndarray, shares: np.ndarray,
                          num_items: int) -> List[int]:
    """Per-node item counts for a batched dispatch.

    ``shares`` is the policy's ideal (throughput-proportional) fraction
    per available node; ``levels`` the chosen approximation levels.
    Returns integer item counts summing to ``num_items``, each a
    multiple of ``state.max_batch`` except at most one tail chunk.
    """
    q = state.max_batch
    cols = avail_idx.tolist()
    level_l = np.asarray(levels).tolist()
    # Guard the fp->int quantization: a share vector is only *intended*
    # to be a simplex point, but fp error (or an adversarial caller) can
    # hand us negative entries or a sum above 1.0. Unguarded, a negative
    # share yields a negative base count and an oversubscribed sum makes
    # ``leftover`` negative — the greedy loop below then silently skips
    # and the function returns counts that do not sum to ``num_items``.
    clean = [s if s > 0.0 and np.isfinite(s) else 0.0
             for s in shares.tolist()]
    # cap each base at the largest engine-batch multiple <= num_items
    # (not num_items itself): bases must stay q-multiples or the strip
    # loop below would shave several of them into tail chunks
    cap = num_items // q * q
    base = [min(int(num_items * s) // q * q, cap) for s in clean]
    backlog = state.backlog_s
    names = state.names
    backlogs = [backlog.get(names[c], 0.0) for c in cols]
    leftover = num_items - sum(base)
    while leftover < 0:
        # quantized bases oversubscribed (shares summed above 1.0):
        # strip whole engine batches from the largest share until the
        # greedy placement below has a non-negative remainder to place
        j = max(range(len(base)), key=base.__getitem__)
        take = min(q, base[j], -leftover)
        base[j] -= take
        leftover += take
    while leftover > 0:
        chunk = min(q, leftover)
        best, best_t = 0, float("inf")
        for j, c in enumerate(cols):
            # candidate finish = queue backlog + service of the grown
            # share (service_s is total, not incremental, so no
            # running-finish bookkeeping is needed)
            t = backlogs[j] + state.service_s(base[j] + chunk,
                                              level_l[j], c)
            if t < best_t:
                best, best_t = j, t
        base[best] += chunk
        leftover -= chunk
    _check_conservation(base, num_items, q)
    return base
