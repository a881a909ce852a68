"""The traffic generator: one general reader of the mix files in ``traffic/``.

Frozen from the port's demo scenario (``launch/serve.demo_requests``: the
paper's section IV-B bands): ``perf_req`` between a share of the gateway's
full-accuracy capacity and a share of its most-approximate capacity,
``acc_req`` in a feasible band; here each request also has a number of items,
one prompt length and one output length for all of them.

Every seed gets the same set of requests, in another order. A mix file
fixes a deck of ``requests_per_pass`` requests whose values are stratified
draws of its distributions: value j of a uniform range is its
(j + 0.5) / n quantile, a weighted choice takes each value in proportion to
its weight (largest remainders), and the dimensions are paired by fixed
permutations from ``deck_seed``. A run serves whole passes over the deck,
each pass in an order drawn from the run's seed, so any two runs do the same
work and differ in order, prompt tokens and weights.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    items: int
    prompt_len: int
    out_len: int
    perf_req: float
    acc_req: float


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _uniform(spec: dict, n: int, integer: bool) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    v = spec["low"] + q * (spec["high"] - spec["low"])
    return np.round(v).astype(int) if integer else v


def _weighted(spec: dict, n: int) -> np.ndarray:
    w = np.asarray(spec["weights"], dtype=float)
    w = w / w.sum() * n
    counts = np.floor(w).astype(int)
    for i in np.argsort(-(w - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.asarray(spec["values"], dtype=int), counts)


def deck(mix: dict, full_cap: float, max_cap: float) -> List[Request]:
    """The mix's requests, given the gateway's capacities (items/s) at full
    accuracy and at the most approximate level."""
    n = mix["requests_per_pass"]
    rng = np.random.default_rng(mix["deck_seed"])
    perf = mix["perf_req"]
    lo, hi = perf["low_of_full_capacity"] * full_cap, perf["high_of_max_capacity"] * max_cap
    cols = {
        "items": _uniform(mix["items"], n, True),
        "prompt_len": _weighted(mix["prompt_tokens"], n),
        "out_len": _uniform(mix["output_tokens"], n, True),
        "perf_req": _uniform({"low": lo, "high": hi}, n, False),
        "acc_req": _uniform(mix["acc_req"], n, False),
    }
    cols = {k: v[rng.permutation(n)] for k, v in cols.items()}
    return [Request(items=int(cols["items"][j]), prompt_len=int(cols["prompt_len"][j]),
                    out_len=int(cols["out_len"][j]), perf_req=float(cols["perf_req"][j]),
                    acc_req=float(cols["acc_req"][j])) for j in range(n)]


def longest(mix: dict) -> int:
    """The most positions one sequence of the mix needs: prompt plus output."""
    return max(mix["prompt_tokens"]["values"]) + int(mix["output_tokens"]["high"])


def batches(items: int, max_batch: int) -> List[int]:
    """A share's items cut into engine batches of at most ``max_batch``."""
    return [min(max_batch, items - i) for i in range(0, items, max_batch)]
