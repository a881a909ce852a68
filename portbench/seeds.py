"""Streams of randomness derived from the run's ``--seed``, one per use."""
from __future__ import annotations

import numpy as np

_TAGS = {"order": 1, "prompts": 2, "sample": 3, "weights": 4}


def derive(seed: int, tag: str, *more: int) -> int:
    """A 63-bit integer for stream ``tag`` of ``seed`` (any whole number:
    it is taken modulo 2**64)."""
    words = [seed & (2**32 - 1), (seed >> 32) & (2**32 - 1), _TAGS[tag], *more]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: str, *more: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag, *more))
