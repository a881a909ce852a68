"""Synthetic token pipeline (numpy only), the JAX package's stream.

Deterministic, seekable token stream: batch i is a pure function of
(seed, i), so checkpoint/restart resumes exactly by skipping to the saved
step (no state files needed). The numbers are the JAX package's own, batch
for batch: the same generator calls in the same order.

A Zipf-ish unigram distribution + Markov chain gives non-trivial, learnable
structure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: bool = True     # correlated tokens (learnable structure)


class SyntheticTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf unigram over vocab
        ranks = np.arange(1, v + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse "successor" structure: each token prefers a few successors
        self.succ = rng.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.choice(v, size=b, p=self.probs)
        if cfg.markov_order:
            follow = rng.random((b, s)) < 0.75
            succ_pick = rng.integers(0, 4, size=(b, s))
            fresh = rng.choice(v, size=(b, s), p=self.probs)
            for t in range(1, s):
                nxt = self.succ[toks[:, t - 1], succ_pick[:, t]]
                toks[:, t] = np.where(follow[:, t], nxt, fresh[:, t])
        else:
            toks[:] = rng.choice(v, size=(b, s), p=self.probs)
        return {"tokens": toks}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        i = step
        while True:
            yield self.batch(i)
            i += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The counterpart of the JAX package's ``shard_batch`` on one device:
    every array onto ``device``, integer ids as int64 (torch's index type)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out
