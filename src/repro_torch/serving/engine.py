"""Serving engine: prefill into decode caches -> batched decode loop.

The engine owns one model variant on one device. The paper's Local Node
"Inference" state calls into this; the Gateway's dispatcher decides which
variant each worker group loads.

Cache notes:
  * the decode cache tree is the model's (``transformer.init_cache``: GQA
    K/V, MLA latents and rope keys, Mamba and RWKV states), and the prefill
    writes every layer's cache straight into it
    (``transformer.place_cache``): a fresh tree for :meth:`Engine.prefill`,
    a decode step's fixed one in :meth:`Engine.generate`. A sliding-window
    layer's cache is a ring buffer keyed by absolute position (slot = pos %
    window): the last `window` tokens are rolled so that slot (pos % window)
    holds position pos.
  * decode writes the caches **in place**: ``Engine.decode`` hands back the
    cache tree it was given. This replaces the buffer donation
    (``donate_argnums``) of the JAX engine.
  * ``generate`` runs one decode loop for every model, over the steps of
    ``serving.decode_graph``: each replayed from a CUDA graph where
    ``decode_graph.graph_route`` allows it (on the card, GQA and MLA models
    with dense or MoE MLPs), run eagerly on the same buffers elsewhere
    (Mamba, RWKV, the CPU, sampled generation).

Device rule: ``device=None`` means the card and raises when there is none;
the CPU is used only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.core.batching import BatchFormation
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import resolve_device, resolve_dtype
from repro_torch.serving import decode_graph


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 512
    use_kernels: bool = True      # the hand-written CUDA kernels (on the card)


class Engine:
    """One model variant on one device (None: the card). ``runner`` holds its
    decode steps, each replayed from a CUDA graph where
    :func:`decode_graph.graph_route` allows it (GQA and MLA models on the
    card) and run eagerly elsewhere."""

    def __init__(self, cfg: ModelConfig, params, ecfg: Optional[EngineConfig] = None,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        self.device = resolve_device(device)
        self.last_stats: dict = {}
        self.runner = decode_graph.DecodeSteps(
            cfg, params, max_len=self.ecfg.max_len, use_kernels=self.ecfg.use_kernels,
            device=self.device)

    def _to_device(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    @torch.inference_mode()
    def prefill(self, tokens, embeds=None, out=None):
        """Returns (last-position logits, decode caches, lengths). Every layer
        writes its cache straight into the decode cache tree ``out`` where
        given (a decode step's), else into a fresh one
        (``transformer.init_cache``), which comes back; no prompt-length copy
        of it is kept."""
        # a copy from pageable host memory: the host waits for the stream
        with trace.host_sync("engine.upload"):
            tokens = self._to_device(tokens, torch.long)
        if embeds is not None:
            with trace.host_sync("engine.upload"):
                embeds = self._to_device(embeds)
        seq_len = tokens.shape[1] + (embeds.shape[1] if embeds is not None else 0)
        assert self.ecfg.max_len >= seq_len, (
            f"decode max_len={self.ecfg.max_len} shorter than prefill length {seq_len} "
            "(stub-frontend archs prepend stub_embed_len positions)")
        if out is None:
            out = tfm.init_cache(self.cfg, tokens.shape[0], self.ecfg.max_len,
                                 resolve_dtype(self.cfg.dtype), self.device)
        with trace.span("engine.prefill"):
            logits, caches = model_lib.prefill(self.cfg, self.params, tokens, embeds,
                                               use_kernels=self.ecfg.use_kernels, caches=out)
        lengths = torch.full((tokens.shape[0],), seq_len, dtype=torch.long,
                             device=self.device)
        return logits, caches, lengths

    @torch.inference_mode()
    def decode(self, caches, lengths, tokens):
        """One step; ``caches`` is updated in place and returned."""
        tokens = self._to_device(tokens, torch.long)
        return model_lib.decode_step(self.cfg, self.params, caches, lengths,
                                     tokens, use_kernels=self.ecfg.use_kernels)

    @torch.inference_mode()
    def generate(self, tokens, num_steps: int, embeds=None,
                 sample_gen: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy (or sampled: each token after the first drawn by
        ``multinomial`` from ``sample_gen``) generation; returns (B,
        num_steps) tokens. Leaves ``last_stats`` behind: ``prefill_ms`` and
        ``step_ms`` (one interval a decode step; device time from CUDA events
        on the card, host clock on the CPU), ``decode_ms_per_step`` (their
        mean), the host time of prefill and of the decode loop less the waits
        of the host syncs counted inside each (``prefill_host_ms``,
        ``decode_host_ms``), the batch's host syncs by name (``syncs``, see
        ``core.trace``), whether every logit was finite, and the decode steps
        replayed from CUDA graphs and the graphs the device captured during
        the call (``graph_steps``, ``graph_captures``; 0 where no step is
        captured). A model with MoE layers adds ``moe_pairs``: by phase
        (``prefill``, ``decode``), the (token, expert) pairs routed, routed to
        the experts held, and dropped of those at capacity (``routed``,
        ``held``, ``dropped``), from device copies of ``moe.pair_counts``
        brought back with the finite flag. A model with RWKV layers adds
        ``wkv_tokens``: the token-layers whose recurrence ran through K4
        (``kernel``) and through the one-step update (``step``), counted on
        the host from shapes (``ssm.wkv_tokens``)."""
        clock = _Clock(self.device)
        counts0, wait0 = dict(trace.counts), trace.wait_s()
        pairs = moe_lib.pair_counts(self.device) if self.cfg.moe is not None else None
        snaps = [pairs.clone()] if pairs is not None else []
        rwkv = self.cfg.ssm is not None and self.cfg.ssm.kind == "rwkv6"
        wkv0 = dict(ssm.wkv_tokens) if rwkv else None
        runner = self.runner
        replays0, captures0 = runner.replays, runner.store.captures
        host0 = time.perf_counter()
        clock.mark()
        step = runner.step_for(len(tokens))
        logits, _, lengths = self.prefill(tokens, embeds, out=step.caches)
        clock.mark()
        host1, wait1 = time.perf_counter(), trace.wait_s()
        if pairs is not None:
            snaps.append(pairs.clone())
        runner.start(step, logits, lengths, sample_gen)
        out = torch.empty((len(tokens), num_steps), dtype=torch.long, device=self.device)
        for i in range(num_steps):
            with trace.span("engine.decode_step"):
                out[:, i].copy_(step.tok)
                runner.replay(step, sample_gen)
                clock.mark()        # ends this step's interval, starts the next's
        host2, wait2 = time.perf_counter(), trace.wait_s()
        if pairs is not None:
            snaps.append(pairs)
        with trace.host_sync("engine.collect"):
            toks = out.cpu().numpy().astype(np.int32)
        with trace.host_sync("engine.collect"):
            finite, *counts = torch.cat([step.finite.reshape(1).long(), *snaps]).tolist()
        finite = bool(finite)
        prefill_ms, *step_ms = clock.intervals_ms()
        self.last_stats = {"prefill_ms": prefill_ms,
                           "decode_ms_per_step": sum(step_ms) / max(num_steps, 1),
                           "finite": finite, "step_ms": step_ms,
                           "prefill_host_ms": (host1 - host0 - (wait1 - wait0)) * 1e3,
                           "decode_host_ms": (host2 - host1 - (wait2 - wait1)) * 1e3,
                           "syncs": trace.counts_since(counts0),
                           "graph_steps": runner.replays - replays0,
                           "graph_captures": runner.store.captures - captures0}
        if pairs is not None:
            self.last_stats["moe_pairs"] = {"prefill": _pairs(counts[0:3], counts[3:6]),
                                            "decode": _pairs(counts[3:6], counts[6:9])}
        if wkv0 is not None:
            self.last_stats["wkv_tokens"] = {k: n - wkv0[k] for k, n in ssm.wkv_tokens.items()}
        return toks


def _pairs(start: List[int], upto: List[int]) -> dict:
    """The MoE pairs ``routed``, ``held`` and ``dropped`` counted between two
    snapshots of ``moe.pair_counts``."""
    return {k: b - a for k, a, b in zip(("routed", "held", "dropped"), start, upto)}


class _Clock:
    """Marks on the device's timeline: CUDA events on the card (no
    synchronisation until the intervals are read), host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class BatchScheduler:
    """Batch scheduler for one worker group's prompt queue.

    Two modes sharing one :class:`~repro_torch.core.batching.BatchFormation`
    policy:

      * **static** (default): ``next_batch()`` drains up to ``batch_size``
        prompts whenever any are queued — partial batches launch
        immediately;
      * **continuous**: ``next_batch(now)`` launches a full batch at
        once, but holds a partial batch until its oldest prompt has
        waited ``window_s`` (join-on-arrival: prompts added meanwhile
        ride the same batch; a join that fills it makes the next call
        launch immediately).
    """

    def __init__(self, batch_size: int, *, continuous: bool = False,
                 window_s: float = 0.0):
        self.batch_size = batch_size
        self.continuous = continuous
        self.formation = BatchFormation(max_batch=batch_size,
                                        window_s=window_s)
        self.queue: List[np.ndarray] = []
        self._enqueue_s: List[float] = []

    def add(self, prompt: np.ndarray, now: float = 0.0):
        self.queue.append(prompt)
        self._enqueue_s.append(now)

    def next_batch(self, now: float = 0.0) -> Optional[np.ndarray]:
        if not self.queue:
            return None
        if self.continuous and not self.formation.ready(
                len(self.queue), now - self._enqueue_s[0]):
            return None             # hold the partial batch for joiners
        n = self.formation.take(len(self.queue))
        batch, self.queue = self.queue[:n], self.queue[n:]
        self._enqueue_s = self._enqueue_s[n:]
        max_l = max(len(p) for p in batch)
        out = np.zeros((n, max_l), dtype=np.int32)
        for i, p in enumerate(batch):
            out[i, -len(p):] = p      # left-pad
        return out
