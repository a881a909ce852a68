"""Serving engine: prefill -> padded decode caches -> batched decode loop.

The engine owns one model variant on one device. The paper's Local Node
"Inference" state calls into this; the Gateway's dispatcher decides which
variant each worker group loads.

Cache layout notes:
  * prefill returns raw seq-length caches; ``pad_caches`` places them into
    max_len decode buffers. For sliding-window layers the cache is a ring
    buffer keyed by absolute position (slot = pos % window), so the last
    `window` tokens are rolled so that slot (pos % window) holds position
    pos. MLA latents and rope keys are zero-padded to max_len. Mamba and
    RWKV states are fixed-size and pass through unchanged.
  * decode writes the caches **in place**: ``Engine.decode`` hands back the
    cache tree it was given. This replaces the buffer donation
    (``donate_argnums``) of the JAX engine.

Device rule: ``device=None`` means the card and raises when there is none;
the CPU is used only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.core.batching import BatchFormation
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import resolve_device


def _pad_kv(raw: attn_lib.KVCache, max_len: int, seq_len: int,
            window: Optional[int]) -> attn_lib.KVCache:
    """raw.k: (L, B, S, KV, D) stacked per group-unit. Returns decode cache."""
    def pad_one(x):
        if window is None:
            pad = max_len - x.shape[2]
            return F.pad(x, (0, 0, 0, 0, 0, pad))
        w = min(window, max_len)
        # ring buffer: slot = pos % w must hold position pos
        if x.shape[2] >= w:
            last = x[:, :, -w:]                      # positions S-w .. S-1
            return torch.roll(last, shifts=seq_len % w, dims=2)
        return F.pad(x, (0, 0, 0, 0, 0, w - x.shape[2]))
    return attn_lib.KVCache(k=pad_one(raw.k), v=pad_one(raw.v))


def pad_caches(cfg: ModelConfig, raw_caches, seq_len: int, max_len: int):
    """Convert prefill caches (raw length) to decode caches (max_len)."""
    assert max_len >= seq_len, (
        f"decode max_len={max_len} shorter than prefill length {seq_len} "
        "(stub-frontend archs prepend stub_embed_len positions)")
    out = {}
    for g in tfm.layer_plan(cfg):
        unit_out = {}
        for i, sl in enumerate(g.pattern):
            c = raw_caches[g.name][f"sub{i}"]
            if sl.mixer == "gqa":
                window = attn_lib.layer_window(cfg, sl.is_global)
                unit_out[f"sub{i}"] = _pad_kv(c, max_len, seq_len, window)
            elif sl.mixer == "mla":   # (L, B, S, r) latent, (L, B, S, rope) key
                pad = max_len - c.latent.shape[2]
                unit_out[f"sub{i}"] = attn_lib.MLACache(
                    latent=F.pad(c.latent, (0, 0, 0, pad)),
                    k_rope=F.pad(c.k_rope, (0, 0, 0, pad)))
            else:   # Mamba and RWKV states are fixed-size
                unit_out[f"sub{i}"] = c
        out[g.name] = unit_out
    return out


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 512
    use_kernels: bool = True      # the hand-written CUDA kernels (on the card)


class Engine:
    """One model variant on one device (None: the card)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: Optional[EngineConfig] = None,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        self.device = resolve_device(device)
        self.last_stats: dict = {}

    def _to_device(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    @torch.inference_mode()
    def prefill(self, tokens, embeds=None):
        # a copy from pageable host memory: the host waits for the stream
        with trace.host_sync("engine.upload"):
            tokens = self._to_device(tokens, torch.long)
        if embeds is not None:
            with trace.host_sync("engine.upload"):
                embeds = self._to_device(embeds)
        with trace.span("engine.prefill"):
            logits, raw = model_lib.prefill(self.cfg, self.params, tokens, embeds,
                                            use_kernels=self.ecfg.use_kernels)
        seq_len = tokens.shape[1] + (embeds.shape[1] if embeds is not None else 0)
        with trace.span("engine.pad_caches"):
            caches = pad_caches(self.cfg, raw, seq_len, self.ecfg.max_len)
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
        """Greedy (or sampled) generation; returns (B, num_steps) tokens.
        Leaves ``last_stats`` behind: ``prefill_ms`` and ``step_ms`` (one
        interval a decode step; device time from CUDA events on the card,
        host clock on the CPU), ``decode_ms_per_step`` (their mean), the
        host time of prefill and of the decode loop less the waits of the
        host syncs counted inside each (``prefill_host_ms``,
        ``decode_host_ms``), the batch's host syncs by name (``syncs``, see
        ``core.trace``) and whether every logit was finite."""
        clock = _Clock(self.device)
        counts0, wait0 = dict(trace.counts), trace.wait_s()
        host0 = time.perf_counter()
        clock.mark()
        logits, caches, lengths = self.prefill(tokens, embeds)
        clock.mark()
        host1, wait1 = time.perf_counter(), trace.wait_s()
        finite = torch.isfinite(logits).all()
        out = []
        tok = torch.argmax(logits, dim=-1)
        for _ in range(num_steps):
            with trace.span("engine.decode_step"):
                out.append(tok)
                logits, caches, lengths = self.decode(caches, lengths, tok)
                finite &= torch.isfinite(logits).all()
                if sample_gen is not None:
                    probs = torch.softmax(logits, dim=-1)
                    tok = torch.multinomial(probs, 1, generator=sample_gen)[:, 0]
                else:
                    tok = torch.argmax(logits, dim=-1)
                clock.mark()        # ends this step's interval, starts the next's
        host2, wait2 = time.perf_counter(), trace.wait_s()
        with trace.host_sync("engine.collect"):
            toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        with trace.host_sync("engine.collect"):
            finite = bool(finite.item())
        prefill_ms, *step_ms = clock.intervals_ms()
        self.last_stats = {"prefill_ms": prefill_ms,
                           "decode_ms_per_step": sum(step_ms) / max(num_steps, 1),
                           "finite": finite, "step_ms": step_ms,
                           "prefill_host_ms": (host1 - host0 - (wait1 - wait0)) * 1e3,
                           "decode_host_ms": (host2 - host1 - (wait2 - wait1)) * 1e3,
                           "syncs": trace.counts_since(counts0)}
        return toks


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
