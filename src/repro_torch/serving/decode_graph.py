"""Greedy decode steps replayed from CUDA graphs.

A model whose decode step never waits for the host (:func:`graph_route`:
every sublayer a GQA mixer with a dense or MoE MLP, on the card) has its
whole greedy step captured once for each batch size and replayed at every
step: the same kernels in the same order at the same precision, K2 included,
with the host's launch work gone. The MoE dispatch has no host sync, and
adds its pair counts to a tensor on the device (``moe.pair_counts``), so a
replay counts them too. MLA keeps its latent caches at no fixed address
(``engine.pad_caches``), and Mamba's and RWKV's states are not yet written
in place: those models, the CPU and sampled generation keep the engine's
eager loop.

Fixed addresses. A :class:`Step` (one batch size of one engine) owns the
token, lengths and finite-flag buffers; the step reads the token, the lengths
and the decode caches and writes the next token, the flag (``&=``) and the
lengths + 1 back in place. The engine's prefill writes each layer's K/V
straight into the step's cache views (``model.prefill(caches=...)``, as it
writes into fresh caches off this route), and :meth:`DecodeGraphs.start` its
argmax, lengths and finite flag into the buffers.

Memory. A :class:`DecodeStore` holds the decode caches of one device, one
pair of (layers, batch, slots, KV heads, head dim) tensors for each cache
geometry (group, sublayer, slots, KV heads, head dim, dtype), shared by every
engine of that geometry and sized for the most layers and the largest batch
(rounded up to a power of two) that have used it; a step binds
``[:layers, :n]`` views. Slots past a row's length hold what an earlier
batch left there: the decode mask keeps the attention off them. Every graph
of a store draws on one memory pool: replays on one stream never overlap,
and no graph keeps a tensor of the pool alive but its own logits. When a
cache grows, every step bound to it is re-bound and re-captured at once.
Engines hold their store, and the store only refers to them weakly: when the
last engine of a device goes, its caches, pool and graphs go with it.

Counters. The store counts the graphs captured on its device
(``captures``), an engine's graphs the steps replayed (``replays``). Capture
launches nothing, so the kernels' ``launches`` counters (and launches by
route), and the kernel-call counters open in :func:`replayed_calls`, are
put back after a capture, and each replay adds what it captured.

On the CPU nothing is recorded: a step is built without a graph and each
replay runs it eagerly on the same buffers and views, counted as on the
card; the tests hold that path bit for bit against the eager loop (the
engine itself keeps the eager loop there).
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import resolve_dtype

# a cache geometry: (group, sublayer index, slots, KV heads, head dim, dtype)
Geometry = Tuple[str, int, int, int, int, torch.dtype]

# the store of each device, alive while an engine holds it
_STORES: "weakref.WeakValueDictionary[torch.device, DecodeStore]" = \
    weakref.WeakValueDictionary()
# the capture stream of each device, kept for the process as ``torch.cuda.graph``
# keeps its own: cuBLAS keeps a workspace (64 MiB on an H100) for every stream
# it has run on, so a stream of each store would leave one behind a store
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
# the kernel-call counters open in :func:`replayed_calls`
_CALL_COUNTERS: List[collections.Counter] = []


def graph_route(cfg: ModelConfig, device: torch.device) -> bool:
    """Whether greedy decode steps of ``cfg`` on ``device`` replay from CUDA
    graphs: on the card, and only where every sublayer is a GQA mixer with a
    dense or MoE MLP (no host sync in the step, every cache at a fixed
    address). MLA, Mamba and RWKV take the eager loop."""
    return device.type == "cuda" and all(
        sl.mixer == "gqa" and sl.mlp in ("dense", "moe")
        for g in tfm.layer_plan(cfg) for sl in g.pattern)


def kv_layout(cfg: ModelConfig, max_len: int) -> List[Tuple[Geometry, int]]:
    """(geometry, layers) of each GQA sublayer of ``cfg``'s decode caches, in
    the order of its layer plan."""
    dtype = resolve_dtype(cfg.dtype)
    out = []
    for g in tfm.layer_plan(cfg):
        for i, sl in enumerate(g.pattern):
            if sl.mixer == "gqa":
                window = attn_lib.layer_window(cfg, sl.is_global)
                slots = max_len if window is None else min(window, max_len)
                out.append(((g.name, i, slots, cfg.num_kv_heads, cfg.head_dim, dtype),
                            g.n_units))
    return out


def kv_tree(cfg: ModelConfig, caches: List[attn_lib.KVCache]) -> dict:
    """The cache tree (group -> ``sub<i>``) of ``caches``, one a GQA sublayer
    in :func:`kv_layout`'s order; None at every other sublayer."""
    it = iter(caches)
    return {g.name: {f"sub{i}": next(it) if sl.mixer == "gqa" else None
                     for i, sl in enumerate(g.pattern)}
            for g in tfm.layer_plan(cfg)}


@contextlib.contextmanager
def replayed_calls(counter: collections.Counter):
    """While open, ``counter`` (kernel calls that its owner counts at the
    kernel entries) follows the replays as the launch counters do: a capture
    takes off the calls it recorded, and each replay of its graph adds them
    again. Steps captured while it is closed add nothing to it."""
    _CALL_COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _CALL_COUNTERS[:] = [c for c in _CALL_COUNTERS if c is not counter]


def store_for(device: torch.device) -> "DecodeStore":
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    store = _STORES.get(device)
    if store is None:
        store = _STORES[device] = DecodeStore(device)
    return store


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class DecodeStore:
    """The decode caches of one device by geometry, and the graph memory
    pool and capture stream every step bound to them shares. ``captures``
    counts the steps built on the device by any engine (on the card, each a
    graph captured)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.caches: Dict[Geometry, attn_lib.KVCache] = {}   # (L, B, S, KV, D) each
        self.users: "weakref.WeakSet[DecodeGraphs]" = weakref.WeakSet()
        self.graphs: "weakref.WeakSet[torch.cuda.CUDAGraph]" = weakref.WeakSet()
        self.captures = 0
        self._pool = None

    def capture_pool_and_stream(self):
        """The pool a new graph shares and the stream it is captured on. A
        pool whose graphs have all gone cannot take a new one (the allocator
        only frees it), so a new pool starts then."""
        if self.device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(self.device)
        if not self.graphs:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool, _CAPTURE_STREAMS[self.device]

    def reserve(self, layout: List[Tuple[Geometry, int]], n: int):
        """Grow each cache of ``layout`` ((geometry, layers) pairs) to hold
        its layers and ``n`` rows; every step bound to a grown cache is
        re-bound (and re-captured) before this returns."""
        grown = set()
        for geo, layers in layout:
            c = self.caches.get(geo)
            if c is not None and c.k.shape[0] >= layers and c.k.shape[1] >= n:
                continue
            have = (0, 0) if c is None else tuple(c.k.shape[:2])
            shape = (max(layers, have[0]), _pow2(max(n, have[1]))) + geo[2:5]
            self.caches[geo] = attn_lib.KVCache(
                *(torch.zeros(shape, dtype=geo[5], device=self.device) for _ in "kv"))
            grown.add(geo)
        if grown:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # no replay still reads what goes
            for user in list(self.users):
                user.rebind(grown)

    def views(self, layout: List[Tuple[Geometry, int]], n: int) -> List[attn_lib.KVCache]:
        return [attn_lib.KVCache(*(t[:layers, :n] for t in self.caches[geo]))
                for geo, layers in layout]


class Step:
    """The step of one batch size: its buffers, its cache views (the decode
    cache tree), whether it is built, its graph (on the card), the logits of
    its last run, and what its capture took off the launch and call
    counters."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.tok = torch.zeros(n, dtype=torch.long, device=device)
        self.lengths = torch.zeros(n, dtype=torch.long, device=device)
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.caches: Optional[dict] = None
        self.built = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launched: Dict[str, Tuple[int, Dict[str, int]]] = {}
        self.calls: List[Tuple[collections.Counter, collections.Counter]] = []


def _launch_counts() -> Dict[str, Tuple[int, Dict[str, int]]]:
    return {name: (m.launches, dict(getattr(m, "launches_by_route", {})))
            for name, m in kops.KERNELS.items()}


class DecodeGraphs:
    """An engine's greedy steps, one a batch size, bound to its device's
    store. ``replays`` counts the steps it replayed. Holds no reference to
    its engine, so that dropping the engine frees it at once."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int, use_kernels: bool,
                 device: torch.device):
        self.cfg, self.params, self.use_kernels = cfg, params, use_kernels
        self.device = device
        self.layout = kv_layout(cfg, max_len)
        self.steps: Dict[int, Step] = {}
        self.replays = 0
        self.store = store_for(device)
        self.store.users.add(self)

    def step_for(self, n: int) -> Step:
        """The step of batch size ``n`` with its caches bound; the store grows
        (and re-captures the steps bound to it) where ``n`` needs it. A new
        step is captured by :meth:`start`, after the prefill that fills it:
        that prefill has loaded the kernels and cuBLAS before any capture."""
        st = self.steps.get(n)
        if st is None:
            self.store.reserve(self.layout, n)
            st = self.steps[n] = Step(n, self.device)
            self._bind(st)
        return st

    def start(self, st: Step, logits: torch.Tensor, lengths: torch.Tensor):
        """The prefill's argmax, lengths and finite flag into ``st``'s
        buffers; its graph captured if it has none yet."""
        st.tok.copy_(torch.argmax(logits, dim=-1))
        st.lengths.copy_(lengths)
        st.finite.copy_(torch.isfinite(logits).all())
        if not st.built:
            self._capture(st)

    def replay(self, st: Step):
        """One step: the graph's replay, with its captured launches and calls
        counted again; on the CPU the step run eagerly."""
        self.replays += 1
        if st.graph is None:
            st.logits = self._step(st)
            return
        st.graph.replay()
        for name, (n, routes) in st.launched.items():
            mod = kops.KERNELS[name]
            mod.launches += n
            for r, k in routes.items():
                mod.launches_by_route[r] += k
        for counter, calls in st.calls:
            if any(counter is c for c in _CALL_COUNTERS):
                counter.update(calls)

    def rebind(self, grown):
        """Re-bind (and re-capture) every step that uses a grown cache."""
        if any(geo in grown for geo, _ in self.layout):
            for st in self.steps.values():
                built = st.built
                self._bind(st)
                if built:
                    self._capture(st)

    def _bind(self, st: Step):
        st.caches = kv_tree(self.cfg, self.store.views(self.layout, st.n))
        st.graph = st.logits = None
        st.built = False

    def _step(self, st: Step) -> torch.Tensor:
        logits, _, lengths = model_lib.decode_step(
            self.cfg, self.params, st.caches, st.lengths, st.tok,
            use_kernels=self.use_kernels)
        st.finite &= torch.isfinite(logits).all()
        st.tok.copy_(torch.argmax(logits, dim=-1))
        st.lengths.copy_(lengths)
        return logits

    def _capture(self, st: Step):
        """Build ``st``'s step, counted in the store's ``captures``. On the
        card it is recorded into a graph on the device's capture stream, in
        the store's pool: nothing runs, and the launch counters and the call
        counters of :func:`replayed_calls` are put back. On the CPU nothing
        is recorded."""
        self.store.captures += 1
        st.built = True
        if self.device.type != "cuda":
            return
        pool, stream = self.store.capture_pool_and_stream()
        before = _launch_counts()
        calls0 = [(c, collections.Counter(c)) for c in _CALL_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                st.logits = self._step(st)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        st.launched = {}
        for name, (n0, routes0) in before.items():
            mod = kops.KERNELS[name]
            routes = getattr(mod, "launches_by_route", {})
            if mod.launches != n0:
                st.launched[name] = (mod.launches - n0,
                                     {r: k - routes0.get(r, 0) for r, k in routes.items()})
                mod.launches = n0
                routes.update(routes0)
        st.calls = []
        for counter, c0 in calls0:
            calls = counter - c0
            counter.subtract(calls)
            st.calls.append((counter, calls))
        st.graph = graph
        self.store.graphs.add(graph)
