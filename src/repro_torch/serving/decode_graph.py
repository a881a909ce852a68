"""Decode steps at fixed addresses, replayed from CUDA graphs where they can be.

Every engine decodes through one :class:`DecodeSteps`: a :class:`Step` for
each batch size, bound to a decode cache tree of that size in its device's
:class:`DecodeStore`. The engine's prefill writes every layer's cache into
the step's tree (``model.prefill(caches=...)``: K/V, MLA latents and rope
keys, Mamba and RWKV states), :meth:`DecodeSteps.start` writes its argmax,
lengths and finite flag into the step's buffers, and each
:meth:`DecodeSteps.replay` runs one step, which reads the token, the lengths
and the caches and writes the next token, the flag (``&=``) and the lengths
+ 1 back in place.

Where :func:`graph_route` allows it (on the card, every sublayer a GQA or
MLA mixer with a dense or MoE MLP: no host sync in the step), a greedy step
is captured into a CUDA graph once for each batch size and replayed at every
step: the same kernels in the same order at the same precision, K2 included,
with the host's launch work gone. MLA's absorbed decode writes its latent
and rope-key rows at ``lengths`` on the device, and YaRN's frequency table
is built by the prefill, before any capture. The MoE dispatch has no host
sync, and adds its pair counts to a tensor on the device
(``moe.pair_counts``), so a replay counts them too. Elsewhere (Mamba, RWKV,
the CPU), and for sampled generation, which draws each token from the
caller's generator by ``multinomial``, the same step runs eagerly on the
same buffers.

Memory. A :class:`DecodeStore` holds the decode caches of one device: one
``(layers, batch, ...)`` tensor for each tensor of a cache tree, keyed by
(group, sublayer, field, shape after ``(layers, batch)``, dtype)
(:func:`cache_layout`, read off ``transformer.abstract_cache``), shared by
every engine whose tree has that key and sized for the most layers and the
largest batch (rounded up to a power of two) that have used it; a step binds
``[:layers, :n]`` views, which rebuild the tree. Slots past a row's length
hold what an earlier batch left there: the decode masks keep the attention
off them, and the prefill overwrites a recurrent state whole. Every graph of
a store draws on one memory pool: replays on one stream never overlap, and
no graph keeps a tensor of the pool alive but its own logits. When a tensor
grows, every step bound to it is re-bound, and re-captured at once if it had
a graph. Engines hold their store, and the store only refers to them weakly:
when the last engine of a device goes, its caches, pool and graphs go with
it.

Counters. The store counts the graphs captured on its device
(``captures``), a runner the graphs it replayed (``replays``); both stay 0
where nothing is captured. Capture launches nothing, so the kernels'
``launches`` counters (and launches by route), and the kernel-call counters
open in :func:`replayed_calls`, are put back after a capture, and each
replay adds what it captured.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import resolve_dtype

# a tensor of a cache tree: (group, sublayer, field, shape after (layers, batch), dtype)
Key = Tuple[str, str, str, Tuple[int, ...], torch.dtype]

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
    graphs: on the card, and only where every sublayer is a GQA or MLA mixer
    with a dense or MoE MLP (no host sync in the step). Mamba and RWKV run
    their steps eagerly."""
    return device.type == "cuda" and all(
        sl.mixer in ("gqa", "mla") and sl.mlp in ("dense", "moe")
        for g in tfm.layer_plan(cfg) for sl in g.pattern)


def cache_layout(cfg: ModelConfig, max_len: int) -> dict:
    """``cfg``'s decode cache tree of ``max_len`` slots
    (``transformer.abstract_cache``, in ``cfg.dtype``) with each tensor
    replaced by its (key, layers)."""
    tree = tfm.abstract_cache(cfg, 1, max_len, resolve_dtype(cfg.dtype))
    return {g: {sub: type(c)(*(((g, sub, f, tuple(t.shape[2:]), t.dtype), t.shape[0])
                               for f, t in zip(c._fields, c)))
                for sub, c in unit.items()}
            for g, unit in tree.items()}


def _entries(layout: dict) -> List[Tuple[Key, int]]:
    return [e for unit in layout.values() for c in unit.values() for e in c]


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
    """The decode cache tensors of one device by key, and the graph memory
    pool and capture stream every step bound to them shares. ``captures``
    counts the graphs captured on the device by any engine."""

    def __init__(self, device: torch.device):
        self.device = device
        self.caches: Dict[Key, torch.Tensor] = {}   # (layers, batch, ...) each
        self.users: "weakref.WeakSet[DecodeSteps]" = weakref.WeakSet()
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

    def reserve(self, layout: dict, n: int):
        """Grow each tensor of ``layout`` (:func:`cache_layout`) to hold its
        layers and ``n`` rows; every step bound to a grown tensor is
        re-bound (and re-captured) before this returns."""
        grown = set()
        for key, layers in _entries(layout):
            t = self.caches.get(key)
            if t is not None and t.shape[0] >= layers and t.shape[1] >= n:
                continue
            have = (0, 0) if t is None else tuple(t.shape[:2])
            shape = (max(layers, have[0]), _pow2(max(n, have[1]))) + key[3]
            self.caches[key] = torch.zeros(shape, dtype=key[4], device=self.device)
            grown.add(key)
        if grown:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # no replay still reads what goes
            for user in list(self.users):
                user.rebind(grown)

    def views(self, layout: dict, n: int) -> dict:
        """The cache tree of ``layout`` for ``n`` rows, in ``[:layers, :n]``
        views of the store's tensors."""
        return {g: {sub: type(c)(*(self.caches[key][:layers, :n] for key, layers in c))
                    for sub, c in unit.items()}
                for g, unit in layout.items()}


class Step:
    """The step of one batch size: its buffers, its cache views (the decode
    cache tree), its graph where one was captured, the logits that graph
    writes, and what its capture took off the launch and call counters."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.tok = torch.zeros(n, dtype=torch.long, device=device)
        self.lengths = torch.zeros(n, dtype=torch.long, device=device)
        self.finite = torch.ones((), dtype=torch.bool, device=device)
        self.caches: Optional[dict] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launched: Dict[str, Tuple[int, Dict[str, int]]] = {}
        self.calls: List[Tuple[collections.Counter, collections.Counter]] = []


def _launch_counts() -> Dict[str, Tuple[int, Dict[str, int]]]:
    return {name: (m.launches, dict(getattr(m, "launches_by_route", {})))
            for name, m in kops.KERNELS.items()}


def _record(store: DecodeStore, fn) -> torch.cuda.CUDAGraph:
    """``fn`` recorded into a CUDA graph on the store's capture stream, in
    its pool (nothing runs)."""
    pool, stream = store.capture_pool_and_stream()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(store.device))
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(store.device).wait_stream(stream)
    store.graphs.add(graph)
    return graph


class DecodeSteps:
    """An engine's decode steps, one a batch size, bound to its device's
    store. ``captured`` (:func:`graph_route`) says whether a greedy step is
    captured into a CUDA graph; ``replays`` counts the graphs replayed.
    Holds no reference to its engine, so that dropping the engine frees it
    at once."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int, use_kernels: bool,
                 device: torch.device):
        self.cfg, self.params, self.use_kernels = cfg, params, use_kernels
        self.device = device
        self.captured = graph_route(cfg, device)
        self.layout = cache_layout(cfg, max_len)
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

    def start(self, st: Step, logits: torch.Tensor, lengths: torch.Tensor,
              sample_gen: Optional[torch.Generator] = None):
        """The prefill's argmax, lengths and finite flag into ``st``'s
        buffers; a greedy step on the graph route captured if it has no
        graph yet."""
        st.tok.copy_(torch.argmax(logits, dim=-1))
        st.lengths.copy_(lengths)
        st.finite.copy_(torch.isfinite(logits).all())
        if self.captured and sample_gen is None and st.graph is None:
            self._capture(st)

    def replay(self, st: Step, sample_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step; returns its logits. A captured greedy step replays its
        graph, with its captured launches and calls counted again; any other
        runs eagerly, a sampled one drawing from ``sample_gen``."""
        if st.graph is None or sample_gen is not None:
            return self._step(st, sample_gen)
        self.replays += 1
        st.graph.replay()
        for name, (n, routes) in st.launched.items():
            mod = kops.KERNELS[name]
            mod.launches += n
            for r, k in routes.items():
                mod.launches_by_route[r] += k
        for counter, calls in st.calls:
            if any(counter is c for c in _CALL_COUNTERS):
                counter.update(calls)
        return st.logits

    def rebind(self, grown):
        """Re-bind (and re-capture) every step that uses a grown tensor."""
        if any(key in grown for key, _ in _entries(self.layout)):
            for st in self.steps.values():
                captured = st.graph is not None
                self._bind(st)
                if captured:
                    self._capture(st)

    def _bind(self, st: Step):
        st.caches = self.store.views(self.layout, st.n)
        st.graph = st.logits = None

    def _step(self, st: Step, sample_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        logits, _, lengths = model_lib.decode_step(
            self.cfg, self.params, st.caches, st.lengths, st.tok,
            use_kernels=self.use_kernels)
        st.finite &= torch.isfinite(logits).all()
        if sample_gen is None:
            st.tok.copy_(torch.argmax(logits, dim=-1))
        else:
            probs = torch.softmax(logits, dim=-1)
            st.tok.copy_(torch.multinomial(probs, 1, generator=sample_gen)[:, 0])
        st.lengths.copy_(lengths)
        return logits

    def _capture(self, st: Step):
        """Record ``st``'s greedy step into a graph (:func:`_record`),
        counted in the store's ``captures``: nothing runs, so the launch
        counters and the call counters of :func:`replayed_calls` are put
        back."""
        self.store.captures += 1
        before = _launch_counts()
        calls0 = [(c, collections.Counter(c)) for c in _CALL_COUNTERS]

        def step():
            st.logits = self._step(st)
        st.graph = _record(self.store, step)
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
