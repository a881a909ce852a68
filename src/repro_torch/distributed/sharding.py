"""Logical-axis sharding rules -> partition specs, with no devices behind them.

Params and activations are annotated with *logical* dims (``ParamSpec.dims``
and the ``shard_activation`` call sites). A ``Rules`` object maps each
logical dim to a priority list of mesh-axis tuples; the first candidate
whose axes exist in the mesh, are unused within the tensor, and evenly
divide the dim size wins. This gives graceful degradation (e.g. mixtral's 8
experts can't shard over a 16-way axis -> fall through to sharding d_model)
without per-arch special cases.

Rule sets:
  * TRAIN  — fully-sharded params (ZeRO-3-ish: big tensors sharded over both
    data and model axes), batch over (pod, data).
  * SERVE  — TP + EP: params sharded over model (+ experts over the full
    chip grid when divisible), replicated over data so decode steps pay no
    per-layer param all-gathers; batch over data.
  * SERVE_LONG — long-context decode (batch=1): KV/sequence dims take the
    data axis (sequence parallelism), params as SERVE.

One card places no shard, so here a mesh is a plain object of axis names
and sizes and a spec is a tuple: each entry ``None``, an axis name or a
tuple of axis names, trailing ``None``s dropped (as ``PartitionSpec``
normalises), so ``tuple(jax_spec) == spec`` entry for entry. The plans of
the reference's 16x16 and 2x16x16 meshes are computed and checked without
devices; :func:`per_device_bytes` gives what one device of such a plan
holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

AxisCand = Tuple[str, ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, with no devices behind them."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: Spec


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec uses, in order."""
    return tuple(a for part in spec if part is not None
                 for a in (part if isinstance(part, tuple) else (part,)))


@dataclasses.dataclass
class Rules:
    mesh: Mesh
    table: Dict[str, List[AxisCand]]
    name: str = "custom"

    def spec_for(self, shape: Sequence[int], dims: Sequence[Optional[str]]) -> Spec:
        assert len(shape) == len(dims), (shape, dims)
        used: set = set()
        parts = []
        axis_sizes = self.mesh.shape
        for size, dim in zip(shape, dims):
            choice = None
            for cand in self.table.get(dim, ()):
                if not all(a in axis_sizes and a not in used for a in cand):
                    continue
                total = math.prod(axis_sizes[a] for a in cand)
                if total > 1 and size % total == 0:
                    choice = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
            parts.append(choice)
        while parts and parts[-1] is None:   # normalise
            parts.pop()
        return tuple(parts)

    def named_sharding(self, shape, dims) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(shape, dims))


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching)`` over a tree of dicts and (named) tuples whose
    leaves are tensors; ``rest`` are trees of the same structure (a leaf of
    theirs may be a logical-dims tuple)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, *args) for args in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def tree_shardings(rules: Rules, shapes_tree, axes_tree):
    """shapes_tree: tree of tensors (``meta`` ones do); axes_tree: matching
    structure whose leaves are logical-dims tuples."""
    return tree_map(lambda s, a: rules.named_sharding(tuple(s.shape), a),
                    shapes_tree, axes_tree)


def per_device_bytes(rules: Rules, tree, axes) -> int:
    """Bytes one device holds when ``tree`` (tensors, ``meta`` ones do) is
    laid out by ``rules`` over its logical ``axes``: each leaf's bytes over
    the product of the mesh axes its spec uses (the spec only takes axes
    that divide their dim, so the division is exact)."""
    sizes = rules.mesh.shape
    total = [0]

    def one(leaf, dims):
        spec = rules.spec_for(tuple(leaf.shape), dims)
        split = math.prod(sizes[a] for a in spec_axes(spec))
        total[0] += leaf.numel() * leaf.element_size() // split
    tree_map(one, tree, axes)
    return total[0]


# ----------------------------------------------------------------------
_TRAIN_TABLE: Dict[str, List[AxisCand]] = {
    # params — fully sharded (FSDP x TP)
    "vocab": [("model",)],
    "d_model": [("pod", "data"), ("data",)],
    "d_model_out": [("model",)],
    "heads": [("model",)],
    "heads_flat": [("model",)],
    "kv_heads": [("model",)],
    "d_ff": [("model",)],
    "expert_ff": [("model",)],
    "experts": [("pod", "data"), ("data",)],
    "lora": [("model",)],
    "lora_out": [("model",)],
    # activations
    "batch": [("pod", "data"), ("data",)],
    "seq": [],
    # attention-score fallback: if kv/q heads can't take the model axis
    # (e.g. 8 kv heads on a 16-way axis), shard the query-seq dim instead
    "scores_seq": [("model",)],
}

_SERVE_TABLE: Dict[str, List[AxisCand]] = {
    # params — TP (+EP over the full grid when divisible); replicated on data
    "vocab": [("model",)],
    "d_model": [],
    "d_model_out": [("model",)],
    "heads": [("model",)],
    "heads_flat": [("model",)],
    "kv_heads": [("model",)],
    "d_ff": [("model",)],
    "expert_ff": [("model",)],
    "experts": [("pod", "data", "model"), ("data", "model"), ("model",)],
    "lora": [],
    "lora_out": [("model",)],
    # activations / caches: batch over data; the KV-cache sequence dim over
    # model so the cache (the decode working set) is sharded over ALL chips
    "batch": [("pod", "data"), ("data",)],
    "seq": [],
    "kv_seq": [("model",)],
    # prefill: O(S^2) scores need the same fallback sharding as train
    "scores_seq": [("model",)],
}

_SERVE_LONG_TABLE: Dict[str, List[AxisCand]] = dict(
    _SERVE_TABLE,
    batch=[],
    # batch=1: shard sequence dims instead (sequence parallelism)
    seq=[("pod", "data"), ("data",)],
    kv_seq=[("pod", "data", "model"), ("data", "model"), ("model",)],
)

_TABLES = {"train": _TRAIN_TABLE, "serve": _SERVE_TABLE,
           "serve_long": _SERVE_LONG_TABLE}


def make_rules(mesh: Mesh, mode: str) -> Rules:
    return Rules(mesh=mesh, table=_TABLES[mode], name=mode)


def param_shardings(rules: Rules, cfg):
    """Shardings for the full model param tree."""
    from repro_torch.models import transformer as tfm
    return tree_shardings(rules, tfm.abstract_params(cfg), tfm.param_logical_axes(cfg))


def cache_logical_axes(abstract):
    """Logical dims of every leaf of a cache tree, by shape pattern: the
    leading dim is n_units (layers, never sharded), the next the batch; a
    third dim of 1024 or more is the KV (or latent) cache's sequence."""
    def dims(leaf):
        out: List[Optional[str]] = [None] * leaf.ndim
        if leaf.ndim >= 2:
            out[1] = "batch"
        if leaf.ndim >= 3 and leaf.shape[2] >= 1024:
            out[2] = "kv_seq"
        return tuple(out)
    return tree_map(dims, abstract)


def cache_shardings(rules: Rules, cfg, batch: int, max_len: int):
    """Shardings for the decode-cache tree (dims as :func:`cache_logical_axes`
    gives them)."""
    from repro_torch.models import transformer as tfm
    abstract = tfm.abstract_cache(cfg, batch, max_len)
    return tree_shardings(rules, abstract, cache_logical_axes(abstract))
