"""Activation-sharding context: models call ``shard_activation(x, dims)``
with logical dims; a rule-set installed by the launcher decides where the
activation lives. With no rules installed (unit tests, the serving and
training paths) it is the identity: models stay mesh-agnostic.

One card places no shard. With rules over a mesh of one device the call
still computes the spec (so dims that do not fit the tensor fail as in the
JAX package) and returns ``x``; over a mesh of more than one device it
raises, since returning ``x`` there would hide that nothing was placed.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_sharding_rules(rules):
    """rules: repro_torch.distributed.sharding.Rules (carries the mesh)."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def shard_activation(x, dims: Tuple[Optional[str], ...]):
    rules = current_rules()
    if rules is None:
        return x
    spec = rules.spec_for(tuple(x.shape), dims)
    if rules.mesh.size > 1:
        raise RuntimeError(
            f"shard_activation: rules {rules.name!r} ask for spec {spec} over a "
            f"mesh of {rules.mesh.size} devices; one card cannot place shards")
    return x
