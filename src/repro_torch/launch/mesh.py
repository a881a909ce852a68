"""Meshes as plain objects of axis names and sizes.

``make_production_mesh`` and ``make_abstract_mesh`` give the reference's
16x16 (or 2x16x16) axis map with no devices behind it: the sharding rules
plan for it on any machine. ``make_local_mesh`` is capped by the cards
there are, as the JAX package caps it by ``jax.device_count()``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Mesh
from repro_torch.models.layers import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_abstract_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(shape))


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over the cards of ``device``'s kind (None: the
    card; without one this raises unless ``device="cpu"``, one device)."""
    device = resolve_device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if data * model > n:
        data, model = n, 1
    return Mesh(("data", "model"), (data, model))
