"""Checkpoint save / restore: one flat ``.npz`` per step + a JSON manifest.

The keys are the JAX package's: dict keys and NamedTuple field names joined
with ``/`` (``params/layers/sub0/mlp/w_up``, ``opt/mu/...``, ``opt/step``),
and bf16 leaves are stored as fp32. So a checkpoint written by either
package restores in the other. Files are written atomically (temporary file,
then rename); ``save`` keeps the last ``keep`` steps.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs; the key joins dict keys and NamedTuple fields."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), f"{prefix}{name}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaf_fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaf_fn, f"{prefix}{n}/")
                            for n in tree._fields))
    return leaf_fn(prefix[:-1], tree)


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(tree):
        t = leaf.detach()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()            # bf16 etc: npz can't round-trip them
        flat[key] = t.cpu().numpy()
    return flat


def _write_atomic(path: str, write) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    _write_atomic(path, lambda f: np.savez(f, **flat))
    manifest = os.path.join(ckpt_dir, "manifest.json")
    _write_atomic(manifest,
                  lambda f: f.write(json.dumps({"latest_step": step}).encode()))
    _gc(ckpt_dir, keep)
    return path


def _gc(ckpt_dir: str, keep: int):
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if re.fullmatch(r"step_\d+\.npz", f))
    for f in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))


def latest_step(ckpt_dir: str) -> Optional[int]:
    manifest = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        return json.load(f)["latest_step"]


def restore(ckpt_dir: str, step: int, target_tree: Any, device=None) -> Any:
    """A new tree with the structure, shapes and dtypes of ``target_tree``
    (tensors, possibly on the ``meta`` device) filled from the checkpoint.
    Leaves go to ``device``, or to each target leaf's own device when that is
    None."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        def load(key, leaf):
            arr = data[key]
            assert tuple(arr.shape) == tuple(leaf.shape), (key, arr.shape, leaf.shape)
            dev = device if device is not None else leaf.device
            return torch.from_numpy(np.array(arr)).to(device=dev, dtype=leaf.dtype)
        return _rebuild(target_tree, load)
