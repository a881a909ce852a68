"""The benchmark's weights: made on the device from the seed, in the type
they are served in, one flat buffer a level filled by a few large calls."""
from __future__ import annotations

import torch

from portbench import seeds

CHUNK = 1 << 28          # elements a call to ``normal_`` fills


def make(layout: dict, seed: int, level: int, device, dtype=torch.bfloat16) -> dict:
    """A nested dict of tensors in ``layout`` (path -> (shape, std | None)):
    standard normals times std, and ones for a norm's scale (std None)."""
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights", level))
    sizes = {p: _numel(s) for p, (s, std) in layout.items() if std is not None}
    flat = torch.empty(sum(sizes.values()), dtype=dtype, device=device)
    for i in range(0, flat.numel(), CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, (shape, std) in layout.items():
        if std is None:
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = flat[off:off + sizes[path]].view(shape).mul_(std)
            off += sizes[path]
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
