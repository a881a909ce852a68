"""A frozen copy of the accuracy ladder's rule: the widths of each level.

Six levels, alpha 1.0 down to 0.35. A dense model's MLP width is scaled by
alpha and rounded to a multiple of 128 (at least 128). A mixture of experts
keeps its expert count and scales its experts per token by alpha (at least
1) and its expert width by max(alpha, 0.5). Levels with alpha <= 0.45 also
keep round(0.75 x layers) layers. The benchmark works the widths out here
on its own, so that a change to the program's ladder shows as a mismatch.
"""
from __future__ import annotations

import copy

ALPHAS = (1.0, 0.85, 0.7, 0.55, 0.45, 0.35)


def round_ff(x: float) -> int:
    return max(128, int(round(x / 128)) * 128)


def level_sizes(sizes: dict, level: int) -> dict:
    """``sizes`` (a configuration file's model keys) at accuracy level ``level``."""
    alpha = ALPHAS[level]
    out = copy.deepcopy(sizes)
    if alpha >= 0.999:
        return out
    if out.get("moe"):
        moe = out["moe"]
        moe["top_k"] = max(1, int(round(moe["top_k"] * alpha)))
        moe["d_ff_expert"] = round_ff(moe["d_ff_expert"] * max(alpha, 0.5))
    else:
        out["d_ff"] = round_ff(out["d_ff"] * alpha)
    if alpha <= 0.45:
        out["num_layers"] = max(1, int(round(out["num_layers"] * 0.75)))
    return out
