"""A checkout of the benchmark at smoke size, for CPU tests and rehearsals:
the real ``portbench/`` files beside configuration, traffic and limit files
of the port's smoke sizes, and a BENCHMARK.json that names them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMOKE_SIZES = {
    "smoke-phi4": {"port_arch": "phi4-mini-3.8b", "num_layers": 2, "d_model": 64,
                   "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                   "vocab_size": 256},
    "smoke-mixtral": {"port_arch": "mixtral-8x7b", "num_layers": 2, "d_model": 64,
                      "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                      "vocab_size": 256, "attention_kind": "sliding", "sliding_window": 16,
                      "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 128,
                              "num_shared_experts": 0, "first_moe_layer": 0,
                              "moe_every": 1, "router_scale": 1.0}},
}
FULL = {"smoke-phi4": "phi4-mini-3.8b.json", "smoke-mixtral": "mixtral-8x7b-4l.json"}

TINY_MIX = {"name": "tiny", "policy": "proportional", "max_batch": 4, "requests_per_pass": 4,
            "deck_seed": 0, "items": {"low": 2, "high": 12},
            "prompt_tokens": {"values": [8, 16], "weights": [0.5, 0.5]},
            "output_tokens": {"low": 6, "high": 10},
            "acc_req": {"low": 86.0, "high": 90.5},
            "perf_req": {"low_of_full_capacity": 0.9, "high_of_max_capacity": 0.95}}

# the reference against the program in bf16 at smoke size reads gaps of a few
# hundredths; a fault reads a tenth or more
SMOKE_LIMIT = 0.05


def smoke_config(name: str) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / FULL[name]).read_text())
    cfg.update(SMOKE_SIZES[name], name=name)
    return cfg


def make_root(tmp: Path, cells=(("smoke-phi4", "tiny"), ("smoke-mixtral", "tiny"))) -> Path:
    """A checkout under ``tmp`` with one cell per (config, traffic) pair,
    named ``<config>.<traffic>``."""
    tmp = Path(tmp)
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    (tmp / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    for cfg_name in sorted({c for c, _ in cells}):
        path = tmp / "portbench" / "configs" / f"{cfg_name}.json"
        path.write_text(json.dumps(smoke_config(cfg_name)))
        bench["configs"].append({"name": cfg_name, "source": "smoke", "reduced": [],
                                 "file": f"portbench/configs/{cfg_name}.json", "why": "smoke"})
    names = []
    for cfg_name, mix in cells:
        name = f"{cfg_name}.{mix}"
        names.append(name)
        bench["workloads"].append({"name": name, "config": cfg_name, "traffic": mix,
                                   "chips": 1, "why": "smoke"})
        (tmp / "portbench" / "limits" / f"{name}.json").write_text(
            json.dumps({"max_gap": SMOKE_LIMIT}))
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = names
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
