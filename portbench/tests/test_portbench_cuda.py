"""On the card only (marker ``cuda``; each test skips without one): the
control and a traced run at phi4-mini's and mixtral's widths cut to 2 layers,
a size a test run holds. Run on the chip with

    python -m pytest -q -m cuda portbench/tests/test_portbench_cuda.py
"""
import json

import pytest
import torch

from portbench import control, harness
from portbench.tests import smoke

SMALL_MIX = dict(smoke.TINY_MIX, name="small", max_batch=8, requests_per_pass=3,
                 items={"low": 8, "high": 24},
                 prompt_tokens={"values": [256, 512], "weights": [0.5, 0.5]},
                 output_tokens={"low": 4, "high": 8})
SMALL_LIMIT = 0.1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only there")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = smoke.make_root(tmp_path_factory.mktemp("bench"), cells=())
    (root / "portbench" / "traffic" / "small.json").write_text(json.dumps(SMALL_MIX))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, full, cell in (("phi4-2l", "phi4-mini-3.8b.json", "phi4-mini.gen"),
                             ("mixtral-2l", "mixtral-8x7b-4l.json", "mixtral-8x7b-4l.gen")):
        cfg = json.loads((smoke.ROOT / "portbench" / "configs" / full).read_text())
        cfg.update(name=name, num_layers=2)
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": ["num_layers"],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
        bench["workloads"].append({"name": f"{name}.small", "config": name,
                                   "traffic": "small", "chips": 1, "why": "test"})
        limits = json.loads((smoke.ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
        # two layers read smaller gaps than the cell's four or 32: a limit of this size's own,
        # between the program's largest and the control's smallest reading on the H100
        # (phi4-2l 0.050 and 0.379, mixtral-2l 0.033 and 0.173, seeds 2**31 + 1..3)
        limits["max_gap"] = SMALL_LIMIT
        (root / "portbench" / "limits" / f"{name}.small.json").write_text(json.dumps(limits))
    for m in bench["per_layer"]:
        m["workloads"] = [w["name"] for w in bench["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phi4-2l.small", "mixtral-2l.small"])
def test_control_separates_from_the_program(card, root, cell):
    rows = [control.readings(root, cell, 2**31 + s) for s in (1, 2, 3)]
    print(json.dumps(rows))
    assert all(r["program"]["correct"] for r in rows), rows
    assert not any(r["control"]["correct"] for r in rows), rows
    lower = max(r["program"]["max_gap"] for r in rows)
    upper = min(r["control"]["max_gap"] for r in rows)
    assert upper >= 3 * lower, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phi4-2l.small", "mixtral-2l.small"])
def test_traced_run_on_the_card(card, root, cell):
    r = harness.run(root, cell, 2**31 + 9, 1.0, True)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    for name in ("k1_roofline", "k2_roofline", "serve_mfu", "idle_share"):
        assert 0 < r["metrics"][name]["value"] <= 105, (name, r["metrics"][name])
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
