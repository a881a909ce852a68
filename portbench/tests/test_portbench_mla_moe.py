"""deepseek-v3-4l on the CPU at smoke size: the ``mla_moe_transformer``
reference against the port's path in float32 and its layout, its ``unsure``
rule over the group and the expert choice and the capacity, a rehearsal of
the harness with the faults of ``test_portbench_run``, its imports, the FLOP
count of ``flops_mla`` by hand, and the new metrics' readers."""
import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import flops_mla, harness, weights
from portbench.reference import ladder
from portbench.reference import mla_moe_transformer as ref
from portbench.tests import smoke
from portbench.tests.test_portbench_run import _half_batch, _state_unchanged, _token_altered

ROOT = Path(__file__).resolve().parents[2]
FULL = json.loads((ROOT / "portbench" / "configs" / "deepseek-v3-4l.json").read_text())
SEED = 2**31 + 41
CELL = "smoke-deepseek.tiny"
# the smoke size: every width cut, the router 16 wide over 4 held experts in
# 4 groups of 4 (2 kept), top-4 (levels: 4, 3, 3, 2, 2, 1), YaRN as published
SMOKE = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256,
         "mla": {"q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
                 "qk_rope_head_dim": 8, "v_head_dim": 16},
         "moe": dict(FULL["moe"], num_experts=4, top_k=4, d_ff_expert=128, num_routed=16,
                     n_group=4, topk_group=2)}
# at smoke size the program in bf16 reads gaps of a few hundredths against
# the reference; a fault reads a tenth or more. A bf16 router flips
# near-ties of some 1e-3 in score units: those tokens are not counted
LIMITS = {"max_gap": smoke.SMOKE_LIMIT, "route_margin": 0.01}


def smoke_config() -> dict:
    return dict(FULL, **SMOKE, name="smoke-deepseek")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def make_root(tmp: Path) -> Path:
    """``smoke.make_root``'s checkout with the deepseek smoke cell added by
    data files, reported by every metric that lists its cells."""
    root = smoke.make_root(tmp, cells=(("smoke-phi4", "tiny"),))
    (root / "portbench" / "configs" / "smoke-deepseek.json").write_text(
        json.dumps(smoke_config()))
    (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "smoke-deepseek", "source": "smoke", "reduced": [],
                             "file": "portbench/configs/smoke-deepseek.json", "why": "smoke"})
    bench["workloads"].append({"name": CELL, "config": "smoke-deepseek", "traffic": "tiny",
                               "chips": 1, "why": "smoke"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root, trace=False, seed=SEED):
    return harness.run(root, CELL, seed, 0, trace, device="cpu")


# ----------------------------------------------------------------------
# The reference
@pytest.mark.parametrize("level", [0, 5])
def test_reference_matches_port_in_fp32(level):
    from repro_torch.core.variants import VariantPool
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg_file = smoke_config()
    sizes = ladder.level_sizes(harness.model_sizes(cfg_file), level)
    params = weights.make(ref.layout(sizes), 99, level, "cpu", dtype=torch.float32)
    vcfg = VariantPool(harness.port_config(cfg_file))[level].config.scaled(dtype="float32")
    assert vcfg.moe.top_k == sizes["moe"]["top_k"] and vcfg.num_layers == sizes["num_layers"]
    prompts = torch.as_tensor(np.random.default_rng(level).integers(1, 256, size=(3, 14)))
    eng = Engine(vcfg, params, EngineConfig(max_len=20), device="cpu")
    logits, caches, lengths = eng.prefill(prompts)
    got, toks = [logits], []
    for _ in range(5):
        toks.append(logits.argmax(-1))
        logits, caches, lengths = eng.decode(caches, lengths, toks[-1])
        got.append(logits)
    seq = torch.cat([prompts, torch.stack(toks, 1)], 1)
    want, info = ref.logits_at(sizes, params, seq, 14, range(13, 19))
    # fp32 both: summation order only (the absorbed decode, grouped products)
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-4, atol=1e-4)
    assert info["route_margin"].shape == (3, 6) and not info["unsure"].any()


def test_layout_is_the_programs_at_every_level():
    from repro_torch.core.variants import VariantPool
    from repro_torch.models import model as model_lib
    cfg_file = smoke_config()
    pool = VariantPool(harness.port_config(cfg_file))
    for level in range(6):
        lay = ref.level_layout(harness.model_sizes(cfg_file), level)
        prog = harness._flat(model_lib.abstract_params(pool[level].config))
        assert prog == {p: s for p, (s, _) in lay.items()}, level
    full = ref.layout(harness.model_sizes(FULL))
    assert full["layers.sub0.moe.w_router"][0] == (4, 7168, 256)
    assert full["layers.sub0.moe.we_gate"][0] == (4, 8, 7168, 2048)
    assert full["layers.sub0.attn.w_uq"][0] == (4, 1536, 128, 192)
    assert full["embed.lm_head"][0] == (7168, 129280)
    n = sum(int(np.prod(s)) for s, _ in full.values())
    assert round(n / 1e9, 2) == 4.19                     # level 0, bf16: 8.4 GB


def test_reference_refuses_what_it_does_not_compute():
    sizes = harness.model_sizes(smoke_config())
    ref.check_supported(sizes)
    for bad in ({"num_dense_layers": 3}, {"tie_embeddings": True},
                {"moe": dict(sizes["moe"], scoring="softmax")}):
        with pytest.raises(ValueError):
            ref.check_supported({**sizes, **bad})


# ----------------------------------------------------------------------
# The unsure rule
MOE = {"num_experts": 2, "top_k": 2, "d_ff_expert": 4, "num_shared_experts": 1,
       "router_scale": 2.5, "n_group": 4, "topk_group": 2, "num_routed": 8}


def _weights(logit_rows, bias=None):
    """A router that reads the first ``len(logit_rows[0])`` dims of h: token
    t's logits are ``h[t] @ I``."""
    d = 8
    w = {"w_router": torch.eye(d), "router_bias": torch.zeros(8) if bias is None else bias,
         "we_gate": torch.randn(2, d, 4), "we_up": torch.randn(2, d, 4),
         "we_down": torch.randn(2, 4, d), "ws_gate": torch.randn(d, 4),
         "ws_up": torch.randn(d, 4), "ws_down": torch.randn(4, d)}
    h = torch.tensor(logit_rows, dtype=torch.float32)[None]
    return h, w


def _unsure(rows, near, bias=None):
    h, w = _weights(rows, bias)
    _, dropped, margin, unsure = ref.moe(h, w, MOE, [slice(0, h.shape[1])],
                                         ref._Mat(None), near=near)
    return margin[0], unsure[0]


def test_an_expert_near_tie_is_unsure_only_where_it_touches_the_held_experts():
    # groups (0,1) (2,3) (4,5) (6,7); experts 0 and 1 held
    held_k = [3.0, 1.0, 1.0001, -3, -3, -3, -3, -3]      # held 0 chosen; 2 vs held 1
    far = [-3.0, -3, 3.0, 1.0, 1.0001, -3, -2, -3]       # group 0 out; 4 vs 3
    margin, unsure = _unsure([held_k, far], near=0.01)
    assert margin[0] < 0.001 and margin[1] > 0.5     # far: held group 0.68 below the cut
    assert unsure.tolist() == [True, False]
    assert not _unsure([held_k, far], near=0.0)[1].any()


def test_a_held_expert_two_places_below_the_cut_is_unsure():
    """Three groups kept: experts 2 and 3 are chosen, 4 (absent) is next and
    held expert 0 after it, all within 1e-4: a rounding that lifts expert 0
    over both takes it in, so the token is unsure although neither the k-th
    choice nor the next is held."""
    h, w = _weights([[1.0, -3, 3.0, 1.0002, 1.0001, -3, -3, -3]])
    moe3 = dict(MOE, topk_group=3)
    _, _, margin, unsure = ref.moe(h, w, moe3, [slice(0, 1)], ref._Mat(None), near=0.01)
    gates, idx, m = ref.route(h[0], w, moe3, ref._Mat(None))
    assert idx.tolist() == [[2, 3]] and m[0] == margin[0, 0] < 1e-4
    assert unsure.tolist() == [[True]]


def test_a_group_near_tie_next_to_the_held_group_is_unsure():
    # group 0 (held) and group 2 tie for the second kept group
    rows = [[1.0, 0.5, 3.0, 2.0, 1.0, 0.5001, -3, -3],
            [-3.0, -3, 3.0, 2.0, 1.0, 0.5, 1.0, 0.5001]]   # tie of groups 2 and 3
    margin, unsure = _unsure(rows, near=0.01)
    assert margin[0] < 0.001 and unsure.tolist() == [True, False]


def test_a_near_tie_before_a_held_experts_capacity_makes_its_boundary_unsure():
    # every token takes held experts 0 and 1 (capacity 8 of 12 in one call at
    # width 8); token 0's choice of expert 1 nearly goes to expert 2 instead
    rows = [[5.0, 4.0, 3.0, -3, -3, -3, -3, -3]] * 12
    rows[0] = [5.0, 3.0001, 3.0, -3, -3, -3, -3, -3]
    h, w = _weights(rows)
    assert ref.capacity(12, 8, 2) == 8
    _, dropped, margin, unsure = ref.moe(h, w, MOE, [slice(0, 12)], ref._Mat(None), near=0.01)
    assert dropped == 2 * (12 - 8) and margin[0, 0] < 0.001
    # token 0 flips; expert 1's queue moves by one at places 7 and 8
    assert unsure[0].nonzero()[:, 0].tolist() == [0, 7, 8]


# ----------------------------------------------------------------------
# A rehearsal of the harness
def test_result_line_and_readers(root, monkeypatch):
    seen = []
    real = harness.reader
    monkeypatch.setattr(harness, "reader", lambda r, k, n: (lambda run: (
        seen.append(run), real(r, k, n)(run))[1]))
    line = _run(root, trace=True)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    # a CPU rehearsal reads no counter of the program and no device time
    assert not {"expert_load_prefill", "moe_drop_share", "mla_serve_mfu"} & set(line["metrics"])
    run = SimpleNamespace(**dict(vars(seen[-1]), device="cuda"))
    load = harness.reader(root, "metrics", "expert_load_prefill")(run)
    drop = harness.reader(root, "metrics", "moe_drop_share")(run)
    syncs = harness.reader(root, "metrics", "host_syncs_per_batch")(run)
    held = sum(b["moe_pairs"]["prefill"]["held"] for b in run.batches)
    routed = sum(b["moe_pairs"]["prefill"]["routed"] for b in run.batches)
    assert 0 < held < routed
    layers = [run.levels[b["level"]]["num_layers"] for b in run.batches]
    assert load == pytest.approx(held / (4 * sum(layers)))
    assert 0 <= drop < 100
    steps = [b["out"] for b in run.batches]
    assert syncs == pytest.approx(np.mean([3 + n * (1 + s) for n, s in zip(layers, steps)]))
    assert all(b["graph_steps"] == 0 for b in run.batches)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
def test_a_broken_timed_path_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(root)
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_control_reads_above_the_limit_and_the_program_below(root):
    from portbench import control
    rows = [control.readings(root, CELL, s, "cpu") for s in (1, 2)]
    assert all(r["program"]["correct"] for r in rows), rows
    assert not any(r["control"]["correct"] for r in rows), rows


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json, torch\n"
            "from portbench.reference import mla_moe_transformer as ref\n"
            "from portbench import weights\n"
            "from portbench.tests.test_portbench_mla_moe import smoke_config\n"
            "cfg = smoke_config()\n"
            "sizes = {k: cfg[k] for k in ('d_model', 'num_layers', 'num_heads', 'vocab_size', "
            "'mla', 'moe', 'norm_eps', 'rope_theta', 'rope_scaling')}\n"
            "p = weights.make(ref.layout(sizes), 1, 0, 'cpu', dtype=torch.float32)\n"
            "ref.logits_at(sizes, p, torch.ones(1, 5, dtype=torch.long), 3, [2, 3, 4])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" not in mods and not mods & set(harness.FORBIDDEN)


# ----------------------------------------------------------------------
# flops_mla by hand
def test_one_layer_by_hand():
    s = {"d_model": 10, "num_heads": 2, "num_layers": 1, "vocab_size": 7,
         "mla": {"q_lora_rank": 3, "kv_lora_rank": 4, "qk_nope_head_dim": 5,
                 "qk_rope_head_dim": 2, "v_head_dim": 6},
         "moe": {"num_experts": 2, "num_routed": 8, "top_k": 4, "d_ff_expert": 3,
                 "num_shared_experts": 1}}
    # prefill a token: w_dq 10x3, w_uq 3x(2x7), w_dkv 10x(4+2), w_uk 4x(2x5),
    # w_uv 4x(2x6), wo (2x6)x10: 2 x (30 + 42 + 60 + 40 + 48 + 120)
    assert flops_mla.attn_prefill_per_token(s) == 680
    # a causal pair: q.k over 7 dims and p.v over 6, 2 heads: 2 x 2 x (7 + 6)
    assert flops_mla.attn_prefill_per_pair(s) == 52
    # decode a token: w_dq, w_uq, w_dkv as above, absorb 2x5x4, w_uv 2x4x6, wo
    assert flops_mla.attn_decode_per_token(s) == 2 * (30 + 42 + 60 + 40 + 48 + 120)
    # a cached slot: scores over the latent 4 and rope 2, values over the latent 4
    assert flops_mla.attn_decode_per_slot(s) == 2 * 2 * (4 + 2) + 2 * 2 * 4 == 40
    # router 10x8, shared expert 3 x 10x3, routed 4 x 2/8 of an expert
    expert = 3 * 2 * 10 * 3
    assert flops_mla.moe_flops_per_token(s) == 2 * 10 * 8 + expert + 4 * 2 / 8 * expert
    moe = 160 + 180 + 180
    # a prompt of 3, then 2 steps (the second served token comes from the first step)
    want = 2 * (3 * (680 + moe) + 6 * 52 + 140) + 2 * ((680 + moe + 4 * 40) + 140)
    assert flops_mla.batch_flops(s, 2, 3, 2) == want


def test_readers_of_a_program_without_the_counters_report_nothing(root, monkeypatch):
    seen = []
    real = harness.reader
    monkeypatch.setattr(harness, "reader", lambda r, k, n: (lambda run: (
        seen.append(run), real(r, k, n)(run))[1]))
    _run(root, trace=True)
    old = [{k: v for k, v in b.items() if k != "moe_pairs"} for b in seen[-1].batches]
    run = SimpleNamespace(**dict(vars(seen[-1]), batches=old, device="cuda"))
    for name in ("expert_load_prefill", "moe_drop_share"):
        assert harness.reader(root, "metrics", name)(run) is None
