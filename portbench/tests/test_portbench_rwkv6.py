"""rwkv6-1.6b on the CPU at smoke size: the ``rwkv6_finch`` reference against
the port's path in float32 and its layout at every level, its chunked
recurrence against the loop, a rehearsal of the harness with the faults of
``test_portbench_run``, the control, its imports, the FLOP and byte count of
``flops_rwkv`` by hand, and the new metrics' readers."""
import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import flops_rwkv, harness, weights
from portbench.reference import ladder
from portbench.reference import rwkv6_finch as ref
from portbench.tests import smoke
from portbench.tests.test_portbench_run import _half_batch, _state_unchanged, _token_altered

ROOT = Path(__file__).resolve().parents[2]
FULL = json.loads((ROOT / "portbench" / "configs" / "rwkv6-1.6b.json").read_text())
SEED = 2**31 + 43
CELL = "smoke-rwkv6.tiny"
# the smoke size: every width cut, the token-shift LoRA at rank 8, the
# GroupNorm's eps and the LayerNorm blocks as published
SMOKE = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256,
         "ssm": dict(FULL["ssm"], wkv_head_dim=16, token_shift_lora=8)}


# at smoke size the program in bf16 reads gaps up to 0.035 against the
# reference (seeds 1-6); the fp8 control 0.108 or more, a fault 2.3 or more
LIMITS = {"max_gap": 0.07, "sample_tokens": 200}


def smoke_config() -> dict:
    return dict(FULL, **SMOKE, name="smoke-rwkv6")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def make_root(tmp: Path) -> Path:
    """``smoke.make_root``'s checkout with the rwkv6 smoke cell added by data
    files, reported by every metric that lists its cells."""
    root = smoke.make_root(tmp, cells=(("smoke-phi4", "tiny"),))
    (root / "portbench" / "configs" / "smoke-rwkv6.json").write_text(
        json.dumps(smoke_config()))
    (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "smoke-rwkv6", "source": "smoke", "reduced": [],
                             "file": "portbench/configs/smoke-rwkv6.json", "why": "smoke"})
    bench["workloads"].append({"name": CELL, "config": "smoke-rwkv6", "traffic": "tiny",
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
    """The engine's prefill (K4's plain version) and its decode steps through
    the carried state against the reference's full sequence."""
    from repro_torch.core.variants import VariantPool
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg_file = smoke_config()
    sizes = ladder.level_sizes(harness.model_sizes(cfg_file), level)
    params = weights.make(ref.layout(sizes), 99, level, "cpu", dtype=torch.float32)
    vcfg = VariantPool(harness.port_config(cfg_file))[level].config.scaled(dtype="float32")
    assert vcfg.d_ff == sizes["d_ff"] and vcfg.num_layers == sizes["num_layers"]
    prompts = torch.as_tensor(np.random.default_rng(level).integers(1, 256, size=(3, 40)))
    eng = Engine(vcfg, params, EngineConfig(max_len=46), device="cpu")
    logits, caches, lengths = eng.prefill(prompts)
    got, toks = [logits], []
    for _ in range(5):
        toks.append(logits.argmax(-1))
        logits, caches, lengths = eng.decode(caches, lengths, toks[-1])
        got.append(logits)
    seq = torch.cat([prompts, torch.stack(toks, 1)], 1)
    want, info = ref.logits_at(sizes, params, seq, 40, range(39, 45))
    # fp32 both, through a recurrence: summation order only, the repository's 5e-5 x 4
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=2e-4, atol=2e-4)
    assert info["dropped"] == 0 and info["unsure"].shape == (3, 6)
    assert not info["unsure"].any()


@pytest.mark.parametrize("t,chunk", [(1, 32), (37, 8), (100, 32), (64, 32)])
def test_chunked_recurrence_equals_the_loop(t, chunk):
    gen = torch.Generator().manual_seed(t)
    b, h, dk, dv = 2, 3, 8, 5
    r, k = (torch.randn(b, t, h, dk, generator=gen) for _ in range(2))
    v = torch.randn(b, t, h, dv, generator=gen)
    log_w = -torch.exp(0.6 * torch.randn(b, t, h, dk, generator=gen))
    u = 0.5 * torch.randn(h, dk, generator=gen)
    want = ref.wkv_loop(*(x.double() for x in (r, k, v, log_w, u)))
    got = ref.wkv_chunked(r, k, v, log_w, u, chunk=chunk)
    # float32 against float64: as close as the float32 loop itself
    loop = ref.wkv_loop(r, k, v, log_w, u)
    assert (got.double() - want).abs().max() <= 2 * (loop.double() - want).abs().max() + 1e-6
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_layout_is_the_programs_at_every_level():
    from repro_torch.core.variants import VariantPool
    from repro_torch.models import model as model_lib
    for cfg_file in (smoke_config(), FULL):
        pool = VariantPool(harness.port_config(cfg_file))
        for level in range(6):
            lay = ref.level_layout(harness.model_sizes(cfg_file), level)
            prog = harness._flat(model_lib.abstract_params(pool[level].config))
            assert prog == {p: s for p, (s, _) in lay.items()}, level
    full = ref.layout(harness.model_sizes(FULL))
    assert full["layers.sub0.rwkv.maa_w1"][0] == (24, 2048, 160)
    assert full["layers.sub0.rwkv.maa_w2"][0] == (24, 5, 32, 2048)
    assert full["layers.sub0.rwkv.cm_k"][0] == (24, 2048, 7168)
    assert full["embed.lm_head"][0] == (2048, 65536)
    sizes = [sum(int(np.prod(s)) for s, _ in ref.level_layout(harness.model_sizes(FULL),
                                                                lv).values())
             for lv in range(6)]
    assert [round(n / 1e9, 2) for n in sizes] == [1.60, 1.50, 1.39, 1.29, 0.97, 0.93]
    assert round(2 * sum(sizes) / 1e9, 1) == 15.3            # bf16, six levels


def test_reference_refuses_what_it_does_not_compute():
    sizes = harness.model_sizes(smoke_config())
    ref.check_supported(sizes)
    for bad in ({"norm_kind": "rms"}, {"embed_norm": False}, {"tie_embeddings": True},
                {"ssm": dict(sizes["ssm"], token_shift_lora=0)},
                {"ssm": dict(sizes["ssm"], head_norm_eps=0.0)}, {"attention_kind": "full"}):
        with pytest.raises(ValueError):
            ref.check_supported({**sizes, **bad})
    with pytest.raises(ValueError):
        ref.check_supported({k: v for k, v in sizes.items() if k != "norm_kind"})


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
    assert not {"wkv_kernel_share", "k4_roofline", "rwkv_serve_mfu"} & set(line["metrics"])
    run = SimpleNamespace(**dict(vars(seen[-1]), device="cuda"))
    share = harness.reader(root, "metrics", "wkv_kernel_share")(run)
    syncs = harness.reader(root, "metrics", "host_syncs_per_batch")(run)
    graph = harness.reader(root, "metrics", "decode_graph_share")(run)
    layers = [run.levels[b["level"]]["num_layers"] for b in run.batches]
    prefill = sum(b["n"] * b["plen"] * n for b, n in zip(run.batches, layers))
    steps = sum(b["n"] * b["out"] * n for b, n in zip(run.batches, layers))
    assert [b["wkv_tokens"]["kernel"] for b in run.batches] == [
        b["n"] * b["plen"] * n for b, n in zip(run.batches, layers)]
    assert share == pytest.approx(100.0 * prefill / (prefill + steps))
    assert syncs == 3.0 and graph == 0.0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
def test_a_broken_timed_path_is_not_correct(root, fault, monkeypatch):
    """``_state_unchanged``: each decode step runs on a copy of the state and
    leaves the step's own state as the prefill left it."""
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
    code = ("import sys, torch\n"
            "from portbench.reference import rwkv6_finch as ref\n"
            "from portbench import weights\n"
            "from portbench.tests.test_portbench_rwkv6 import smoke_config\n"
            "cfg = smoke_config()\n"
            "sizes = {k: cfg[k] for k in ('d_model', 'num_layers', 'd_ff', 'vocab_size', "
            "'ssm', 'norm_eps')}\n"
            "p = weights.make(ref.layout(sizes), 1, 0, 'cpu', dtype=torch.float32)\n"
            "ref.logits_at(sizes, p, torch.ones(1, 5, dtype=torch.long), 3, [2, 3, 4])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" not in mods and not mods & set(harness.FORBIDDEN)


# ----------------------------------------------------------------------
# flops_rwkv by hand
S = {"d_model": 8, "num_layers": 2, "d_ff": 12, "vocab_size": 7,
     "ssm": {"kind": "rwkv6", "wkv_head_dim": 4, "token_shift_lora": 3}}


def test_one_block_by_hand():
    # maa_w1 8x15, maa_w2 5 x 3x8, r/k/v/g/o 5 x 8x8, decay 8x64 and 64x8;
    # 2 heads of 4x4 at 5 a state element; channel mix 8x12, 12x8, 8x8
    want = (2 * (120 + 120 + 320 + 1024) + 5 * 2 * 16 + 2 * (96 + 96 + 64))
    assert flops_rwkv.layer_flops_per_token(S) == want
    per_token, head = 2 * want, 2 * 8 * 7
    # a prompt of 3, then 2 steps (the second served token comes from the first step)
    assert flops_rwkv.batch_flops(S, 2, 3, 2) == 2 * (3 * per_token + head) + 2 * (
        per_token + head)


def test_k4_call_by_hand():
    # 2 sequences of 3 tokens, 4 heads of 5 x 6: r, k (5) and v (6) in bf16,
    # w (5) and y (6) in fp32, the final state 4 x 5 x 6 a sequence in fp32
    flops, nbytes = flops_rwkv.k4_call(2, 3, 4, 5, 6)
    assert flops == 5 * 2 * 3 * 4 * 5 * 6
    assert nbytes == 2 * 24 * (5 + 5 + 6) + 4 * 24 * (5 + 6) + 4 * 2 * 4 * 30
    # the serving shape of PERF.md's K4 row: r/k/v (8, 512, 32, 64)
    flops, nbytes = flops_rwkv.k4_call(8, 512, 32, 64, 64)
    assert round(flops / 1e9, 2) == 2.68 and round(nbytes / 1e6, 1) == 121.6
    peak = {"hbm_bytes_per_s": 3.35e12}
    assert flops_rwkv.k4_bound_s(flops, nbytes, peak) == pytest.approx(4.007e-5, rel=1e-3)


def _span_run(times, kernel="void wkv_kernel<2, 4, 64>(WkvArgs)"):
    sizes = dict(S, ssm=dict(S["ssm"]))
    batches = [{"in_span": True, "level": 0, "n": 2, "plen": 3},
               {"in_span": False, "level": 0, "n": 1, "plen": 9}]
    return SimpleNamespace(sizes=sizes, levels=[sizes], batches=batches,
                           peak={"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12},
                           span={"kernels": [(kernel, t) for t in times]})


def test_k4_roofline_reads_the_span_by_the_kernels_name(root):
    read = harness.reader(root, "metrics", "k4_roofline")
    flops, nbytes = flops_rwkv.k4_call(2, 3, 2, 4, 4)
    bound = flops_rwkv.k4_bound_s(flops, nbytes, {"hbm_bytes_per_s": 3.35e12})
    # one call a layer of the span's batch, each at twice its bound
    assert read(_span_run([2 * bound] * 2)) == pytest.approx(50.0)
    assert read(_span_run([2 * bound] * 2, kernel="decode_mma_kernel")) is None
    assert read(SimpleNamespace(**dict(vars(_span_run([bound])), sizes={"d_model": 8}))) is None


def test_readers_of_a_program_without_the_counters_report_nothing(root, monkeypatch):
    seen = []
    real = harness.reader
    monkeypatch.setattr(harness, "reader", lambda r, k, n: (lambda run: (
        seen.append(run), real(r, k, n)(run))[1]))
    _run(root, trace=True)
    old = [{k: v for k, v in b.items() if k != "wkv_tokens"} for b in seen[-1].batches]
    run = SimpleNamespace(**dict(vars(seen[-1]), batches=old, device="cuda"))
    assert harness.reader(root, "metrics", "wkv_kernel_share")(run) is None
    assert harness.reader(root, "metrics", "k4_roofline")(run) is None
    gqa = SimpleNamespace(**dict(vars(run), sizes={"d_model": 8}, span={"kernels": []},
                                 peak={"bf16_flops": 1.0}))
    assert harness.reader(root, "metrics", "rwkv_serve_mfu")(gqa) is None
