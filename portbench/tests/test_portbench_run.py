"""A whole run of the harness on the CPU at smoke size: the result's line,
a cell added by data files alone, and ``correct`` false when the timed path
is broken underneath (the chip's look is skipped with ``device="cpu"``)."""
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import smoke

SEED = 2**31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seed=SEED):
    # seconds=0: the window is one pass over the deck, the same batches every time
    return harness.run(root, cell, seed, 0, trace, device="cpu")


@pytest.mark.parametrize("cell", ["smoke-phi4.tiny", "smoke-mixtral.tiny"])
def test_result_line(root, cell):
    r = _run(root, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"items_per_s", "batch_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["metrics"]["items_per_s"]["unit"] == "items/s"
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"max_gap", "conservation_errors", "nonfinite_batches"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_run_reports_host_metrics_without_a_card(root):
    r = _run(root, "smoke-phi4.tiny", trace=True)
    # no device trace on the CPU: the readers of the span find nothing
    assert set(r["metrics"]) == {"gateway_ms", "prefill_ms_per_ktok", "decode_ms_per_step",
                                 "batch_p95_ms.gen"}
    assert "breakdown" not in r and "busy_s" not in r["device"]


def test_a_cell_added_by_data_files_alone(tmp_path):
    root = smoke.make_root(tmp_path)
    mix = dict(smoke.TINY_MIX, name="dummy", requests_per_pass=3,
               prompt_tokens={"values": [12], "weights": [1.0]},
               output_tokens={"low": 3, "high": 3})
    (root / "portbench" / "traffic" / "dummy.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / "smoke-phi4.dummy.json").write_text(
        json.dumps({"max_gap": smoke.SMOKE_LIMIT}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "smoke-phi4.dummy", "config": "smoke-phi4",
                               "traffic": "dummy", "chips": 1, "why": "dummy"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(root, "smoke-phi4.dummy")
    assert r["correct"] is True
    cell = harness.load_cell(root, "smoke-phi4.dummy")
    assert cell.mix["name"] == "dummy"
    # a metric that lists its cells leaves out a cell it does not name
    assert {m["name"] for m in cell.end_to_end} == {"items_per_s", "setup_s"}
    assert set(r["metrics"]) == {"items_per_s", "setup_s"}


# ----------------------------------------------------------------------
# Faults of the timed path. A serving cell can have three of the four:
# a step that leaves its state unchanged, half of a batch left out, and a
# token altered where it is produced. The exchange between chips does not
# exist on one card.
def _state_unchanged(monkeypatch):
    from repro_torch.models import model as model_lib
    real = model_lib.decode_step

    def step(cfg, params, caches, lengths, tokens, **kw):
        copy = {g: {s: type(c)(*(t.clone() for t in c)) for s, c in u.items()}
                for g, u in caches.items()}
        logits, _, _ = real(cfg, params, copy, lengths, tokens, **kw)
        return logits, caches, lengths
    monkeypatch.setattr(model_lib, "decode_step", step)


def _half_batch(monkeypatch):
    from repro_torch.serving.engine import Engine
    real = Engine.generate

    def generate(self, tokens, num_steps, **kw):
        n = len(tokens)
        out = real(self, tokens[:max(1, n // 2)], num_steps, **kw)
        return np.resize(out, (n, out.shape[1]))
    monkeypatch.setattr(Engine, "generate", generate)


def _token_altered(monkeypatch):
    from repro_torch.serving.engine import Engine
    real = Engine.generate

    def generate(self, tokens, num_steps, **kw):
        out = real(self, tokens, num_steps, **kw)
        out[-1, -1] = (out[-1, -1] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(Engine, "generate", generate)


@pytest.mark.parametrize("cell", ["smoke-phi4.tiny", "smoke-mixtral.tiny"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(root, cell)
    assert r["correct"] is False
    assert r["failed"] > 0
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_control_reads_above_the_limit_and_the_program_below(root):
    """The control goes through the run's own check: the program is correct
    and the reference in float8 in its place is not."""
    from portbench import control
    rows = [control.readings(root, "smoke-phi4.tiny", s, "cpu") for s in (1, 2, 3)]
    assert all(r["program"]["correct"] for r in rows), rows
    assert not any(r["control"]["correct"] for r in rows), rows
    assert all(r["control"]["failed"] > 0 for r in rows), rows
    assert max(r["program"]["max_gap"] for r in rows) < smoke.SMOKE_LIMIT
    assert min(r["control"]["max_gap"] for r in rows) > 3 * smoke.SMOKE_LIMIT


def _batches(levels_n_out):
    return [{"level": lv, "n": n, "plen": 8, "out": out} for lv, n, out in levels_n_out]


def test_sample_takes_a_batch_of_every_level_and_the_longest():
    bs = _batches([(0, 2, 3), (1, 4, 3), (0, 4, 3), (2, 1, 3)])
    bs.append({"level": 1, "n": 1, "plen": 16, "out": 3})
    for seed in (1, 2**31 + 5, 2**40 + 3):
        picked = harness.sample(bs, seed)
        assert 4 in picked
        assert {bs[i]["level"] for i in picked} == {0, 1, 2}
        assert picked == harness.sample(bs, seed)


@pytest.mark.parametrize("min_tokens", [0, 20, 40, 10**6])
def test_sample_grows_to_the_served_tokens_asked_for(min_tokens):
    bs = _batches([(lv % 3, 4, 2) for lv in range(12)])     # 8 served tokens a batch
    base = harness.sample(bs, SEED)
    picked = harness.sample(bs, SEED, min_tokens)
    assert set(base) <= set(picked)
    served = sum(bs[i]["n"] * bs[i]["out"] for i in picked)
    assert served >= min(min_tokens, 8 * len(bs))
    assert served - 8 < max(min_tokens, 8 * len(base))


def test_no_card_no_result(root, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.run(root, "smoke-phi4.tiny", SEED, 0.1, False) is None
    assert "needs 1 CUDA device" in capsys.readouterr().err
