"""The port's examples on the CPU: ``quickstart_torch`` plans exactly as the
JAX quickstart under the JAX package's peaks (the same assignments, achieved
perf and accuracy for every policy, and the same printed lines);
``serve_cluster_torch`` and ``train_small_torch`` run end to end at smoke
size, the latter resuming from its checkpoint halfway."""
import importlib.util
import os

import pytest

from _torch_host_util import REF_HW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_plans():
    """The JAX quickstart's steps 2-4, by its own modules."""
    from repro.configs import get_config
    from repro.core.cluster import DEFAULT_NODES, SimBackend
    from repro.core.profiling import NodeProfile, ProfilingTable
    from repro.core.requests import InferenceRequest
    from repro.core.variants import VariantPool
    from repro.sched import ClusterState, get_policy, registered_policies
    pool = VariantPool(get_config("phi4-mini-3.8b"))
    table = ProfilingTable(pool, [NodeProfile(n.name, n.chips, n.capability)
                                  for n in DEFAULT_NODES], seq_len=512)
    req = InferenceRequest(rid=0, num_items=650, perf_req=table.perf[0].sum() * 1.12,
                           acc_req=89.0)
    backend, state = SimBackend(table), ClusterState.from_table(table)
    out = []
    for name in registered_policies():
        d = get_policy(name).plan(state, req).dispatch
        out.append((name, d, backend.execute(d)))
    return out


def test_quickstart_plans_equal_the_jax_quickstart():
    lines = []
    got = example("quickstart_torch").plans(hw=REF_HW, out=lines.append)
    want = _jax_plans()
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (name, r, d), (_, jd, jr) in zip(got, want):
        assert [(a.node, a.apx_level, a.items) for a in d.assignments] == \
            [(a.node, a.apx_level, a.items) for a in jd.assignments], name
        assert r.achieved_perf == pytest.approx(jr.achieved_perf, rel=1e-12), name
        assert r.achieved_acc == pytest.approx(jr.achieved_acc, rel=1e-12), name
        assert (r.meets_perf, r.meets_acc) == (jr.meets_perf, jr.meets_acc), name
    assert any(n == "proportional" and r.meets_perf and r.meets_acc for n, r, _ in got)


def test_quickstart_prints_what_the_jax_quickstart_prints(capsys):
    example("quickstart").main()
    want = capsys.readouterr().out
    lines = []
    example("quickstart_torch").plans(hw=REF_HW, out=lines.append)
    assert "\n".join(lines) + "\n" == want


def test_serve_cluster_runs_on_the_cpu(capsys):
    out = example("serve_cluster_torch").main(
        ["--device", "cpu", "--smoke", "--requests", "4", "--decode-steps", "2"])
    text = capsys.readouterr().out
    assert "slice-d disconnected" in text and "summary:" in text
    runs = out["runs"]
    assert runs and {r["rid"] for r in runs} == {0, 1, 2, 3}
    assert all(r["tokens"].shape == (min(r["items"], 4), 2) and r["finite"] for r in runs)
    assert not any(r["node"] == "slice-d" for r in runs if r["rid"] == 3)
    assert out["gateway"].summary()["perf_violation_rate"] >= 0.0


def test_train_small_resumes_from_its_checkpoint(tmp_path, capsys):
    """Phase 1 trains 2 steps and checkpoints; phase 2 restores step 2 and
    trains steps 2-3, with the losses a run without the restart has."""
    mod = example("train_small_torch")
    first, second = mod.main(["--device", "cpu", "--smoke", "--steps", "4",
                              "--ckpt-dir", str(tmp_path / "a")])
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert len(first) == 2 and len(second) == 2
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import run_training
    straight = run_training(get_smoke_config("qwen3-32b"), device="cpu", steps=4,
                            global_batch=2, seq_len=16, verbose=False)
    assert first + second == pytest.approx(straight, rel=1e-6)
