"""What the benchmark's command loads: no module whose top-level name is
jax, jaxlib, flax or repro (names compared whole: repro_torch is the program
under test), and a reference that loads nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness
from portbench.tests import smoke

ROOT = Path(__file__).resolve().parents[2]
LIST_MODULES = ("import atexit, runpy, sys\n"
                "atexit.register(lambda: print('MODULES', sorted({{m.split('.')[0] "
                "for m in sys.modules}}), file=sys.stderr))\n"
                "sys.argv = {argv!r}\n"
                "runpy.run_path({path!r}, run_name='__main__')\n")


def _modules(stderr: str):
    line = [ln for ln in stderr.splitlines() if ln.startswith("MODULES ")][-1]
    return set(ast.literal_eval(line[len("MODULES "):]))


def test_command_loads_no_jax_and_no_repro(tmp_path):
    root = smoke.make_root(tmp_path)
    run_py = str(ROOT / "portbench" / "run.py")
    argv = [run_py, "--workload", "smoke-phi4.tiny", "--seed", str(2**31 + 5),
            "--seconds", "0", "--trace", "0", "--device", "cpu", "--root", str(root)]
    p = subprocess.run([sys.executable, "-c", LIST_MODULES.format(argv=argv, path=run_py)],
                       capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = _modules(p.stderr)
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & set(harness.FORBIDDEN)
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True


def test_a_reader_that_loads_jax_prints_no_result(tmp_path):
    """The look at ``sys.modules`` comes after every metric reader has run:
    a reader that a later cell adds and that imports a module named jax
    leaves the run without a result."""
    root = smoke.make_root(tmp_path / "bench")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    reader = root / "portbench" / "end_to_end" / "items_per_s.py"
    reader.write_text(f"import sys\nsys.path.insert(0, {str(stub.parent)!r})\nimport jax\n"
                      + reader.read_text())
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                        "smoke-phi4.tiny", "--seed", str(2**31 + 5), "--seconds", "0",
                        "--trace", "0", "--device", "cpu", "--root", str(root)],
                       capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 3, p.stderr[-3000:]
    assert p.stdout.strip() == ""
    assert "['jax']" in p.stderr.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, torch\n"
            "from portbench.reference import gqa_transformer as ref, ladder\n"
            "from portbench import weights\n"
            "from portbench.tests import smoke\n"
            "cfg = smoke.smoke_config('smoke-mixtral')\n"
            "sizes = {k: cfg[k] for k in ref.SUPPORTED.keys() | {'d_model', 'num_layers', "
            "'num_heads', 'num_kv_heads', 'head_dim', 'vocab_size', 'tie_embeddings', 'moe', "
            "'norm_eps', 'rope_theta', 'attention_kind', 'sliding_window', 'd_ff'}}\n"
            "p = weights.make(ref.layout(sizes), 1, 0, 'cpu', dtype=torch.float32)\n"
            "ref.logits_at(sizes, p, torch.ones(1, 5, dtype=torch.long), 3, [2, 3, 4])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert not mods & ({"repro_torch"} | set(harness.FORBIDDEN))


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in {"repro_torch", *harness.FORBIDDEN}, (path, n)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """Only BENCHMARK.json and portbench/: the program is missing."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "phi4-mini.gen",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
