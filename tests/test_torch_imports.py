"""Import hygiene and the device rule of the port: no module of
``repro_torch`` (nor ``chip_smoke.py``) pulls in ``jax`` or the JAX package,
and every entry point refuses to run without a CUDA device unless the caller
passes ``device="cpu"``."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch import train as train_launch
from repro_torch.models import init_cache, init_params
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.train import train_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))

_PROBE = """
import importlib, sys
for name in {mods!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))
print('BAD', bad)
sys.exit(1 if bad else 0)
"""


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_modules_found():
    for expected in ("repro_torch.kernels.flash_attention",
                     "repro_torch.kernels.decode_attention",
                     "repro_torch.kernels.rwkv6_wkv", "repro_torch.models.ssm",
                     "repro_torch.kernels.ops", "repro_torch.kernels._build",
                     "repro_torch.models.convert", "repro_torch.serving.engine",
                     "repro_torch.launch.serve", "repro_torch.sched.policies",
                     "repro_torch.core.resource_manager",
                     "repro_torch.analysis.sanitize",
                     "repro_torch.kernels.flash_attention_bwd",
                     "repro_torch.train.optimizer", "repro_torch.train.train_step",
                     "repro_torch.data.pipeline", "repro_torch.checkpoint.checkpoint",
                     "repro_torch.launch.train", "repro_torch.kernels.ssm_scan",
                     "repro_torch.models.moe",
                     "repro_torch.sched.shard", "repro_torch.core.dispatch",
                     "repro_torch.sim.events", "repro_torch.sim.events_reference",
                     "repro_torch.sim.arrivals", "repro_torch.sim.simulator",
                     "repro_torch.sim.scenarios", "repro_torch.sim.sharded",
                     "repro_torch.control.admission",
                     "repro_torch.control.autoscaler",
                     "repro_torch.control.fairshare",
                     "repro_torch.analysis.core", "repro_torch.analysis.runner",
                     "repro_torch.analysis.baseline",
                     "repro_torch.analysis.detlint",
                     "repro_torch.analysis.checkers.det001_wallclock",
                     "repro_torch.analysis.checkers.det002_unordered",
                     "repro_torch.analysis.checkers.det003_heappush",
                     "repro_torch.analysis.checkers.det004_frozen",
                     "repro_torch.analysis.checkers.det005_rng",
                     "repro_torch.analysis.checkers.det006_tiebreak",
                     "repro_torch.launch.sim",
                     "repro_torch.distributed.ctx", "repro_torch.distributed.sharding",
                     "repro_torch.roofline.analysis", "repro_torch.launch.dryrun",
                     "repro_torch.launch.inputs", "repro_torch.launch.mesh"):
        assert expected in MODULES


def test_importing_every_module_leaves_jax_and_repro_out():
    proc = _run(_PROBE.format(mods=MODULES))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_host_stack_imports_no_framework():
    """The simulator, the control plane, the sharded control plane, the
    dispatch shim, detlint and the simulator's entry point are pure host
    code: importing them pulls in neither torch nor jax nor the JAX
    package."""
    mods = ["repro_torch.sim", "repro_torch.control",
            "repro_torch.analysis.detlint", "repro_torch.sched.shard",
            "repro_torch.core.dispatch", "repro_torch.launch.sim"]
    code = _PROBE.format(mods=mods).replace(
        "('jax', 'jaxlib', 'repro', 'triton')",
        "('jax', 'jaxlib', 'repro', 'triton', 'torch')")
    assert "'torch')" in code
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "BAD []"


EXAMPLES = ("quickstart_torch", "serve_cluster_torch", "train_small_torch",
            "online_sim_torch")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_neither_jax_nor_repro(name):
    """Loading a port example (its ``main`` does not run) pulls in no JAX
    and no module of the JAX package; ``quickstart_torch`` and
    ``online_sim_torch`` are host code and pull in no torch either."""
    banned = "('jax', 'jaxlib', 'repro', 'triton'" + (
        ", 'torch')" if name in ("quickstart_torch", "online_sim_torch") else ")")
    code = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location('ex', 'examples/{name}.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split('.')[0] in {banned})
print('BAD', bad)
sys.exit(1 if bad else 0)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "BAD []"


def test_dryrun_and_meshes_follow_the_device_rule():
    """Without a card the dry run, its measurement and the local mesh raise
    unless told ``device="cpu"``; the production and abstract meshes are
    plain axis maps and need no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import dryrun, mesh
    cfg = get_smoke_config("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_local_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.measure(cfg, "decode", 1, 8, use_kernels=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("phi4-mini-3.8b", "decode_32k")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k"])
    with pytest.raises(ValueError, match="capacity"):
        dryrun.run_cell("phi4-mini-3.8b", "decode_32k", device="cpu")
    assert mesh.make_local_mesh(device="cpu").size == 1
    assert mesh.make_production_mesh().size == 256


def test_sources_do_not_name_jax():
    """Belt and braces for lazy imports inside functions."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "examples", f"{n}.py") for n in EXAMPLES]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(cfg, 1, 4, is_global=True)
    cache = init_cache(cfg, 1, 4, device="cpu")
    assert all(t.device.type == "cpu" for unit in cache.values()
               for kv in unit.values() for t in kv)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.EnginePool(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_prompts(16, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.init_train_state(cfg, ts.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.run_training(cfg, steps=1, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.main(["--smoke", "--steps", "1"])
    assert resolve_device("cpu").type == "cpu"


def test_mla_entry_points_raise_without_cuda():
    """MLA's caches and deepseek's parameters (MTP head included) follow the
    device rule too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models.attention import init_mla_cache
    cfg = get_smoke_config("deepseek-v3-671b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mla_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    cache = init_cache(cfg, 1, 4, device="cpu")
    assert cache["layers"]["sub0"].latent.device.type == "cpu"
    assert init_params(cfg, 0, device="cpu")["mtp"]["proj"].device.type == "cpu"


def test_kernel_build_needs_the_compiler():
    """No fallback: where ``nvcc`` is missing the build raises."""
    from repro_torch.kernels import _build
    import shutil
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    assert [p.name for p in _build.sources()] == ["decode_attention.cu",
                                                  "flash_attention.cu",
                                                  "flash_attention_bwd.cu",
                                                  "flash_attention_bwd_sm90.cu",
                                                  "flash_attention_sm90.cu",
                                                  "rwkv6_wkv.cu", "ssm_scan.cu",
                                                  "ssm_scan_sm90.cu"]
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    assert len(_build._digest()) == 16
