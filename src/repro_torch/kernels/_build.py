"""Builds the hand-written CUDA kernels and loads them with ``ctypes``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together) and the objects are linked
into one shared library with a plain C interface. Nothing is built at
import: the first kernel launch calls :func:`load`. The library's file
name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. A failed build raises with the
compiler's stderr; there is no fallback.

Output directory: ``build/repro_torch_kernels/`` at the root of the
checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME, "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    bdir = out.parent
    bdir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    procs = []
    for src in sources():
        obj = bdir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs, log, failed = [], [], []
    for src, obj, proc in procs:
        so, se = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{so}{se}")
        if proc.returncode != 0:
            failed.append(src.name)
        objs.append(obj)
    (bdir / f"{out.stem}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = bdir / f"{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is None:
        out = build_dir() / f"librepro_torch_kernels_{_digest()}.so"
        if not out.exists():
            _compile(out)
        _LIB = ctypes.CDLL(str(out))
    return _LIB


def build_log() -> str:
    """ptxas' report (registers, shared memory, spills) of the last build."""
    logs = sorted(build_dir().glob("*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""
