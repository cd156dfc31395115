"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use by ``nvcc`` into its own shared library under
``<repo>/build/kernels``, then loaded with ``ctypes``.  The library file
name carries a hash of the source, so an edited kernel is rebuilt and a
stale one is never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pairwise", "bsp", "morton", "attractive", "spread", "gather", "traverse")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(compiler: str, name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, dest) or None if built."""
    dest = library_path(name)
    if dest.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, dest


def _finish_build(name: str, proc, tmp: str, dest: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, dest)      # atomic: a concurrent loader sees all or nothing
    return out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` runs in parallel.

    Returns ``{name: nvcc output}`` (the ``-Xptxas -v`` register and
    shared-memory report) for the sources that were compiled.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    started = {n: _start_build(compiler, n) for n in todo}
    logs, errors = {}, []
    for n, job in started.items():
        if job is None:
            continue
        try:
            logs[n] = _finish_build(n, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
