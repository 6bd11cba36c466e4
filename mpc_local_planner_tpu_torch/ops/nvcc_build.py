"""Build a hand-written CUDA source into a plain-C shared library.

Each kernel source under ``csrc/`` is compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``_build/`` (ignored by
git; ``utils.compilation_cache.enable_persistent_cache`` points it
elsewhere), under a name keyed by the source's hash, and loaded with
``ctypes``. A
source built twice with different macros (``-D``) gives each build a name of
its own (``variant``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from mpc_local_planner_tpu_torch.utils.compilation_cache import DEFAULT_BUILD_DIR, build_dir

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = DEFAULT_BUILD_DIR  # the default of ``build_dir()``
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # the device optimizer works on the source's kernels on every core at once
    "--split-compile=0",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return str(path)


def library_path(source: Path, variant: str = "") -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return build_dir() / f"lib{source.stem}{variant}_{digest}.so"


def build_library(source: Path, lib: Path, defines=()) -> dict:
    """Compile ``source`` into ``lib`` if it is missing, with the macros
    ``defines`` ("NAME=VALUE"). Returns the library path, the build seconds
    (0 when it was already built) and ptxas' report."""
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "ptxas": ""}
    compiler = nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [compiler, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
