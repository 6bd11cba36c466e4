"""Build a hand-written CUDA source into a plain-C shared library.

Each kernel source under ``csrc/`` is compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``_build/`` (ignored by
git), under a name keyed by the source's hash, and loaded with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_library(source: Path, lib: Path) -> dict:
    """Compile ``source`` into ``lib`` if it is missing. Returns the library
    path, the build seconds (0 when it was already built) and ptxas' report."""
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "ptxas": ""}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [compiler, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
