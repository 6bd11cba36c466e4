"""Persistent build cache of the native libraries (the port's counterpart of
``mpc_local_planner_tpu.utils.compilation_cache``, which points JAX's
persistent XLA cache at a directory).

The port compiles no programs at run time; what it builds is its native
libraries: the kernels' (``ops/nvcc_build.py``: nvcc, tens of seconds a
library) and the costmap runtime's (``native.py``: g++). They are built at
first use into a directory keyed by their sources and flags, and found there
afterwards: ``_build/`` beside the package unless ``enable_persistent_cache``
points the process elsewhere, so that a build is paid once per machine
instead of once per checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_state = {"dir": DEFAULT_BUILD_DIR}


def build_dir() -> Path:
    """Where the native libraries are built and found in this process."""
    return _state["dir"]


def enable_persistent_cache(path: str | None = None) -> str:
    """Build and find the native libraries under ``path`` (default:
    ``~/.cache/mpc_local_planner_tpu_torch/build``) from now on in this
    process. Safe to call more than once. Returns the directory in use."""
    if path is None:
        path = os.path.join(os.path.expanduser("~"), ".cache", "mpc_local_planner_tpu_torch",
                            "build")
    os.makedirs(path, exist_ok=True)
    _state["dir"] = Path(path)
    return str(path)
